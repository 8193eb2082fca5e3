"""``device_idle_share.prefill`` in the host-paced cells, where it moves ``prefill_tokens_per_s.host_paced``."""

from perfbench.harness.bench import file_module

read = file_module("metrics", "device_idle_share.prefill").read
