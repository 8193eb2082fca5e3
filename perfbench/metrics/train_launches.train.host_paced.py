"""``train_launches.train`` in the host-paced cells, where it moves ``train_tokens_per_s.host_paced``."""

from perfbench.harness.bench import file_module

read = file_module("metrics", "train_launches.train").read
