"""Roofline terms of a step on one NVIDIA H100, and MODEL_FLOPS.

The counterpart of :mod:`repro.launch.hlo_analysis`, under its name so a
reader finds it.  There is no HLO on this side: the FLOPs and bytes come
from :mod:`repro_torch.launch.op_cost`, which tallies the step's ops as
they run on fake tensors, and, for one rank of a traced mesh, its
collectives by kind, whose wire bytes follow the ring model,
:func:`wire_bytes`:

    all-gather          in_bytes · (n-1)          (out = in·n; out·(n-1)/n)
    reduce-scatter      in_bytes · (n-1)/n
    all-reduce          2 · in_bytes · (n-1)/n    (RS + AG)
    all-to-all          in_bytes · (n-1)/n
    collective-permute  in_bytes

(n = group size, in_bytes the operand's bytes on one device.)

Hardware model: H100 SXM5 80GB HBM3, published peaks (NVIDIA's data sheet,
dense).  The kernel table's bounds use the same constants.
"""

from __future__ import annotations

from dataclasses import dataclass

#: H100 SXM5 80GB HBM3, published peak: dense bf16 tensor-core FLOP/s
PEAK_FLOPS = 989e12
#: H100 SXM5 80GB HBM3, published peak: fp32 FLOP/s on the CUDA cores
PEAK_FLOPS_FP32 = 67e12
#: H100 SXM5 80GB HBM3, published peak: HBM3 bytes/s
HBM_BW = 3.35e12
#: H100 SXM5 80GB HBM3, published peak: NVLink 4 bytes/s in one direction
NVLINK_BW = 450e9
#: H100 SXM5 80GB HBM3, published capacity: 80 GB of device memory
HBM_BYTES = 80e9
#: H100 SXM5 80GB HBM3 under PyTorch: the cuBLAS workspace that each host
#: thread running products on the card allocates at its first and keeps
#: (32 MiB on sm_90; ``chip_smoke.py``'s dryrun phase checks it on the card)
CUBLAS_WORKSPACE_BYTES = 32 * 2**20


def wire_bytes(kind: str, operand_bytes: float, n: int) -> float:
    """Bytes one device sends for a collective of ``kind`` over a group of
    ``n`` devices on an ``operand_bytes`` operand (the ring algorithm)."""
    n = max(2, n)
    ring = (n - 1) / n
    if kind == "all-gather":
        return operand_bytes * (n - 1)
    if kind in ("reduce-scatter", "all-to-all"):
        return operand_bytes * ring
    if kind == "all-reduce":
        return 2 * operand_bytes * ring
    if kind == "collective-permute":
        return float(operand_bytes)
    raise ValueError(f"unknown collective {kind!r}")


@dataclass
class Roofline:
    """The three roofline terms (seconds) and their provenance."""

    flops: float                 # per-device FLOPs
    hbm_bytes: float             # per-device bytes moved to and from HBM
    wire_bytes: float            # per-device collective wire bytes
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops_per_device: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs: how much of the step's compute is useful."""
        return (self.model_flops_per_device / self.flops) if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline the step reaches if every term
        overlaps perfectly: useful compute time / bound."""
        if self.bound_s == 0:
            return 0.0
        return (self.model_flops_per_device / PEAK_FLOPS) / self.bound_s

    def as_dict(self) -> dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "wire_bytes": self.wire_bytes,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "model_flops_per_device": self.model_flops_per_device,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def roofline_terms(cost: dict, *, wire_bytes: float = 0.0,
                   model_flops_per_device: float = 0.0) -> Roofline:
    """``cost``: ``{"flops", "bytes accessed"}`` per device."""
    flops = float(cost.get("flops", 0.0))
    hbm = float(cost.get("bytes accessed", 0.0))
    return Roofline(
        flops=flops, hbm_bytes=hbm, wire_bytes=wire_bytes,
        compute_s=flops / PEAK_FLOPS,
        memory_s=hbm / HBM_BW,
        collective_s=wire_bytes / NVLINK_BW,
        model_flops_per_device=model_flops_per_device,
    )


def model_flops(cfg, shape_kind: str, seq_len: int, global_batch: int) -> float:
    """MODEL_FLOPS: 6·N·D train (N = active params), 2·N per decoded token."""
    n_active = cfg.param_count(active_only=True)
    if shape_kind == "train":
        return 6.0 * n_active * seq_len * global_batch
    if shape_kind == "prefill":
        return 2.0 * n_active * seq_len * global_batch
    return 2.0 * n_active * global_batch            # decode: one token/seq
