"""Billing engine: counts cost at the same granularity the paper bills.

Categories mirror Table 3's columns so the cost benchmarks can print the same
decomposition: function execution & invocation, external orchestration
(state transitions / VM-hours), datastore W&R, and cross-cloud egress.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict

from repro_torch.backends import calibration as cal


@dataclass
class Bill:
    """Accumulated cost, decomposed by category and by cloud."""

    exec_cost: float = 0.0          # GB·s execution
    invoke_cost: float = 0.0        # per-request charges
    ds_write_cost: float = 0.0      # table writes
    ds_read_cost: float = 0.0       # table reads
    egress_cost: float = 0.0        # cross-cloud bytes
    transition_cost: float = 0.0    # centralized state-machine transitions
    vm_cost: float = 0.0            # long-running orchestrator / datastore VMs
    by_cloud: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    counters: Dict[str, int] = field(default_factory=lambda: defaultdict(int))

    # ---- charge points --------------------------------------------------

    def charge_execution(self, cloud: str, memory_gb: float, duration_ms: float,
                         price_per_gb_s: float) -> float:
        c = memory_gb * (duration_ms / 1000.0) * price_per_gb_s
        self.exec_cost += c
        self.by_cloud[cloud] += c
        self.counters["gb_ms"] += int(memory_gb * duration_ms)
        return c

    def charge_invoke(self, cloud: str, price: float = cal.INVOKE_PRICE) -> float:
        self.invoke_cost += price
        self.by_cloud[cloud] += price
        self.counters["invocations"] += 1
        return price

    def charge_ds_write(self, cloud: str, n: int = 1) -> float:
        c = n * cal.TABLE_WRITE_PRICE
        self.ds_write_cost += c
        self.by_cloud[cloud] += c
        self.counters["ds_writes"] += n
        return c

    def charge_ds_read(self, cloud: str, n: int = 1) -> float:
        c = n * cal.TABLE_READ_PRICE
        self.ds_read_cost += c
        self.by_cloud[cloud] += c
        self.counters["ds_reads"] += n
        return c

    def charge_egress(self, src_cloud: str, nbytes: int,
                      price_per_gb: float = cal.EGRESS_PRICE_PER_GB) -> float:
        c = (nbytes / 1e9) * price_per_gb
        self.egress_cost += c
        self.by_cloud[src_cloud] += c
        self.counters["egress_bytes"] += nbytes
        return c

    def charge_transition(self, cloud: str, n: int = 1) -> float:
        c = n * cal.STATE_TRANSITION_PRICE
        self.transition_cost += c
        self.by_cloud[cloud] += c
        self.counters["state_transitions"] += n
        return c

    def charge_vm(self, vm_type: str, hours: float) -> float:
        c = cal.VM_PRICE[vm_type] * hours
        self.vm_cost += c
        self.counters[f"vm_hours:{vm_type}"] += 1
        return c

    # ---- views ------------------------------------------------------------

    @property
    def orchestration_cost(self) -> float:
        """Everything that is not user-function execution (paper §5.2 split)."""
        return (self.invoke_cost + self.ds_write_cost + self.ds_read_cost
                + self.transition_cost + self.vm_cost)

    @property
    def ds_cost(self) -> float:
        return self.ds_write_cost + self.ds_read_cost

    @property
    def total(self) -> float:
        return (self.exec_cost + self.invoke_cost + self.ds_write_cost
                + self.ds_read_cost + self.egress_cost + self.transition_cost
                + self.vm_cost)

    def breakdown(self) -> Dict[str, float]:
        return {
            "exec": self.exec_cost,
            "invoke": self.invoke_cost,
            "ds_write": self.ds_write_cost,
            "ds_read": self.ds_read_cost,
            "egress": self.egress_cost,
            "transitions": self.transition_cost,
            "vm": self.vm_cost,
            "total": self.total,
        }

    def scaled(self, factor: float) -> Dict[str, float]:
        """Breakdown scaled to e.g. per-1M-workflow pricing (Table 3)."""
        return {k: v * factor for k, v in self.breakdown().items()}
