"""The paper's comparison systems, simulated on the same SimCloud substrate.

All are (logically) centralized — the design axis Table 1 contrasts with
Jointλ:

  * :mod:`statemachine` — ASF / AliYun CloudFlow class managed state-machine
    services ($25/1M transitions, per-transition latency, single cloud).
  * :mod:`xafcl`        — master-worker middleware on long-running VMs
    (orchestrator + datastore nodes), cross-cloud scheduling.
  * :mod:`xfaas`        — connector-function chaining through cloud
    orchestration services (3 state transitions per hop; sequences only).
  * :mod:`lithops`      — homogeneous worker pool (500 ms runtime init,
    storage-based I/O, driver VM); parallel maps only.
"""

from repro_torch.baselines.statemachine import StateMachineOrchestrator  # noqa: F401
from repro_torch.baselines.xafcl import XAFCLOrchestrator  # noqa: F401
from repro_torch.baselines.xfaas import run_xfaas_sequence  # noqa: F401
from repro_torch.baselines.lithops import run_lithops_map  # noqa: F401
