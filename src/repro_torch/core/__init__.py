# The paper's primary contribution: Jointλ's function-side distributed
# orchestration runtime — sub-graph IR, JointλObject wrapper, exactly-once
# checkpoints, failover, majority-rule placement, coordination points, GC.

from repro_torch.core.subgraph import (  # noqa: F401
    BY_BATCH, BY_REDUNDANT, CHOICE, CYCLE, FANIN, GC_FUNCTION, MAP, PARALLEL,
    SEQUENCE, Catalog, FunctionSpec, NextFunctionInfo, NodeView, WorkflowSpec,
    compile_workflow)
from repro_torch.core.jlobject import JLObject  # noqa: F401
from repro_torch.core.naming import Control, collaboration_key  # noqa: F401
from repro_torch.core.orchestrator import gc_handler, handle, make_handler  # noqa: F401
from repro_torch.core.workflow import DeployedWorkflow, deploy  # noqa: F401
