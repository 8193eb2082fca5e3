"""Distribution layer: mesh context, sharding rules, the plain versions of
the distributed branches.

The port of :mod:`repro.parallel` on ``torch.distributed``: a
``DeviceMesh`` for the mesh, DTensor placements for layouts, and explicit
all-reduces over the mesh's per-axis process groups where the reference
uses ``shard_map``.  The Jointλ mapping: a multi-pod mesh
``("pod","data","model")`` is the jointcloud; the FSDP/TP/EP rules place
work where its producers live.
"""

from repro_torch.parallel.mesh_ctx import (  # noqa: F401
    MeshCtx, current_ctx, mesh_context)
from repro_torch.parallel.sharding import (  # noqa: F401
    batch_spec, input_shardings, param_shardings, safe_spec)
