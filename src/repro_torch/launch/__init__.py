"""Launch layer (port of ``repro/launch``): meshes on
``torch.distributed``, the sharding rules and their DTensor placements,
and the per-cell step factory."""

from repro_torch.launch.mesh import (
    dp_axes, make_abstract_mesh, make_host_mesh, make_production_mesh,
)
from repro_torch.launch.shardings import (
    batch_shardings,
    cache_shardings,
    param_shardings,
    replicated,
    state_shardings,
)
from repro_torch.launch.steps import (
    CellPrograms, build_programs, build_state_specs,
)
