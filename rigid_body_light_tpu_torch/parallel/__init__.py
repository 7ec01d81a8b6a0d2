"""Distribution of the mobility product and the BD step on
``torch.distributed`` — the port of ``rigid_body_light_tpu/parallel``
(its ``sharding`` and ``ensemble`` modules)."""

from rigid_body_light_tpu_torch.parallel.ensemble import (
    make_ensemble_run_bd,
    make_hybrid_mesh,
)
from rigid_body_light_tpu_torch.parallel.sharding import (
    ewald_mobility_apply_local_fn,
    farfield_mobility_apply_local_fn,
    make_distributed_run_bd,
    make_distributed_run_bd_multi,
    make_distributed_step,
    make_distributed_step_multi,
    make_mesh,
    make_mesh_2d,
    mesh_group,
    ring_mobility_apply_fn,
    ring_pair_sum_local,
    sharded_mobility_apply_fn,
    sharded_pair_sum,
    sharded_pair_sum_2d,
)

__all__ = [
    "ewald_mobility_apply_local_fn",
    "farfield_mobility_apply_local_fn",
    "make_distributed_run_bd",
    "make_distributed_run_bd_multi",
    "make_distributed_step",
    "make_distributed_step_multi",
    "make_ensemble_run_bd",
    "make_hybrid_mesh",
    "make_mesh",
    "make_mesh_2d",
    "mesh_group",
    "ring_mobility_apply_fn",
    "ring_pair_sum_local",
    "sharded_mobility_apply_fn",
    "sharded_pair_sum",
    "sharded_pair_sum_2d",
]
