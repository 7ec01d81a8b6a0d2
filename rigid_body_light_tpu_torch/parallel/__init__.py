"""Distribution of the mobility product and the BD step on
``torch.distributed`` — the port of ``rigid_body_light_tpu/parallel``
(its ``sharding`` module; ``ensemble`` is ROADMAP.md queue 1, item 16)."""

from rigid_body_light_tpu_torch.parallel.sharding import (
    farfield_mobility_apply_local_fn,
    make_distributed_run_bd,
    make_distributed_step,
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
    "farfield_mobility_apply_local_fn",
    "make_distributed_run_bd",
    "make_distributed_step",
    "make_mesh",
    "make_mesh_2d",
    "mesh_group",
    "ring_mobility_apply_fn",
    "ring_pair_sum_local",
    "sharded_mobility_apply_fn",
    "sharded_pair_sum",
    "sharded_pair_sum_2d",
]
