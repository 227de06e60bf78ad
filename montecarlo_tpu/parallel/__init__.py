"""Mesh scale-out: shard the tables/rollouts axis over the devices.

The reference's only concurrency is JVM goroutines in one process (no
NCCL/MPI/anything — ``server.clj:132-135`` TCP is the sole transport). Here
``jax.sharding.Mesh`` + ``shard_map`` place rollout batches per device,
and per-shard statistics reduce with ``psum`` (NCCL between GPUs).
All helpers are mesh-shape agnostic (1D "tables" axis over however many
devices exist).
"""

from montecarlo_tpu.parallel.mesh import (  # noqa: F401
    equity_sweep,
    make_mesh,
    sharded_equity_vs_hand,
    sharded_selfplay,
)
