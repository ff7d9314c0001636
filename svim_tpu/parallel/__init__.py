"""Multi-chip scale-out over a jax.sharding.Mesh.

New capability relative to the reference (which is single-threaded,
README.rst:73): read batches are data-parallel over the mesh, per-shard
signature tables are merged with all_gather over the interconnect, depth counts with psum.
"""

from svim_tpu.parallel.mesh import (
    build_pipeline_step,
    make_mesh,
    run_collect_step,
    shard_batch,
)

__all__ = ["build_pipeline_step", "make_mesh", "run_collect_step",
           "shard_batch"]
