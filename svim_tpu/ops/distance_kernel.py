"""Batched span-position distance matrices on device.

Device counterpart of svim_tpu.cluster.accel / svim_tpu.cluster.distance
(reference contract: SVIM_clustering.py:47-96).  Partitions are padded to a
fixed P (128) and processed as (B, P) struct-of-arrays ->
(B, P, P) distance tensors in plain jnp, which XLA fuses into one kernel.

Role: the production CLUSTER stage builds its matrices inside the fused
agglomeration kernel (ops/linkage_kernel.span_position_agglomerate_batched
— matrix + dedup + linkage in ONE jitted program).  This standalone
version remains the isolated reference
implementation of the distance contract (pinned against the host oracle
and sharded over a virtual mesh in tests/test_parallel.py) and the
starting point for any consumer that needs raw distance tensors.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

BIG = 99999.0


@partial(jax.jit, static_argnames=("wall_same_read",))
def span_position_matrix(starts, ends, read_ids, valid,
                         position_distance_normalizer, wall_same_read=True):
    """(B, P) int32 batch -> (B, P, P) float32 distances.

    DEL/DUP_TAN/INV contract: |Δcenter|/normalizer + |Δspan|/max(span);
    same-read pairs get the wall; invalid (padded) pairs get BIG."""
    centers = (starts + ends) // 2
    spans = ends - starts
    delta_center = jnp.abs(centers[:, :, None] - centers[:, None, :])
    delta_span = jnp.abs(spans[:, :, None] - spans[:, None, :])
    max_span = jnp.maximum(spans[:, :, None], spans[:, None, :])
    distance = (delta_center.astype(jnp.float32) / position_distance_normalizer
                + delta_span.astype(jnp.float32)
                / jnp.maximum(max_span, 1).astype(jnp.float32))
    pair_valid = valid[:, :, None] & valid[:, None, :]
    if wall_same_read:
        same_read = read_ids[:, :, None] == read_ids[:, None, :]
        eye = jnp.eye(starts.shape[1], dtype=bool)[None]
        distance = jnp.where(same_read & ~eye, BIG, distance)
    return jnp.where(pair_valid, distance, BIG)
