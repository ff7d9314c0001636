"""On-device average-linkage agglomeration over padded partitions.

Device counterpart of scipy's linkage+fcluster as used by CLUSTER
(reference: SVIM_clustering.py:170-171) and of the host implementation in
svim_tpu.cluster.linkage.  Each partition is a fixed (P, P) distance matrix
(P <= 128 after the reference's subsampling cap), so the whole agglomeration
is P-1 masked argmin+update steps under fori_loop, batched over partitions
with vmap.

Two levels of API:

* `agglomerate_batched(distances, valid)` — runs the FULL dendrogram and
  returns the merge sequence (slot pairs + heights) plus a minimum relative
  tie gap.  The host reconstructs a scipy-format Z from the merges and calls
  scipy's fcluster on it, which reproduces the reference's flat-cluster
  NUMBERING exactly (naive global-argmin agglomeration produces the same Z
  as scipy's nn-chain when heights are distinct; the gap diagnostic flags
  partitions where float32 could order merges differently than scipy's
  float64, and those fall back to the host path).

* `span_position_agglomerate_batched(...)` — fused path for the pure
  span-position types (DEL / INV / DUP_TAN): builds the distance matrix
  on device from coordinates (contract: SVIM_clustering.py:48-63), applies
  the reference's same-read dedup rule (SVIM_clustering.py:145-151), then
  agglomerates.  Partitions where a same-read pair SURVIVES dedup carry a
  99999 wall into linkage; wall-diluted averages are large enough that
  float32 cannot arbitrate their order safely, so those partitions are
  flagged (`has_wall`) for host fallback instead.

* `average_linkage_labels_batched` — legacy flat-label variant (stops
  merging at the threshold); kept for the mesh demo step and tests.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

BIG = jnp.float32(3.0e38)
# merges with height >= CUTOFF are padding (no real pair left)
MERGE_CUTOFF = 1.0e30
# relative gap below which float32 cannot safely arbitrate a comparison that
# scipy performs in float64 (worst-case accumulated f32 error through a
# 127-deep chain of weighted averages is ~3.5e-5 relative; 3e-4 gives ~10x
# margin and sits below the 1/900 position-distance quantum)
TIE_EPS = 3.0e-4


def _agglomerate_one(d, steps=None):
    """(P, P) float32 distance matrix (BIG on the diagonal / invalid slots)
    -> (merge_lo, merge_hi, heights, min_rel_gap).

    Runs `steps` (default P-1) argmin+average-update steps; steps whose
    global minimum is >= MERGE_CUTOFF emit (-1, -1, BIG) padding rows.
    min_rel_gap is the smallest (second_best - best) / max(best, 1) seen
    over real merge steps — 0 for an exact tie; small when float32 rounding
    could reorder merges.  `steps` may be a traced scalar (the batched
    callers pass max(valid count) - 1, which cuts the sequential loop for
    small partitions padded into a wide bucket)."""
    p = d.shape[0]
    index = jnp.arange(p, dtype=jnp.int32)
    eye = jnp.eye(p, dtype=bool)
    sizes = jnp.where(d[0] < 0, 0.0, 1.0)  # placeholder, replaced below

    def body(step, carry):
        d, sizes, merges_lo, merges_hi, heights, min_gap = carry
        flat = jnp.argmin(d)
        i = (flat // p).astype(jnp.int32)
        j = (flat % p).astype(jnp.int32)
        lo = jnp.minimum(i, j)
        hi = jnp.maximum(i, j)
        best = d[lo, hi]
        real = best < MERGE_CUTOFF

        # runner-up over every other pair (the symmetric twin of (lo, hi) is
        # masked out); an exact tie elsewhere gives gap 0
        pair_mask = ((index == lo)[:, None] & (index == hi)[None, :]) | (
            (index == hi)[:, None] & (index == lo)[None, :])
        second = jnp.min(jnp.where(pair_mask, BIG, d))
        gap = (second - best) / jnp.maximum(best, 1.0)
        min_gap = jnp.where(real & (second < MERGE_CUTOFF),
                            jnp.minimum(min_gap, gap), min_gap)

        size_lo = sizes[lo]
        size_hi = sizes[hi]
        merged_row = (size_lo * d[lo, :] + size_hi * d[hi, :]) / (size_lo + size_hi)
        keep_big = (d[lo, :] >= MERGE_CUTOFF) | (d[hi, :] >= MERGE_CUTOFF)
        merged_row = jnp.where(keep_big, BIG, merged_row)

        new_d = d.at[lo, :].set(jnp.where(real, merged_row, d[lo, :]))
        new_d = new_d.at[:, lo].set(jnp.where(real, merged_row, d[:, lo]))
        row_mask = (index == hi)[:, None] | (index == hi)[None, :] | eye
        new_d = jnp.where(real & row_mask, BIG, new_d)

        new_sizes = sizes.at[lo].set(jnp.where(real, size_lo + size_hi, size_lo))
        new_sizes = new_sizes.at[hi].set(jnp.where(real, 0.0, size_hi))
        merges_lo = merges_lo.at[step].set(jnp.where(real, lo, -1))
        merges_hi = merges_hi.at[step].set(jnp.where(real, hi, -1))
        heights = heights.at[step].set(jnp.where(real, best, BIG))
        return new_d, new_sizes, merges_lo, merges_hi, heights, min_gap

    valid = jnp.any(d < MERGE_CUTOFF, axis=1) | jnp.any(d.T < MERGE_CUTOFF, axis=1)
    sizes = valid.astype(jnp.float32)
    init = (d, sizes,
            jnp.full((p - 1,), -1, dtype=jnp.int32),
            jnp.full((p - 1,), -1, dtype=jnp.int32),
            jnp.full((p - 1,), BIG, dtype=jnp.float32),
            BIG)
    if steps is None:
        steps = p - 1
    _, _, merges_lo, merges_hi, heights, min_gap = jax.lax.fori_loop(
        0, steps, body, init)
    return merges_lo, merges_hi, heights, min_gap


@jax.jit
def agglomerate_batched(distances, valid):
    """(B, P, P) float32 distances + (B, P) bool valid -> per-partition merge
    sequences (merge_lo, merge_hi, heights: (B, P-1)) and min relative tie
    gap (B,).  Invalid slots never participate."""
    pair_valid = valid[:, :, None] & valid[:, None, :]
    eye = jnp.eye(distances.shape[1], dtype=bool)[None]
    d = jnp.where(pair_valid & ~eye, distances.astype(jnp.float32), BIG)
    steps = jnp.maximum(jnp.max(jnp.sum(valid, axis=1)) - 1, 0)
    return jax.vmap(_agglomerate_one, in_axes=(0, None))(d, steps)


@jax.jit
def ins_matrices_from_pairs(starts, spans, pair_part, pair_i, pair_j,
                            pair_ed, pos_norm, ed_norm):
    """Device-resident INS distance matrices (contract:
    SVIM_clustering.py:64-77).

    starts/spans: (B, P) int32 partition columns.  pair_*: flat near-pair
    lists (enumerated on host in the exact f64 order distance_matrix uses);
    pair_ed comes straight from the wavefront kernel and never visits the
    host.  Far pairs get position + span distance; near pairs get position +
    ed/max_span/ed_norm.  Diagonal/invalid slots are left arbitrary —
    agglomerate_batched masks them.  Padding pairs may point at (0, 0, 0)
    (the masked diagonal)."""
    delta = jnp.abs(starts[:, :, None] - starts[:, None, :])  # int32: exact
    pos = delta.astype(jnp.float32) / pos_norm
    spans_f = spans.astype(jnp.float32)
    max_span = jnp.maximum(spans_f[:, :, None], spans_f[:, None, :])
    span_d = jnp.abs(spans_f[:, :, None] - spans_f[:, None, :]) \
        / jnp.maximum(max_span, 1.0)
    mat = pos + span_d
    ed_term = (pos[pair_part, pair_i, pair_j]
               + pair_ed.astype(jnp.float32)
               / jnp.maximum(max_span[pair_part, pair_i, pair_j], 1.0)
               / ed_norm)
    mat = mat.at[pair_part, pair_i, pair_j].set(ed_term)
    mat = mat.at[pair_part, pair_j, pair_i].set(ed_term)
    return mat


# --- fused span-position path (DEL / INV / DUP_TAN) ---------------------------

WALL = jnp.float32(99999.0)


BND_NORM = jnp.float32(3000.0)  # hardcoded in the reference (SVIM_clustering.py:91)

# per-partition distance-formula codes for the fused route
KIND_SPAN_POSITION = 0   # DEL / INV / DUP_TAN  (SVIM_clustering.py:48-63)
KIND_DUP_INT = 1         # source center + destination start + span (:78-86)
KIND_BND = 2             # (|pos1 delta| + |pos2 delta|) / 3000 (:87-94);
#                          direction-mismatch pairs are arbitrated on host
#                          BEFORE dispatch (they wall the linkage)


def _span_position_fused_one(starts, ends, dest, reads, valid, norm, threshold,
                             wall_flag, kind, steps=None):
    """One partition: device distance matrix + dedup + agglomeration.

    `wall_flag` is a traced per-partition boolean (True = apply the same-read
    dedup rule + wall; False = INV semantics) and `kind` a traced int32
    distance-formula code, so partitions of DIFFERENT types batch into one
    kernel invocation.  `dest` carries the second coordinate column (DUP_INT
    destination start / BND pos2); ignored for kind 0.

    Returns (merges_lo, merges_hi, heights, min_gap, dropped, has_wall,
    dedup_ambiguous)."""
    p = starts.shape[0]
    centers = (starts + ends) // 2
    spans = ends - starts
    delta_center = jnp.abs(centers[:, None] - centers[None, :])
    delta_span = jnp.abs(spans[:, None] - spans[None, :])
    max_span = jnp.maximum(jnp.maximum(spans[:, None], spans[None, :]), 1)
    span_position = (delta_center.astype(jnp.float32) / norm
                     + delta_span.astype(jnp.float32) / max_span.astype(jnp.float32))
    delta_dest = jnp.abs(dest[:, None] - dest[None, :]).astype(jnp.float32)
    dup_int = span_position + delta_dest / norm
    delta_start = jnp.abs(starts[:, None] - starts[None, :]).astype(jnp.float32)
    bnd = (delta_start + delta_dest) / BND_NORM
    distance = jnp.where(kind == KIND_BND, bnd,
                         jnp.where(kind == KIND_DUP_INT, dup_int,
                                   span_position))

    eye = jnp.eye(p, dtype=bool)
    pair_valid = valid[:, None] & valid[None, :] & ~eye
    same_read = (reads[:, None] == reads[None, :]) & pair_valid

    # reference dedup rule (SVIM_clustering.py:145-151): drop j when some
    # i < j from the same read is within the cut threshold
    row_lt = jax.lax.broadcasted_iota(jnp.int32, (p, p), 0) < \
        jax.lax.broadcasted_iota(jnp.int32, (p, p), 1)
    close = distance <= threshold
    dropped = wall_flag & jnp.any(same_read & close & row_lt, axis=0)
    # float32 cannot arbitrate a dedup comparison this close to the cut
    near_cut = jnp.abs(distance - threshold) < TIE_EPS * jnp.maximum(distance, 1.0)
    dedup_ambiguous = wall_flag & jnp.any(same_read & near_cut)
    alive = valid & ~dropped
    pair_alive = alive[:, None] & alive[None, :] & ~eye
    surviving_same_read = same_read & pair_alive & wall_flag
    has_wall = jnp.any(surviving_same_read)
    d = jnp.where(surviving_same_read, WALL, distance)
    d = jnp.where(pair_alive, d, BIG)

    merges_lo, merges_hi, heights, min_gap = _agglomerate_one(d, steps)
    return merges_lo, merges_hi, heights, min_gap, dropped, has_wall, dedup_ambiguous


def span_position_agglomerate_batched(starts, ends, reads, valid, norm,
                                      threshold, wall_same_read=True,
                                      dest=None, kind=KIND_SPAN_POSITION):
    """(B, P) int32 coordinate batch -> per-partition merge sequences plus
    dedup/diagnostic outputs (see _span_position_fused_one).

    `wall_same_read` may be a scalar bool (applied to every partition) or a
    (B,) bool array, and `kind` a scalar or (B,) int32 formula code —
    per-partition semantics so ONE compiled variant serves mixed-type
    batches.  `dest` defaults to zeros (unused for kind 0)."""
    if dest is None:
        import numpy as np
        dest = np.zeros(starts.shape, dtype=np.int32)
    return _span_position_agglomerate_jit(starts, ends, dest, reads, valid,
                                          norm, threshold, wall_same_read,
                                          kind)


@jax.jit
def _span_position_agglomerate_jit(starts, ends, dest, reads, valid, norm,
                                   threshold, wall_same_read, kind):
    batch = starts.shape[0]
    wall = jnp.broadcast_to(jnp.asarray(wall_same_read, dtype=bool), (batch,))
    kinds = jnp.broadcast_to(jnp.asarray(kind, dtype=jnp.int32), (batch,))
    steps = jnp.maximum(jnp.max(jnp.sum(valid, axis=1)) - 1, 0)
    return jax.vmap(_span_position_fused_one,
                    in_axes=(0, 0, 0, 0, 0, None, None, 0, 0, None))(
        starts, ends, dest, reads, valid, norm, threshold, wall, kinds, steps)


# --- legacy flat-label variant (mesh demo / tests) ----------------------------


def _cluster_one(distance, valid, threshold):
    """(P, P) float32 distances, (P,) bool valid -> (P,) int32 labels
    (representative index per element; padded entries label themselves)."""
    p = distance.shape[0]
    index = jnp.arange(p, dtype=jnp.int32)
    eye = jnp.eye(p, dtype=bool)
    pair_valid = valid[:, None] & valid[None, :] & ~eye
    d = jnp.where(pair_valid, distance.astype(jnp.float32), BIG)
    sizes = jnp.where(valid, 1, 0).astype(jnp.float32)
    parent = index  # cluster representative per element

    def body(_step, carry):
        d, sizes, parent, active = carry
        flat = jnp.argmin(d)
        i = (flat // p).astype(jnp.int32)
        j = (flat % p).astype(jnp.int32)
        lo = jnp.minimum(i, j)
        hi = jnp.maximum(i, j)
        best = d[lo, hi]
        do_merge = best <= threshold

        size_lo = sizes[lo]
        size_hi = sizes[hi]
        merged_row = (size_lo * d[lo, :] + size_hi * d[hi, :]) / (size_lo + size_hi)
        keep_big = (d[lo, :] >= BIG) | (d[hi, :] >= BIG)
        merged_row = jnp.where(keep_big, BIG, merged_row)

        new_d = d.at[lo, :].set(jnp.where(do_merge, merged_row, d[lo, :]))
        new_d = new_d.at[:, lo].set(jnp.where(do_merge, merged_row, d[:, lo]))
        # deactivate hi and the lo diagonal
        row_mask = (index == hi)[:, None] | (index == hi)[None, :] | eye
        new_d = jnp.where(do_merge & row_mask, BIG, new_d)

        new_sizes = sizes.at[lo].set(jnp.where(do_merge, size_lo + size_hi, size_lo))
        new_sizes = new_sizes.at[hi].set(jnp.where(do_merge, 0.0, size_hi))
        new_parent = jnp.where(do_merge & (parent == hi), lo, parent)
        new_active = active - jnp.where(do_merge, 1, 0)
        return new_d, new_sizes, new_parent, new_active

    n_active = jnp.sum(valid.astype(jnp.int32))
    d, sizes, parent, _ = jax.lax.fori_loop(
        0, p - 1, body, (d, sizes, parent, n_active))
    return parent


@partial(jax.jit, static_argnames=())
def average_linkage_labels_batched(distances, valid, threshold):
    """(B, P, P) distances + (B, P) valid -> (B, P) int32 representative
    labels after cutting average-linkage dendrograms at `threshold`."""
    return jax.vmap(_cluster_one, in_axes=(0, 0, None))(distances, valid,
                                                        threshold)
