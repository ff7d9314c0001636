"""Vectorized CIGAR indel scan + per-alignment geometry.

Array-path replacement for the per-op Python walk (reference:
SVIM_intra.py:8-30, HOT LOOP #2) and the pysam geometry accessors
(SVIM_inter.py:30-39).  A batch of padded CIGARs travels to the device in raw
BAM word encoding (length << 4 | op) and is decoded on device — no host-side
splitting, minimal transfer.  Exclusive cumulative sums give the
reference/read offset at every op; masked compares select the I/D runs
>= min_sv_size; the sparse events are compacted ON DEVICE so only a few KB
return to the host.

Synthetic op codes (produced by host-side CIGAR compaction,
io/packing.compact_cigar_row / native cigar compaction): runs of
sub-threshold ops between SV events collapse into
  code 9  — reference advance (scan pos_ref AND geometry ref_end), and
  code 10 — read advance (scan pos_read AND geometry query length);
N runs merge into a single N (geometry-only reference advance, matching
pysam reference_end vs the scan's D-only advance — SVIM_intra.py:14-29
ignores N).  Neither synthetic code can become an event.  Compaction
shrinks (N, 8192) batches to (N, ~32), and the host->device transfer with
them.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def _decode(cigar_words: jax.Array):
    """BAM word encoding -> (ops, lens).  Words are int32 (or uint16 when
    every length fits 12 bits — half the transfer; upcast on device) with op
    in the low 4 bits; lengths < 2^27 keep the value nonnegative."""
    cigar_words = cigar_words.astype(jnp.int32)
    ops = cigar_words & 0xF
    lens = cigar_words >> 4
    return ops, lens


def _scan(ops, lens, min_sv_size):
    is_match = (ops == 0) | (ops == 7) | (ops == 8)
    ref_advance = jnp.where(is_match | (ops == 2) | (ops == 9), lens, 0)
    read_advance = jnp.where(is_match | (ops == 1) | (ops == 4) | (ops == 10),
                             lens, 0)
    pos_ref = jnp.cumsum(ref_advance, axis=1) - ref_advance
    pos_read = jnp.cumsum(read_advance, axis=1) - read_advance
    large = lens >= min_sv_size
    del_mask = (ops == 2) & large
    ins_mask = (ops == 1) & large
    return del_mask, ins_mask, pos_ref, pos_read


@jax.jit
def cigar_indel_scan(cigar_words: jax.Array, min_sv_size: jax.Array):
    """Scan padded CIGAR batches for indel events.

    Args:
      cigar_words: (N, K) int32 raw BAM cigar words, padded with 0.
      min_sv_size: scalar int32 threshold.

    Returns:
      del_mask, ins_mask: (N, K) bool — D/I runs >= min_sv_size
      pos_ref, pos_read: (N, K) int32 — offsets from the alignment start at
        each op (exclusive of the op itself), matching the host scan
        (M/=/X advance both, I the read, D the reference, S the read;
        N/H/P advance neither — SVIM_intra.py:14-29).
    """
    ops, lens = _decode(cigar_words)
    return _scan(ops, lens, min_sv_size)


def _geometry(ops, lens, ref_start):
    """Per-alignment geometry, pysam semantics: reference_end (M/D/N/=/X),
    inferred read length incl. hard clips, query-alignment bounds (soft clips
    only), and hard-clip presence."""
    is_match = (ops == 0) | (ops == 7) | (ops == 8)
    ref_consuming = is_match | (ops == 2) | (ops == 3) | (ops == 9)
    query_consuming = is_match | (ops == 1) | (ops == 4) | (ops == 10)
    soft = (ops == 4) & (lens > 0)
    hard = (ops == 5) & (lens > 0)

    ref_end = ref_start + jnp.sum(jnp.where(ref_consuming, lens, 0), axis=1)
    query_len = jnp.sum(jnp.where(query_consuming, lens, 0), axis=1)
    read_len = query_len + jnp.sum(jnp.where(hard, lens, 0), axis=1)

    clip_like = soft | (ops == 5) | (lens == 0)
    nonclip = ~clip_like
    leading = jnp.cumsum(nonclip, axis=1) == 0
    trailing = jnp.flip(jnp.cumsum(jnp.flip(nonclip, axis=1), axis=1), axis=1) == 0
    trailing_only = trailing & ~leading
    qa_start = jnp.sum(jnp.where(leading & soft, lens, 0), axis=1)
    qa_end = query_len - jnp.sum(jnp.where(trailing_only & soft, lens, 0), axis=1)
    has_hard_clip = jnp.any(hard, axis=1)
    return ref_end, read_len, qa_start, qa_end, has_hard_clip


@jax.jit
def alignment_geometry(cigar_words: jax.Array, ref_start: jax.Array):
    ops, lens = _decode(cigar_words)
    return _geometry(ops, lens, ref_start)


def _compact_events(ops, lens, min_sv_size, max_events):
    """Scan + on-device compaction: only the sparse events travel back to the
    host (the full masks would be N*K booleans to transfer).

    Returns (rows, pos_ref, pos_read, lengths, is_insertion, count); entries
    past `count` are fill.  If count > max_events the caller must retry with a
    larger bound."""
    del_mask, ins_mask, pos_ref, pos_read = _scan(ops, lens, min_sv_size)
    k = ops.shape[1]
    event = (del_mask | ins_mask).ravel()
    count = jnp.sum(event, dtype=jnp.int32)
    (flat_idx,) = jnp.nonzero(event, size=max_events, fill_value=-1)
    rows = flat_idx // k
    cols = flat_idx % k
    safe_rows = jnp.maximum(rows, 0)
    safe_cols = jnp.maximum(cols, 0)
    return (rows,
            pos_ref[safe_rows, safe_cols],
            pos_read[safe_rows, safe_cols],
            lens[safe_rows, safe_cols],
            ins_mask[safe_rows, safe_cols],
            count)


@partial(jax.jit, static_argnames=("max_events",))
def cigar_indel_scan_compact(cigar_words: jax.Array, min_sv_size: jax.Array,
                             max_events: int):
    ops, lens = _decode(cigar_words)
    return _compact_events(ops, lens, min_sv_size, max_events)


@partial(jax.jit, static_argnames=("max_events",))
def collect_scan(cigar_words: jax.Array, ref_start: jax.Array,
                 min_sv_size: jax.Array, max_events: int):
    """Fused COLLECT device pass: geometry columns + compacted indel events in
    ONE device call — a single host->device transfer of the raw CIGAR batch
    and a single small device->host result per batch."""
    ops, lens = _decode(cigar_words)
    geometry = _geometry(ops, lens, ref_start)
    events = _compact_events(ops, lens, min_sv_size, max_events)
    return geometry + events


@partial(jax.jit, static_argnames=("max_events",))
def collect_scan_u8(words8: jax.Array, overflow_rows: jax.Array,
                    overflow_cols: jax.Array, overflow_deltas: jax.Array,
                    ref_start: jax.Array, min_sv_size: jax.Array,
                    max_events: int):
    """collect_scan over the uint8 CIGAR transfer encoding
    (io/packing.encode_cigars_u8): lengths saturate at 15 in the byte and
    sparse deltas restore the long ops on device — a quarter of the int32
    transfer."""
    words = words8.astype(jnp.int32)
    ops = words & 0xF
    lens = (words >> 4).at[overflow_rows, overflow_cols].add(overflow_deltas)
    geometry = _geometry(ops, lens, ref_start)
    events = _compact_events(ops, lens, min_sv_size, max_events)
    return geometry + events


def _round_up_pow2(value: int) -> int:
    result = 1024
    while result < value:
        result *= 2
    return result


def cigar_indel_events(cigar_words: np.ndarray, min_sv_size: int,
                       expected_events_per_row: int = 4):
    """Run the device scan with on-device compaction, growing the event bound
    on overflow.

    Returns (rows, pos_ref, pos_read, lengths, is_insertion) as numpy arrays,
    ordered by (row, op index) like the sequential host scan."""
    n = cigar_words.shape[0]
    max_events = _round_up_pow2(max(1024, n * expected_events_per_row))
    words = jnp.asarray(cigar_words)
    threshold = jnp.int32(min_sv_size)
    while True:
        rows, pos_ref, pos_read, lengths, is_ins, count = jax.device_get(
            cigar_indel_scan_compact(words, threshold, max_events))
        if count <= max_events:
            break
        max_events = _round_up_pow2(int(count))
    count = int(count)
    return (rows[:count], pos_ref[:count], pos_read[:count], lengths[:count],
            is_ins[:count])
