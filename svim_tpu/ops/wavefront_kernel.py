"""Batched exact Levenshtein distance via banded anti-diagonal wavefronts.

Device counterpart of the Myers edit distance (edlib's role in INS
clustering, reference: SVIM_clustering.py:45).  The DP runs as anti-diagonal
wavefronts — every cell of a wavefront depends only on the previous two
fronts, so a whole batch of pairs advances in lockstep with (B, 2W+1) vector
ops per step.  A band half-width W bounds the front; the result is exact
whenever the true distance fits the band (standard band-doubling argument),
so the host wrapper retries with doubled bands until every pair resolves.

This is the ring-attention-like structure the survey predicted for this
workload: wavefront tiling instead of attention (SURVEY.md §5).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

INF = np.int32(1 << 20)


@partial(jax.jit, static_argnames=("band",))
def banded_distance(a_codes, a_lens, b_codes, b_lens, band: int):
    """Exact distances for pairs whose edit distance <= band.

    Args:
      a_codes, b_codes: (B, L) uint8 character codes (padding arbitrary)
      a_lens, b_lens: (B,) int32 true lengths
      band: static band half-width W

    Returns (B,) int32; entries > band mean "band too small, retry".
    """
    batch, length = a_codes.shape
    k_width = 2 * band + 1
    e_offsets = jnp.arange(k_width, dtype=jnp.int32) - band  # (K,)
    m = a_lens.astype(jnp.int32)
    n = b_lens.astype(jnp.int32)

    inf_column = jnp.full((batch, 1), INF, dtype=jnp.int32)
    front_prev2 = jnp.full((batch, k_width), INF, dtype=jnp.int32)
    front_prev2 = front_prev2.at[:, band].set(0)  # D(0,0) at wavefront 0
    front_prev = jnp.full((batch, k_width), INF, dtype=jnp.int32)
    if band >= 1:
        # wavefront 1: D(1,0)=1 (e=+1) and D(0,1)=1 (e=-1) where in range
        front_prev = front_prev.at[:, band + 1].set(jnp.where(m >= 1, 1, INF))
        front_prev = front_prev.at[:, band - 1].set(jnp.where(n >= 1, 1, INF))

    answer = jnp.where(m + n == 0, 0, INF).astype(jnp.int32)
    final_k = band + (m - n)  # wavefront index of D(m, n)
    answer = jnp.where((m + n == 1) & (final_k >= 0) & (final_k < k_width),
                       1, answer)

    d_max = int(2 * length)

    def body(d, carry):
        prev2, prev, answer = carry
        d = jnp.int32(d)
        # cell coordinates along the front
        i = (d + e_offsets[None, :]) // 2          # (1, K) broadcast over batch
        j = (d - e_offsets[None, :]) // 2
        in_range = ((i >= 1) & (i <= m[:, None])
                    & (j >= 1) & (j <= n[:, None]))
        i_idx = jnp.broadcast_to(jnp.clip(i - 1, 0, length - 1).astype(jnp.int32),
                                 (batch, k_width))
        j_idx = jnp.broadcast_to(jnp.clip(j - 1, 0, length - 1).astype(jnp.int32),
                                 (batch, k_width))
        ca = jnp.take_along_axis(a_codes, i_idx, axis=1)
        cb = jnp.take_along_axis(b_codes, j_idx, axis=1)
        substitution = jnp.where(ca == cb, 0, 1).astype(jnp.int32)

        from_insert = jnp.concatenate([inf_column, prev[:, :-1]], axis=1) + 1
        from_delete = jnp.concatenate([prev[:, 1:], inf_column], axis=1) + 1
        from_match = prev2 + substitution
        front = jnp.minimum(jnp.minimum(from_insert, from_delete), from_match)

        # boundary injections: D(0, d) = d and D(d, 0) = d while d fits band
        k_top = band - d      # e = -d  (i == 0)
        k_left = band + d     # e = +d  (j == 0)
        k_index = jnp.arange(k_width, dtype=jnp.int32)[None, :]
        front = jnp.where((k_index == k_top) & (d <= n[:, None]), d, front)
        front = jnp.where((k_index == k_left) & (d <= m[:, None]), d, front)
        front = jnp.where(in_range | (k_index == k_top) | (k_index == k_left),
                          front, INF)

        finished = (d == m + n) & (final_k >= 0) & (final_k < k_width)
        final_value = jnp.take_along_axis(
            front, jnp.clip(final_k, 0, k_width - 1)[:, None], axis=1)[:, 0]
        answer = jnp.where(finished, final_value, answer)
        return prev, front, answer

    _prev2, _prev, answer = jax.lax.fori_loop(
        2, d_max + 1, body, (front_prev2, front_prev, answer))
    return answer


def _encode(strings, length):
    batch = len(strings)
    out = np.zeros((batch, length), dtype=np.uint8)
    for row, text in enumerate(strings):
        raw = np.frombuffer(text.encode(), dtype=np.uint8)
        out[row, :len(raw)] = raw  # raw bytes: exact comparison incl. N etc.
    return out


def _pow2_at_least(value: int, floor: int) -> int:
    result = floor
    while result < value:
        result *= 2
    return result


def _pow4_at_least(value: int, floor: int) -> int:
    result = floor
    while result < value:
        result *= 4
    return result


# Chunk shape: every wavefront step is a few small kernels, so fewer, wider
# chunks win.  Measured on an H100 (700 W) over the 12,144 INS pairs of the
# 16,384-read bench workload: (BATCH_CHUNK, MAX_CELLS_PER_STEP) = (1024,
# 2^18) 2.14 s, (4096, 2^20) 0.78 s, (8192, 2^22) 0.40 s, (16384, 2^23)
# 0.45 s.  The cap bounds the loop state (three (B, K) int32 fronts: 48 MiB).
BATCH_CHUNK = 8192
MAX_CELLS_PER_STEP = 1 << 22


def _batch_chunk_for(band: int) -> int:
    k_width = 2 * band + 1
    chunk = BATCH_CHUNK
    while chunk > 64 and chunk * k_width > MAX_CELLS_PER_STEP:
        chunk //= 2
    return chunk


def batched_edit_distance_resident(pairs, band_hints):
    """Exact edit distances that STAY ON DEVICE (device-resident INS route).

    Requires PROVEN per-pair upper bounds (`band_hints`): each pow4 band
    bucket then resolves in exactly one pass — no data-dependent host
    band-doubling loop — so the per-bucket outputs can be scattered into one
    jnp.int64 array (input order) without ever fetching values to the host.
    Downstream device consumers (ins_matrices_from_pairs ->
    agglomerate_batched) read it directly; the host sees the values only in
    the stage's single batched device_get."""
    import jax.numpy as jnp

    count = len(pairs)
    host_fill = np.zeros(count, dtype=np.int32)
    groups = {}
    for idx, (a, b) in enumerate(pairs):
        if len(a) == 0 or len(b) == 0:
            host_fill[idx] = max(len(a), len(b))
            continue
        band = _pow4_at_least(int(band_hints[idx]) + 1, 64)
        groups.setdefault(band, []).append(idx)
    out = jnp.asarray(host_fill)
    for band, indices in sorted(groups.items()):
        subset = [pairs[i] for i in indices]
        length = _pow2_at_least(max(max(len(a), len(b)) for a, b in subset),
                                512)
        band_eff = min(band, length)
        chunk_size = _batch_chunk_for(band_eff)
        for chunk_start in range(0, len(subset), chunk_size):
            chunk = subset[chunk_start:chunk_start + chunk_size]
            pad = min(chunk_size, _pow2_at_least(len(chunk), 8))
            a_codes = np.zeros((pad, length), dtype=np.uint8)
            b_codes = np.zeros((pad, length), dtype=np.uint8)
            a_codes[:len(chunk)] = _encode([a for a, _ in chunk], length)
            b_codes[:len(chunk)] = _encode([b for _, b in chunk], length)
            a_lens = np.zeros(pad, dtype=np.int32)
            b_lens = np.zeros(pad, dtype=np.int32)
            a_lens[:len(chunk)] = [len(a) for a, _ in chunk]
            b_lens[:len(chunk)] = [len(b) for _, b in chunk]
            values = banded_distance(a_codes, a_lens, b_codes, b_lens,
                                     band_eff)
            chunk_idx = np.asarray(indices[chunk_start:chunk_start
                                           + len(chunk)], dtype=np.int32)
            out = out.at[chunk_idx].set(
                values[:len(chunk)].astype(jnp.int32))
    return out


def batched_edit_distance(pairs, initial_band: int = 64, band_hints=None):
    """Exact edit distances for a list of (a, b) string pairs on the device,
    with band doubling until all pairs resolve.  Batch and length dimensions
    are padded to power-of-two buckets so repeated calls reuse compiled
    programs.

    band_hints: optional per-pair PROVEN upper bounds on the distance; pairs
    are grouped by power-of-two band and each group resolves in one pass."""
    if not pairs:
        return []
    results = np.full(len(pairs), -1, dtype=np.int64)
    pending = list(range(len(pairs)))
    # trivial empties
    for idx in pending[:]:
        a, b = pairs[idx]
        if len(a) == 0 or len(b) == 0:
            results[idx] = max(len(a), len(b))
            pending.remove(idx)
    band = initial_band

    def run(subset_indices, band):
        """One or more fixed-shape kernel calls: batch padded to a power of
        two up to the chunk size (chunked when larger), lengths bucketed
        pow2 from 512 — a handful of compiled programs in total."""
        subset = [pairs[idx] for idx in subset_indices]
        length = max(max(len(a), len(b)) for a, b in subset)
        # pow2 buckets: the padded codes are most of the host->device
        # traffic, so tighter buckets beat fewer compile variants
        length = _pow2_at_least(max(length, 1), 512)
        band = min(band, length)  # a wider band than the strings is degenerate
        chunk_size = _batch_chunk_for(band)
        answers = np.empty(len(subset), dtype=np.int64)
        for chunk_start in range(0, len(subset), chunk_size):
            chunk = subset[chunk_start:chunk_start + chunk_size]
            pad = min(chunk_size, _pow2_at_least(len(chunk), 8))
            a_codes = np.zeros((pad, length), dtype=np.uint8)
            b_codes = np.zeros((pad, length), dtype=np.uint8)
            a_codes[:len(chunk)] = _encode([a for a, _ in chunk], length)
            b_codes[:len(chunk)] = _encode([b for _, b in chunk], length)
            a_lens = np.zeros(pad, dtype=np.int32)
            b_lens = np.zeros(pad, dtype=np.int32)
            a_lens[:len(chunk)] = [len(a) for a, _ in chunk]
            b_lens[:len(chunk)] = [len(b) for _, b in chunk]
            out = np.asarray(banded_distance(a_codes, a_lens, b_codes,
                                             b_lens, band))
            answers[chunk_start:chunk_start + len(chunk)] = out[:len(chunk)]
        return answers, length

    if band_hints is not None and pending:
        # hints are PROVEN upper bounds but usually loose (e.g. s1+s2 for a
        # pair of near-identical inserts whose true distance is tiny), so a
        # cheap narrow first pass resolves the bulk before the hint-sized
        # groups run
        answers, _length = run(pending, band)
        first_leftovers = []
        for position, idx in enumerate(pending):
            if answers[position] <= band:
                results[idx] = int(answers[position])
            else:
                first_leftovers.append(idx)
        groups = {}
        for idx in first_leftovers:
            hint_band = _pow4_at_least(int(band_hints[idx]) + 1, initial_band)
            groups.setdefault(hint_band, []).append(idx)
        leftovers = []
        for hint_band, indices in sorted(groups.items()):
            answers, _length = run(indices, hint_band)
            for position, idx in enumerate(indices):
                if answers[position] <= hint_band:
                    results[idx] = int(answers[position])
                else:  # hint was not a true bound; fall through to doubling
                    leftovers.append(idx)
        pending = leftovers
        band = max(groups) * 2 if groups else band

    while pending:
        answers, length = run(pending, band)
        still_pending = []
        for position, idx in enumerate(pending):
            if answers[position] <= band:
                results[idx] = int(answers[position])
            else:
                still_pending.append(idx)
        pending = still_pending
        band *= 2
        if pending and band > 2 * length:
            # distance can never exceed max length; one final full-width pass
            answers, _ = run(pending, band)
            for position, idx in enumerate(pending):
                results[idx] = int(answers[position])
            pending = []
    return results.tolist()
