"""Exact Levenshtein distance via Myers' bit-parallel algorithm.

Replaces edlib.align (reference usage: SVIM_clustering.py:10,45).  The host
implementation runs the bit-vector recurrence on arbitrary-precision Python
integers (one "word" spanning the whole pattern), which keeps the inner loop
in C.  The batched device kernel (svim_tpu/ops/wavefront_kernel.py) computes
the same distances as banded anti-diagonal wavefronts.
"""

from __future__ import annotations


_native_checked = False
_native_fn = None


def _native_edit_distance():
    global _native_checked, _native_fn
    if not _native_checked:
        _native_checked = True
        try:
            from svim_tpu.native import aligner, get_library
            if get_library() is not None:
                _native_fn = aligner.edit_distance
        except Exception:
            _native_fn = None
    return _native_fn


def edit_distance(pattern: str, text: str) -> int:
    """Global (Needleman-Wunsch) edit distance between two strings."""
    native = _native_edit_distance()
    if native is not None:
        return native(pattern, text)
    return edit_distance_py(pattern, text)


def batch_edit_distances(pairs, backend: str = "auto", band_hints=None):
    """Exact edit distances for many (a, b) pairs.

    backend: "auto" (native thread-pooled batch: trim + greedy O(n + d^2)
    frontier + Myers bit-parallel fallback), "wavefront" (the batched
    device kernel, exact by band doubling), or "python".
    band_hints: optional proven per-pair distance upper bounds (caps the
    greedy frontier / the device kernel's banded pass)."""
    if backend == "wavefront":
        from svim_tpu.ops.wavefront_kernel import batched_edit_distance
        return batched_edit_distance(pairs, initial_band=128,
                                     band_hints=band_hints)
    if backend == "python":
        return [edit_distance_py(a, b) for a, b in pairs]
    # "auto" routes to the native batch whenever the library is available:
    # the greedy O(n + d^2) frontier (trim + hint-capped, thread pool) costs
    # O(n + d^2) per pair against the wavefront's O(n * band), and most INS
    # pairs are near-identical (small d).  The wavefront kernel remains
    # exact and selectable (backend="wavefront").
    if len(pairs) >= 8:
        try:
            from svim_tpu.native import aligner, get_library
            if get_library() is not None:
                return aligner.edit_distance_batch(pairs, band_hints=band_hints)
        except Exception:
            pass
    return [edit_distance(a, b) for a, b in pairs]


def edit_distance_py(pattern: str, text: str) -> int:
    """Big-integer Myers recurrence (portable fallback)."""
    m = len(pattern)
    if m == 0:
        return len(text)
    if len(text) == 0:
        return m
    # iterate over the shorter string as the pattern: fewer mask bits
    if m > len(text):
        pattern, text = text, pattern
        m = len(pattern)

    peq = {}
    for i, ch in enumerate(pattern):
        peq[ch] = peq.get(ch, 0) | (1 << i)

    mask = (1 << m) - 1
    high = 1 << (m - 1)
    pv = mask
    mv = 0
    score = m
    for ch in text:
        eq = peq.get(ch, 0)
        xv = eq | mv
        xh = (((eq & pv) + pv) ^ pv) | eq
        ph = mv | (~(xh | pv) & mask)
        mh = pv & xh
        if ph & high:
            score += 1
        elif mh & high:
            score -= 1
        ph = ((ph << 1) | 1) & mask
        mh = (mh << 1) & mask
        pv = mh | (~(xv | ph) & mask)
        mv = ph & xv
    return score


def edit_distance_dp(a: str, b: str) -> int:
    """Reference O(nm) dynamic program, used to validate the bit-parallel
    implementations in tests."""
    if len(a) < len(b):
        a, b = b, a
    previous = list(range(len(b) + 1))
    for i, ca in enumerate(a, start=1):
        current = [i] + [0] * len(b)
        for j, cb in enumerate(b, start=1):
            current[j] = min(previous[j] + 1,
                             current[j - 1] + 1,
                             previous[j - 1] + (ca != cb))
        previous = current
    return previous[len(b)]
