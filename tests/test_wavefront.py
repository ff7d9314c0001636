"""Banded wavefront edit-distance kernel: exactness vs the DP oracle."""

import random

import pytest

from svim_tpu.cluster.edit_distance import edit_distance_dp
from svim_tpu.ops.wavefront_kernel import batched_edit_distance


def _mutate(rng, text, edits):
    out = list(text)
    for _ in range(edits):
        if not out:
            break
        op = rng.choice("sid")
        position = rng.randrange(len(out))
        if op == "s":
            out[position] = rng.choice("ACGT")
        elif op == "i":
            out.insert(position, rng.choice("ACGT"))
        else:
            del out[position]
    return "".join(out)


def test_batched_edit_distance_exact():
    rng = random.Random(13)
    pairs = []
    for _ in range(30):
        a = "".join(rng.choice("ACGT") for _ in range(rng.randint(0, 120)))
        if rng.random() < 0.6:
            b = _mutate(rng, a, rng.randint(0, 8))
        else:
            b = "".join(rng.choice("ACGT") for _ in range(rng.randint(0, 120)))
        pairs.append((a, b))
    pairs += [("", ""), ("", "ACGT"), ("AC", ""), ("A" * 50, "A" * 50)]
    got = batched_edit_distance(pairs, initial_band=2)  # force band doubling
    want = [edit_distance_dp(a, b) for a, b in pairs]
    assert got == want


def test_band_doubling_handles_distant_pairs():
    # distance far above the initial band: must retry, not clamp
    got = batched_edit_distance([("A" * 64, "C" * 64)], initial_band=2)
    assert got == [64]


@pytest.mark.parametrize("length,band", [(512, 64), (512, 256),
                                         (2048, 64), (2048, 1024)])
def test_banded_distance_exact_at_widths(length, band):
    """banded_distance (the only device path) is exact against the DP
    oracle and the native Myers batch at production bucket widths; pairs
    whose distance exceeds the band report > band (retry), never a wrong
    value."""
    import numpy as np

    from svim_tpu.native import aligner, get_library
    from svim_tpu.ops.wavefront_kernel import _encode, banded_distance

    rng = random.Random(length * 7 + band)
    pairs = []
    for _ in range(6):
        base = "".join(rng.choice("ACGT")
                       for _ in range(rng.randint(length // 2, length - 40)))
        pairs.append((base, _mutate(rng, base, rng.randint(0, band // 2))))
    # one pair far outside the band: must come back > band
    far = "".join(rng.choice("AC") for _ in range(length - 40))
    pairs.append((far, "".join(rng.choice("GT") for _ in range(length - 40))))
    a_codes = _encode([a for a, _ in pairs], length)
    b_codes = _encode([b for _, b in pairs], length)
    a_lens = np.asarray([len(a) for a, _ in pairs], dtype=np.int32)
    b_lens = np.asarray([len(b) for _, b in pairs], dtype=np.int32)
    got = np.asarray(banded_distance(a_codes, a_lens, b_codes, b_lens, band))
    if get_library() is not None:
        truth = [aligner.edit_distance(a, b) for a, b in pairs]
    else:
        truth = [edit_distance_dp(a, b) for a, b in pairs]
    if length <= 512:
        assert truth == [edit_distance_dp(a, b) for a, b in pairs]
    for value, want in zip(got.tolist(), truth):
        if want <= band:
            assert value == want
        else:
            assert value > band
    assert got[-1] > band
