"""Default-path kernels compiled for the card, against their host oracles.

Marked `gpu`: they skip without a GPU.  On the card:
`python -m pytest -m gpu tests/test_gpu_kernels.py` (chip_smoke.py runs them)."""

import random

import jax
import pytest

import chip_smoke
from test_chip_smoke import workload  # noqa: F401  (shared fixture)

pytestmark = pytest.mark.gpu


def test_cigar_scan_on_gpu(gpu_device, workload):  # noqa: F811
    *_rest, records, options = workload
    with jax.default_device(gpu_device):
        results, _width = chip_smoke.check_cigar_scan(records,
                                                      options.min_sv_size)
    assert all(bad == 0 for bad, _first, _warm in results.values())


def test_split_read_signatures_on_gpu(gpu_device, workload):  # noqa: F811
    from svim_tpu.collect import analyze_alignment_file_coordsorted
    from svim_tpu.collect.packed import collect_signatures_packed
    from svim_tpu.io.sam import AlignmentFile

    _bam, _genome, header, records, options = workload
    sliced = AlignmentFile("slice", records=records, header=header)
    with jax.default_device(gpu_device):
        device, device_trans = collect_signatures_packed(sliced, options)
    host, host_trans = analyze_alignment_file_coordsorted(sliced, options)
    assert chip_smoke.signature_mismatches(device, host) == 0
    assert chip_smoke.signature_mismatches(device_trans, host_trans) == 0


@pytest.mark.parametrize("length,edits", [(500, 20), (2000, 300)])
def test_wavefront_on_gpu(gpu_device, length, edits):
    rng = random.Random(length)
    pairs = []
    for _ in range(64):
        a = "".join(rng.choice("ACGT") for _ in range(length))
        b = list(a)
        for _ in range(rng.randint(0, edits)):
            b[rng.randrange(len(b))] = rng.choice("ACGT")
        pairs.append((a, "".join(b)))
    hints = [2 * edits] * len(pairs)
    with jax.default_device(gpu_device):
        bad, _device_s, _native_s = chip_smoke.check_wavefront(pairs, hints,
                                                               repeats=1)
    assert bad == 0


def test_linkage_on_gpu(gpu_device, workload):  # noqa: F811
    from svim_tpu.signatures import SignatureDeletion

    *_rest, options = workload
    samples = [[SignatureDeletion("chr1", 37 * i * i + part,
                                  37 * i * i + part + 300 + 7 * i, "cigar",
                                  "p{0}r{1}".format(part, i))
                for i in range(3 + part)] for part in range(100)]
    with jax.default_device(gpu_device):
        result = chip_smoke.check_linkage(samples, options)
    assert result["distance_mismatches"] == 0
    assert result["merge_mismatches"] == 0
    assert result["merge_rows_compared"] > 0
