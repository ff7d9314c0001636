"""Multi-chip sharding tests on the virtual 8-device CPU mesh."""

import jax
import numpy as np
import pytest

from svim_tpu.ops.distance_kernel import span_position_matrix
from svim_tpu.parallel.mesh import build_pipeline_step, make_mesh


@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
def test_pipeline_step_compiles_and_runs(n_devices):
    mesh = make_mesh(n_devices)
    step = build_pipeline_step(mesh)
    n = 8 * n_devices
    k = 128
    cigar_words = np.zeros((n, k), dtype=np.int32)
    cigar_words[:, 0] = (50 << 4) | 0
    cigar_words[:, 1] = (60 << 4) | 2
    cigar_words[:, 2] = (50 << 4) | 0
    ref_start = np.arange(n, dtype=np.int32) * 10
    ref_end = ref_start + 160
    loci = np.asarray([[0, 10_000], [100_000, 100_100]], dtype=np.int32)
    starts, lengths, is_ins, rows, counts, depth = jax.device_get(
        step(cigar_words, ref_start, ref_end, loci))
    # every read contributes one DEL event with start = ref_start + 50
    keep = rows >= 0
    assert sorted(starts[keep].tolist()) == sorted((ref_start + 50).tolist())
    # global row indices come back in global row order
    assert rows[keep].tolist() == sorted(rows[keep].tolist())
    assert counts.sum() == n
    assert not is_ins[keep].any()
    assert int(depth[0]) == n
    assert int(depth[1]) == 0


def test_depth_psum_matches_serial():
    mesh = make_mesh(4)
    step = build_pipeline_step(mesh)
    n, k = 32, 128
    rng = np.random.default_rng(7)
    cigar_words = np.zeros((n, k), dtype=np.int32)
    cigar_words[:, 0] = (100 << 4) | 0
    ref_start = rng.integers(0, 5000, size=n, dtype=np.int32)
    ref_end = ref_start + 100
    loci = np.asarray([[1000, 1200], [2000, 2500], [4800, 4900]], dtype=np.int32)
    *_rest, depth = jax.device_get(
        step(cigar_words, ref_start, ref_end, loci))
    for i, (locus_start, locus_end) in enumerate(loci.tolist()):
        expected = int(np.sum((ref_start < locus_end) & (ref_end > locus_start)))
        assert int(depth[i]) == expected


def test_collect_step_overflow_retry():
    """Per-shard event tables grow until the TRUE counts fit — events are
    never silently dropped (each read here carries 8 deletions, far past a
    2-entry initial table)."""
    from svim_tpu.parallel.mesh import run_collect_step

    mesh = make_mesh(4)
    n, k = 16, 64
    events_per_read = 8
    cigar_words = np.zeros((n, k), dtype=np.int32)
    for e in range(events_per_read):
        cigar_words[:, 2 * e] = (50 << 4) | 0
        cigar_words[:, 2 * e + 1] = (60 << 4) | 2
    cigar_words[:, 2 * events_per_read] = (50 << 4) | 0
    ref_start = np.arange(n, dtype=np.int32) * 10_000
    ref_end = ref_start + 50 * (events_per_read + 1) + 60 * events_per_read
    loci = np.asarray([[0, 10_000_000]], dtype=np.int32)
    starts, lengths, is_ins, rows, depth = run_collect_step(
        mesh, cigar_words, ref_start, ref_end, loci, events_per_shard=2)
    assert len(starts) == n * events_per_read
    expected = sorted(int(ref_start[r]) + 50 + e * 110
                      for r in range(n) for e in range(events_per_read))
    assert sorted(starts.tolist()) == expected
    assert rows.tolist() == sorted(rows.tolist())
    assert int(depth[0]) == n


def _boundary_workload(tmp_path, n_loci=8, coverage=32):
    """Coordinate-sorted BAM where every locus's supporting reads span a
    shard row boundary (n rows = n_loci * coverage; 8 shards cut every 32
    rows — each locus block of 32 reads crosses a cut for coverage=32 only
    when loci interleave, so jitter starts to interleave blocks)."""
    import random

    from svim_tpu.io import bam as bamio
    from svim_tpu.io.sam import AlignmentFile

    rng = random.Random(99)
    lines = []
    read_no = 0
    for locus in range(n_loci):
        position = 50_000 + locus * 9_000
        size = 80 + locus * 15
        for _ in range(coverage):
            start = position + rng.randint(-300, 300)
            lines.append("r{0}\t0\tchr1\t{1}\t60\t400M{2}D400M\t*\t0\t0\t{3}\t*".format(
                read_no, start + 1, size + rng.randint(-2, 2), "A" * 800))
            read_no += 1
    lines.sort(key=lambda line: int(line.split("\t")[3]))
    sam_path = tmp_path / "boundary.sam"
    sam_path.write_text("@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr1\tLN:1000000\n"
                        + "\n".join(lines) + "\n")
    af = AlignmentFile(str(sam_path))
    bam_path = tmp_path / "boundary.bam"
    bamio.write_bam(str(bam_path), af.header, list(af.fetch(until_eof=True)))
    genome_path = tmp_path / "genome.fa"
    rng2 = random.Random(5)
    genome_path.write_text(">chr1\n"
                           + "".join(rng2.choice("ACGT") for _ in range(200_000))
                           + "\n")
    return str(bam_path), str(genome_path)


def _vcf_body(path):
    with open(path) as handle:
        return [line for line in handle
                if not line.startswith("##fileDate")]


def test_full_pipeline_num_shards_byte_parity(tmp_path):
    """cli.main end-to-end: num_shards=8 (sharded COLLECT + sharded device
    clustering over the virtual mesh) produces a byte-equal VCF to the
    single-device run, on an input whose partitions straddle shard-boundary
    rows."""
    from svim_tpu.cli import main

    bam_path, genome_path = _boundary_workload(tmp_path)
    wd1 = tmp_path / "wd1"
    wd8 = tmp_path / "wd8"
    assert main(["alignment", str(wd1), bam_path, genome_path]) == 0
    assert main(["alignment", str(wd8), bam_path, genome_path,
                 "--num_shards", "8"]) == 0
    body1 = _vcf_body(wd1 / "variants.vcf")
    body8 = _vcf_body(wd8 / "variants.vcf")
    assert body1 == body8
    assert sum(1 for line in body1 if not line.startswith("#")) >= 8


def test_span_position_matrix_matches_host():
    from svim_tpu.cluster.accel import distance_matrix
    from svim_tpu.config import parse_arguments
    from svim_tpu.signatures import SignatureDeletion

    rng = np.random.default_rng(3)
    n = 24
    starts = rng.integers(1000, 2000, size=n)
    ends = starts + rng.integers(50, 500, size=n)
    sigs = [SignatureDeletion("chr1", int(s), int(e), "cigar", "r{0}".format(i))
            for i, (s, e) in enumerate(zip(starts, ends))]
    options = parse_arguments(arguments=["alignment", ".", "x.bam", "g.fa"])
    host = distance_matrix(sigs, "DEL", None, options)

    pad = 128
    starts_pad = np.zeros((1, pad), dtype=np.int32)
    ends_pad = np.zeros((1, pad), dtype=np.int32)
    reads = np.arange(pad, dtype=np.int32)[None]
    valid = np.zeros((1, pad), dtype=bool)
    starts_pad[0, :n] = starts
    ends_pad[0, :n] = ends
    valid[0, :n] = True
    device = np.asarray(span_position_matrix(
        starts_pad, ends_pad, reads, valid,
        np.float32(options.position_distance_normalizer)))[0, :n, :n]
    np.testing.assert_allclose(device, host, rtol=1e-6)
