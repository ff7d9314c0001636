#!/usr/bin/env python3
"""svim-tpu benchmark: aligned reads/s through signature extraction + clustering.

Workload: synthetic long-read BAM (ONT-like CIGARs with embedded SVs, split
reads with SA tags).  Baseline: the ACTUAL single-core SVIM v2.0.0 — the
unmodified reference code under /root/reference run against this repo's
pysam shim (tests/shims; its record accessors are memoized one-pass
computations, approximating pysam's C-backed properties) — timed over the
same COLLECT+CLUSTER stages, plus a measured strict lower bound for the BAM
ingest real pysam pays inside COLLECT.  When the reference tree is absent
the baseline falls back to this repo's sequential host port of the same
loops.  Array path: packed BAM scan + device kernels on the GPU; a run
that finds no GPU fails.

Prints ONE JSON line:
  {"metric": ..., "value": reads/s, "unit": "reads/s", "vs_baseline": x}
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_READS = int(os.environ.get("SVIM_BENCH_READS", "8192"))
# 0 = run the baseline over the full workload (fair: clustering cost is
# nonlinear in signature density, so subsampled baselines extrapolate wrong)
BASELINE_SAMPLE = int(os.environ.get("SVIM_BENCH_BASELINE_READS", "0"))
READ_LENGTH_OPS = 3000          # CIGAR ops per read (ONT-like noise)
REPEATS = int(os.environ.get("SVIM_BENCH_REPEATS", "9"))


COVERAGE = 24          # reads supporting each simulated SV locus


_OP_M, _OP_I, _OP_D = 0, 1, 2


def _noisy_cigar(rng, sv=None):
    """ONT-like CIGAR: many 1-8 bp indels; optionally one embedded SV op
    `sv` = (op code, length) replacing the indel after match run `sv_at`.
    Returns (BAM cigar words, seq_len, ref_len, sv_seq_pos, ref_before_sv)
    where ref_before_sv is the reference length consumed before the SV op —
    the caller anchors the read so the SV lands at the locus position (real
    variants have ONE genomic position; alignment jitter is small)."""
    half = READ_LENGTH_OPS // 2
    matches = rng.integers(3, 16, size=half)
    indel_ops = np.where(rng.integers(0, 2, size=half) == 0, _OP_I, _OP_D)
    indel_lens = rng.integers(1, 9, size=half)
    sv_seq_pos = -1
    ref_before_sv = -1
    if sv:
        sv_at = int(rng.integers(half // 4, 3 * half // 4 + 1))
        indel_ops[sv_at], indel_lens[sv_at] = sv
        read_adv = matches + np.where(indel_ops == _OP_I, indel_lens, 0)
        ref_adv = matches + np.where(indel_ops == _OP_D, indel_lens, 0)
        ref_before_sv = int(ref_adv[:sv_at].sum() + matches[sv_at])
        sv_seq_pos = int(read_adv[:sv_at].sum() + matches[sv_at])
    words = np.empty(2 * half + 1, dtype=np.uint32)
    words[0:-1:2] = (matches << 4) | _OP_M
    words[1:-1:2] = (indel_lens << 4) | indel_ops
    words[-1] = (20 << 4) | _OP_M
    seq_len = int(matches.sum() + indel_lens[indel_ops == _OP_I].sum() + 20)
    ref_len = int(matches.sum() + indel_lens[indel_ops == _OP_D].sum() + 20)
    return words, seq_len, ref_len, sv_seq_pos, ref_before_sv


def make_workload(tmp_dir, n_reads=None):
    """Synthetic BAM of `n_reads` reads (default N_READS) with realistic
    coverage pileups: DEL and INS loci each supported by ~COVERAGE reads
    (shared breakpoints, per-read noisy copies of the inserted sequence),
    background reads with indel noise, ~8% split reads.  This shape
    exercises clustering the way deep long-read data does (multi-member
    partitions, INS haplotype edit distances, consensus).  Generated from a
    fixed seed; returns (bam_path, genome_path)."""
    from svim_tpu.io import bam as bamio
    from svim_tpu.io.sam import AlignmentHeader

    n_reads = N_READS if n_reads is None else n_reads
    # SV loci scale with the read count (constant SV density, like real
    # genomes: deeper total input = proportionally more loci at the same
    # coverage)
    n_del_loci = max(8, n_reads // 85)
    n_ins_loci = max(8, n_reads // 85)
    genome_span = max(12_000_000, n_reads * 6_000)

    rng = np.random.default_rng(1234)
    header_text = ("@HD\tVN:1.6\tSO:coordinate\n"
                   "@SQ\tSN:chr1\tLN:200000000\n@SQ\tSN:chr2\tLN:150000000\n")
    header = AlignmentHeader.from_text(header_text)
    records = []   # (reference_start, encoded record)

    def add_read(start, words, seq, tags=()):
        records.append((start, bamio.encode_record(
            "read{0}".format(len(records)), 0, 0, start, 60, words, seq,
            tags=tags)))

    # deletion loci: COVERAGE reads sharing one D run (jittered size) at ONE
    # genomic position (reads are anchored so the SV op lands on the locus)
    for _locus in range(n_del_loci):
        locus_pos = int(rng.integers(100_000, genome_span + 1))
        size = int(rng.integers(60, 801))
        for _ in range(COVERAGE):
            words, seq_len, _, _, ref_before = _noisy_cigar(
                rng, sv=(_OP_D, size + int(rng.integers(-3, 4))))
            add_read(locus_pos - ref_before + int(rng.integers(-10, 11)),
                     words, b"A" * seq_len)

    # insertion loci: COVERAGE reads inserting noisy copies of a shared motif
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    for _locus in range(n_ins_loci):
        locus_pos = int(rng.integers(100_000, genome_span + 1))
        size = int(rng.integers(60, 501))
        motif = bases[rng.integers(0, 4, size=size)]
        for _ in range(COVERAGE):
            noisy = motif.copy()
            n_noise = int(rng.integers(0, 5))  # per-read sequencing noise
            noisy[rng.integers(0, size, size=n_noise)] = bases[
                rng.integers(0, 4, size=n_noise)]
            words, seq_len, _, sv_pos, ref_before = _noisy_cigar(
                rng, sv=(_OP_I, size))
            seq = (b"A" * sv_pos + noisy.tobytes()
                   + b"A" * (seq_len - sv_pos - size))
            add_read(locus_pos - ref_before + int(rng.integers(-10, 11)),
                     words, seq)

    # background reads (noise only) + occasional split reads
    n_background = max(0, n_reads - len(records))
    for i in range(n_background):
        words, seq_len, _, _, _ = _noisy_cigar(rng)
        tags = ()
        if i % 12 == 0:
            tags = (("SA", "chr2,{0},+,{1}S{2}M,60,0;".format(
                int(rng.integers(1, 100_000_001)), seq_len - 500, 500), "Z"),)
        add_read(int(rng.integers(0, genome_span + 1)), words,
                 b"A" * seq_len, tags)

    records.sort(key=lambda record: record[0])
    bam_path = os.path.join(tmp_dir, "bench.bam")
    bamio.write_bam_records(bam_path, header,
                            (encoded for _start, encoded in records))

    genome_path = os.path.join(tmp_dir, "genome.fa")
    genome_rng = np.random.default_rng(5)
    # chr1 covers every locus so INS clustering fetches real windows
    rows = genome_span // 60 + 1
    lines = np.empty((rows, 61), dtype=np.uint8)
    lines[:, :60] = bases[genome_rng.integers(0, 4, size=(rows, 60),
                                              dtype=np.uint8)]
    lines[:, 60] = ord("\n")
    with open(genome_path, "wb") as handle:
        handle.write(b">chr1\n")
        handle.write(lines.tobytes())
        handle.write(b">chr2\n" + b"ACGT" * 2500 + b"\n")
    return bam_path, genome_path


def run_cluster(signatures, options):
    from svim_tpu.cluster import cluster_sv_signatures
    return cluster_sv_signatures(signatures, options)


def run_cluster_reference(signatures, options):
    """Reference-equivalent clustering (scalar per-pair loops, the cost model
    of single-core SVIM)."""
    from svim_tpu.cluster.reference_path import cluster_sv_signatures_reference
    return cluster_sv_signatures_reference(signatures, options)


REFERENCE_SRC = "/root/reference/src"


def _reference_baseline_measurement(tmp_dir, bam_path, genome_path):
    """Time the UNMODIFIED reference SVIM's COLLECT+CLUSTER on the workload
    (runs in a subprocess via --reference-baseline: the reference mutates
    global logging and the shim import must shadow absent third-party
    packages).  Prints ONE json line {best_s, n_sigs}."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "tests", "shims"))
    sys.path.insert(1, REFERENCE_SRC)
    os.environ["JAX_PLATFORMS"] = "cpu"
    import logging
    logging.disable(logging.INFO)

    from svim_tpu.config import parse_arguments
    options = parse_arguments(arguments=["alignment", tmp_dir, bam_path,
                                         genome_path])
    import pysam  # the shim (first-party IO underneath)
    from svim.SVIM_COLLECT import analyze_alignment_file_coordsorted
    from svim.SVIM_CLUSTER import cluster_sv_signatures as reference_cluster

    best = float("inf")
    n_sigs = 0
    # first pass warms scipy/.fai; best-of-4 because this box's multi-100ms
    # stalls move single measurements ±30% (same policy as the array side;
    # round 4 saw identical binaries read 10.9x and 33.5x hours apart)
    for _ in range(4):
        bam = pysam.AlignmentFile(bam_path)
        t0 = time.perf_counter()
        signatures, _trans = analyze_alignment_file_coordsorted(bam, options)
        reference_cluster(signatures, options)
        best = min(best, time.perf_counter() - t0)
        n_sigs = len(signatures)
    print(json.dumps({"best_s": best, "n_sigs": n_sigs}))


def _run_reference_baseline_subprocess(tmp_dir, bam_path, genome_path):
    """Reference baseline in a subprocess; None when unavailable/failed."""
    if not os.path.isdir(REFERENCE_SRC):
        return None
    import subprocess
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__),
             "--reference-baseline", tmp_dir, bam_path, genome_path],
            capture_output=True, timeout=1200, text=True)
    except subprocess.TimeoutExpired:
        return None
    if proc.returncode != 0:
        return None
    for line in reversed(proc.stdout.splitlines()):
        line = line.strip()
        if line.startswith("{"):
            return json.loads(line)
    return None


def _array_measurement(tmp_dir, bam_path, genome_path):
    """Measure the array path on the GPU; prints ONE json line
    {platform, best_s}.  Runs in a child process (see main) so that the
    parent never opens the card."""
    import logging
    logging.disable(logging.INFO)

    import jax

    from svim_tpu.config import parse_arguments
    from svim_tpu.utils.device import pin_platform, resolve_platform

    pin_platform("gpu")
    resolve_platform("gpu", jax.default_backend())
    options = parse_arguments(arguments=["alignment", tmp_dir, bam_path, genome_path])

    from svim_tpu.collect.packed import collect_soa_from_bam

    device = jax.devices()[0]
    platform = "{0} {1}".format(device.platform, device.device_kind)
    # warmup (compile)
    collect_soa_from_bam(bam_path, options)
    best = float("inf")
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        _header, _packed, signatures, _twins = collect_soa_from_bam(bam_path, options)
        collect_time = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_cluster(signatures, options)
        cluster_time = time.perf_counter() - t0
        best = min(best, collect_time + cluster_time)
        # release this iteration's packed buffers BEFORE the next scan so the
        # native inflate pool can recycle them (a fresh hundreds-of-MB
        # bytearray risks this kernel's variable page-compaction stalls)
        del _header, _packed, signatures, _twins
    print(json.dumps({"platform": platform, "best_s": best}))


def _run_array_subprocess(tmp_dir, bam_path, genome_path, env):
    """Array measurement in a child process with the caller's `env`; raises
    when the child fails (no GPU, device error or timeout)."""
    import subprocess
    timeout_s = int(os.environ.get("SVIM_BENCH_ARRAY_TIMEOUT", "2100"))
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--array",
         tmp_dir, bam_path, genome_path],
        capture_output=True, timeout=timeout_s, env=env, text=True)
    if proc.returncode == 0:
        for line in reversed(proc.stdout.splitlines()):
            line = line.strip()
            if line.startswith("{"):
                return json.loads(line)
    raise RuntimeError("array measurement failed:\n" + proc.stderr[-4000:])


def main():
    import logging
    logging.disable(logging.INFO)
    import tempfile

    from svim_tpu.config import parse_arguments

    # one process per card: only the --array child opens the GPU; the
    # parent's own JAX work (baseline fallback) stays on the host
    child_env = dict(os.environ)
    os.environ["JAX_PLATFORMS"] = "cpu"
    tmp_dir = tempfile.mkdtemp(prefix="svim_bench_")
    bam_path, genome_path = make_workload(tmp_dir)
    options = parse_arguments(arguments=["alignment", tmp_dir, bam_path, genome_path])

    # The reference pays BAM ingest inside its COLLECT loop (htslib BGZF
    # inflate + pysam record decode), while the shim's AlignmentFile decodes
    # records up front (outside the timed window) and the array path's
    # timing includes its own scan.  Charge the baseline a measured STRICT
    # LOWER BOUND on that cost: the single-threaded native inflate + record
    # walk + column decode, with no Python object materialization and
    # libdeflate (faster than htslib's zlib).  Everything pysam does beyond
    # this is uncharged.
    ingest_best = 0.0
    try:
        from svim_tpu import native as svim_native
        from svim_tpu.io.packing import bucket_size
        if svim_native.get_library() is not None and not BASELINE_SAMPLE:
            with open(bam_path, "rb") as handle:
                compressed = handle.read()
            ingest_best = float("inf")
            for _ in range(2):
                t0 = time.perf_counter()
                data, counted = svim_native.bam_scan_fused(
                    compressed, options.min_mapq, 0, n_threads=1)
                svim_native.bamscan_native(data, options.min_mapq, bucket_size,
                                           0, counted=counted, n_threads=1)
                ingest_best = min(ingest_best, time.perf_counter() - t0)
    except Exception:
        ingest_best = 0.0

    # ---- array path FIRST: the reference subprocess peaks at GBs of Python
    # objects and leaves the box's page cache churned — measuring the array
    # path after it was worth ~2x on its best_s (pure box-state noise)
    array = _run_array_subprocess(tmp_dir, bam_path, genome_path, child_env)
    array_reads_per_s = N_READS / array["best_s"]

    # ---- baseline: the ACTUAL reference (unmodified, via shims) ---------------
    reference = (None if BASELINE_SAMPLE
                 else _run_reference_baseline_subprocess(tmp_dir, bam_path,
                                                         genome_path))
    if reference is not None:
        baseline_best = reference["best_s"]
        baseline_reads = N_READS
    else:
        # fallback: this repo's sequential host port of the same loops
        from svim_tpu.collect.intra import analyze_alignment_indel
        from svim_tpu.collect.collect import retrieve_other_alignments
        from svim_tpu.collect.inter import analyze_read_segments
        from svim_tpu.io.sam import AlignmentFile

        bam_host = AlignmentFile(bam_path)
        host_records = list(bam_host.fetch(until_eof=True))
        if BASELINE_SAMPLE:
            host_records = host_records[:BASELINE_SAMPLE]
        baseline_reads = len(host_records)

        baseline_best = float("inf")
        # first pass warms one-time costs (scipy, .fai build) for BOTH
        # paths; best-of-2 keeps the baseline fair under load noise
        for _ in range(2):
            t0 = time.perf_counter()
            host_signatures = []
            for record in host_records:
                supplementary = [aln for aln in retrieve_other_alignments(record, bam_host)
                                 if aln.mapping_quality >= options.min_mapq]
                sigs, _ = analyze_alignment_indel(record, bam_host, record.query_name, options)
                host_signatures.extend(sigs)
                sigs, _ = analyze_read_segments(record, supplementary, bam_host, options)
                host_signatures.extend(sigs)
            host_collect_time = time.perf_counter() - t0
            t0 = time.perf_counter()
            run_cluster_reference(host_signatures, options)
            host_cluster_time = time.perf_counter() - t0
            baseline_best = min(baseline_best,
                                host_collect_time + host_cluster_time)
    baseline_reads_per_s = baseline_reads / (baseline_best + ingest_best)

    result = {
        "metric": "aligned reads/s through signature extraction+clustering (1 card: {0})".format(
            array["platform"]),
        "value": round(array_reads_per_s, 2),
        "unit": "reads/s",
        "vs_baseline": round(array_reads_per_s / baseline_reads_per_s, 2),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--array":
        _array_measurement(sys.argv[2], sys.argv[3], sys.argv[4])
    elif len(sys.argv) > 1 and sys.argv[1] == "--reference-baseline":
        _reference_baseline_measurement(sys.argv[2], sys.argv[3], sys.argv[4])
    else:
        main()
