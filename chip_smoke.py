#!/usr/bin/env python3
"""Smoke run of the BAM -> VCF pipeline on an NVIDIA GPU.

    python chip_smoke.py             # one card: phases 0-3
    python chip_smoke.py --chips 4   # the multi-card paths only (four cards)

Phase 0 checks the environment.  JAX's default device must be a GPU;
otherwise the script exits 2, naming the platform it found, and prints no
result (it never falls back to the CPU).  The native library, which does
the BAM scan and the consensus, must build.

Phase 1 compares every kernel of the default path, compiled for the card,
with its host oracle on batches taken from the phase-2 workload, and prints
each kernel's first-call (trace + compile) time, warm median and mismatch
count:
  * the CIGAR scan (collect_scan, collect_scan_u8) against collect/intra.py
    and the io/cigar.py geometry, on 4096 reads of the workload;
  * split-read classification (classify_groups_fused) against
    collect/inter.py, compared signature by signature on the same reads;
  * the linkage kernels (span_position_agglomerate_batched, the distance
    contract) against the float64 matrices of cluster/accel.py and scipy's
    merge order, on the workload's DEL partitions;
  * the genotype join (genotype_ref_support_device) against the numpy join,
    on the jobs the 65k run sent to it;
  * the `gpu`-marked tests (pytest -m gpu tests/test_gpu_kernels.py).

Phase 2 runs `svim_tpu.cli.main` on the 65,536-read bench workload (~20 kb
ONT-like reads, ~1.3 Gbp aligned) and on the sim2 dataset (all six SV
classes).  Each variants.vcf must equal the plain host path's
(--device_backend host --cluster_backend exact, in a child process pinned
to the CPU) byte for byte, apart from the ##fileDate header line, which
holds the time of the run.

Phase 3 runs the 65k input through the device INS route
(--edit_backend wavefront); its VCF must equal phase 2's.  The wavefront
distances it computed are compared with the native Myers batch and both
are timed on the same pairs.

Precision: svim_tpu/ops has no matrix product, so TF32 cannot arise.  The
integer kernels (CIGAR scan, segment classification, genotype join,
wavefront distances) must match exactly.  The linkage kernels compute in
float32 against scipy's float64: distances within rtol 1e-6, merge
sequences identical wherever the tie-gap guard does not flag the partition.

`--chips 4` runs the 65k input with --num_shards 4 (one process, four
cards) and with --distributed (four rank processes, one card each, given
by CUDA_VISIBLE_DEVICES); each VCF must equal the host path's.

Every number is printed beside the card's name and power limit.  The last
line of stdout is {"ok": true, "device": {...}}.  Any failed phase exits
non-zero.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import re
import shutil
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib

REPO = os.path.dirname(os.path.abspath(__file__))
N_READS = 65536
SLICE_READS = 4096
WARM_REPEATS = 5
# every `gpu`-marked test lives here (collecting the whole tests/ tree can
# pick up an installed package that is also named `tests`)
GPU_TESTS = os.path.join(REPO, "tests", "test_gpu_kernels.py")


class SmokeFailure(RuntimeError):
    """A phase whose result is wrong."""


def card_name() -> str:
    """`name, power.limit` of the first card as nvidia-smi reports it."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"
    return out.strip().splitlines()[0]


class Reporter:
    """Prints every result line beside the card it was measured on."""

    def __init__(self, card: str):
        self.card = card

    def __call__(self, text: str):
        print("[{0}] {1}".format(self.card, text), flush=True)


# ---------------------------------------------------------------- helpers


def vcf_body(path: str):
    """variants.vcf lines without the ##fileDate header (a timestamp)."""
    with open(path) as handle:
        return [line for line in handle if not line.startswith("##fileDate")]


def stage_times(workdir: str, pattern: str = "SVIM_*.log") -> dict:
    """The --profile stage timings from a run's log."""
    times = {}
    logs = sorted(glob.glob(os.path.join(workdir, pattern)))
    if not logs:
        return times
    with open(logs[-1]) as handle:
        text = handle.read()
    tail = text[text.rfind("Stage timings"):]
    for name, seconds in re.findall(r"\]\s+(\w+)\s+([\d.]+)s\s+\(", tail):
        times[name] = float(seconds)
    return times


def telemetry_from_log(workdir: str):
    """The device-clustering summary line of a run's log, or None."""
    for path in sorted(glob.glob(os.path.join(workdir, "SVIM_*.log"))):
        with open(path) as handle:
            for line in handle:
                if "Device clustering:" in line:
                    return line.split("Device clustering:", 1)[1].strip()
    return None


def head_records(bam_path: str, n: int):
    """(header, first n records) of a BAM, inflating only the BGZF blocks
    those records need."""
    from svim_tpu.io.bam import _parse_record
    from svim_tpu.io.sam import AlignmentHeader

    with open(bam_path, "rb") as handle:
        raw = handle.read()
    data = bytearray()
    offset = 0

    def need(size):
        nonlocal offset
        while len(data) < size and offset < len(raw):
            (bsize,) = struct.unpack_from("<H", raw, offset + 16)
            block = raw[offset:offset + bsize + 1]
            data.extend(zlib.decompress(block[18:-8], -15))
            offset += bsize + 1
        if len(data) < size:
            raise ValueError("BAM ended early")

    need(12)
    (l_text,) = struct.unpack_from("<i", data, 4)
    need(12 + l_text)
    text = bytes(data[8:8 + l_text]).decode().rstrip("\x00")
    p = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, p)
    p += 4
    for _ in range(n_ref):
        need(p + 4)
        (l_name,) = struct.unpack_from("<i", data, p)
        p += 4 + l_name + 4
    header = AlignmentHeader.from_text(text)
    records = []
    while len(records) < n:
        try:
            need(p + 4)
        except ValueError:
            break
        (block_size,) = struct.unpack_from("<i", data, p)
        need(p + 4 + block_size)
        records.append(_parse_record(data, p + 4, block_size))
        p += 4 + block_size
    return header, records


class KernelSpy:
    """Wraps a module-level function everywhere svim_tpu refers to it and
    keeps the arguments and result of its first call, its first-call wall
    time (trace + compile for a jitted function) and its call count."""

    def __init__(self, module_name: str, attribute: str):
        import importlib

        self.module = importlib.import_module(module_name)
        self.name = attribute
        self.original = getattr(self.module, attribute)
        self.args = None
        self.kwargs = None
        self.result = None
        self.first_s = None
        self.calls = 0
        self._patched = []

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if self.calls > 1:
            return self.original(*args, **kwargs)
        start = time.perf_counter()
        result = self.original(*args, **kwargs)
        self.first_s = time.perf_counter() - start
        self.args, self.kwargs, self.result = args, kwargs, result
        return result

    def __enter__(self):
        for module in list(sys.modules.values()):
            name = getattr(module, "__name__", "") or ""
            if (name.startswith("svim_tpu")
                    and getattr(module, self.name, None) is self.original):
                setattr(module, self.name, self)
                self._patched.append(module)
        return self

    def __exit__(self, *exc):
        for module in self._patched:
            setattr(module, self.name, self.original)
        self._patched = []
        return False

    def warm_median(self, repeats: int = WARM_REPEATS) -> float:
        """Median wall time of re-running the first call's arguments,
        waiting for the device each time."""
        import jax

        times = []
        for _ in range(repeats):
            start = time.perf_counter()
            jax.block_until_ready(self.original(*self.args, **self.kwargs))
            times.append(time.perf_counter() - start)
        return statistics.median(times)


def timed(fn, *args, repeats: int = WARM_REPEATS, **kwargs):
    """(result, first-call seconds, warm median seconds) of fn(*args),
    waiting for the device inside each timing."""
    import jax

    start = time.perf_counter()
    result = jax.block_until_ready(fn(*args, **kwargs))
    first = time.perf_counter() - start
    warm = []
    for _ in range(repeats):
        start = time.perf_counter()
        jax.block_until_ready(fn(*args, **kwargs))
        warm.append(time.perf_counter() - start)
    return result, first, statistics.median(warm)


# ------------------------------------------------------- kernel comparisons


def check_cigar_scan(records, min_sv_size: int):
    """collect_scan (raw and compacted words) and collect_scan_u8 (its
    uint8 transfer encoding of the raw words) against the host CIGAR walk.
    Returns {kernel[input]: (mismatched rows, first s, warm s)} and the
    batch width."""
    import jax
    import numpy as np

    from svim_tpu.collect.intra import scan_cigar_indels
    from svim_tpu.io import cigar as cigar_ops
    from svim_tpu.io.packing import (
        bucket_size,
        compact_cigar_words,
        encode_cigars_u8,
    )
    from svim_tpu.ops.cigar_kernel import collect_scan, collect_scan_u8

    rows = [record.cigartuples or [] for record in records]
    width = bucket_size(max(1, max(len(row) for row in rows)))
    words = np.zeros((len(rows), width), dtype=np.int32)
    for index, row in enumerate(rows):
        words[index, :len(row)] = [(length << 4) | op for op, length in row]
    ref_start = np.asarray([record.reference_start for record in records],
                           dtype=np.int32)
    max_events = 1024
    while max_events < 4 * len(rows):
        max_events *= 2

    want_events = {}
    want_geometry = []
    for index, row in enumerate(rows):
        for pos_ref, pos_read, length, kind in scan_cigar_indels(
                row, min_sv_size):
            want_events.setdefault(index, []).append(
                (pos_ref, pos_read, length, kind == "INS"))
        qa_start, qa_end = cigar_ops.query_alignment_bounds(row)
        want_geometry.append((
            int(ref_start[index]) + cigar_ops.reference_length(row),
            cigar_ops.query_length(row, include_hard_clips=True),
            qa_start, qa_end, any(op == 5 and length > 0
                                  for op, length in row)))

    def mismatches(outputs):
        (ref_end, read_len, qa_start, qa_end, has_hard, ev_rows, pos_ref,
         pos_read, lengths, is_ins, count) = jax.device_get(outputs)
        count = int(count)
        if count > max_events:
            raise SmokeFailure("event table overflow ({0})".format(count))
        got_events = {}
        for k in range(count):
            got_events.setdefault(int(ev_rows[k]), []).append(
                (int(pos_ref[k]), int(pos_read[k]), int(lengths[k]),
                 bool(is_ins[k])))
        bad = set(row for row in set(got_events) | set(want_events)
                  if got_events.get(row) != want_events.get(row))
        for index, want in enumerate(want_geometry):
            got = (int(ref_end[index]), int(read_len[index]),
                   int(qa_start[index]), int(qa_end[index]),
                   bool(has_hard[index]))
            if got != want:
                bad.add(index)
        return len(bad)

    results = {}
    threshold = np.int32(min_sv_size)
    # the raw words, and the production encoding: compacted rows (which
    # overflow the uint8 encoding, so they go as int32 words)
    compacted = compact_cigar_words(words, min_sv_size)
    for name, batch in (("collect_scan[raw]", words),
                        ("collect_scan[compacted]", compacted)):
        if batch is None:
            continue
        out, first, warm = timed(collect_scan, batch, ref_start, threshold,
                                 max_events)
        results[name] = (mismatches(out), first, warm)
    encoded = encode_cigars_u8(words)
    if encoded is not None:
        out, first, warm = timed(collect_scan_u8, *encoded, ref_start,
                                 threshold, max_events)
        results["collect_scan_u8[raw]"] = (mismatches(out), first, warm)
    return results, width


def signature_mismatches(device_signatures, host_signatures) -> int:
    """Signatures present on one side only (multiset difference)."""
    from collections import Counter

    device = Counter(sig.as_string() for sig in device_signatures)
    host = Counter(sig.as_string() for sig in host_signatures)
    return sum(((device - host) + (host - device)).values())


def check_linkage(samples, options):
    """span_position_matrix and span_position_agglomerate_batched on DEL
    partitions (3..128 members) against the float64 host matrices and
    scipy's average linkage.  Returns a dict of counts and times."""
    import jax
    import numpy as np

    from svim_tpu.cluster import accel
    from svim_tpu.cluster.device_cluster import z_from_merges
    from svim_tpu.cluster.scipy_fast import average_linkage
    from svim_tpu.ops.distance_kernel import span_position_matrix
    from svim_tpu.ops.linkage_kernel import (
        TIE_EPS,
        span_position_agglomerate_batched,
    )

    pad = 128
    batch = 8
    while batch < len(samples):
        batch *= 2
    starts = np.zeros((batch, pad), dtype=np.int32)
    ends = np.zeros((batch, pad), dtype=np.int32)
    reads = np.full((batch, pad), -1, dtype=np.int32)
    valid = np.zeros((batch, pad), dtype=bool)
    for row, sample in enumerate(samples):
        n = len(sample)
        starts[row, :n], ends[row, :n] = accel._source_columns(sample)
        reads[row, :n] = accel.read_index_array(sample)
        valid[row, :n] = True
    norm = np.float32(options.position_distance_normalizer)
    threshold = np.float32(options.cluster_max_distance)

    distances, dist_first, dist_warm = timed(
        span_position_matrix, starts, ends, reads, valid, norm)
    outputs, aggl_first, aggl_warm = timed(
        span_position_agglomerate_batched, starts, ends, reads, valid, norm,
        threshold, True)
    distances = np.asarray(distances)
    (merges_lo, merges_hi, heights, min_gap, dropped, has_wall,
     dedup_ambiguous) = jax.device_get(outputs)

    result = {"partitions": len(samples), "distance_mismatches": 0,
              "merge_rows_compared": 0, "merge_mismatches": 0,
              "guard_flagged": 0, "matrix_first_s": dist_first,
              "matrix_warm_s": dist_warm, "agglomerate_first_s": aggl_first,
              "agglomerate_warm_s": aggl_warm}
    for row, sample in enumerate(samples):
        n = len(sample)
        host = accel.distance_matrix(sample, "DEL", None, options)
        sample_reads = accel.read_index_array(sample)
        other_read = sample_reads[:, None] != sample_reads[None, :]
        device = distances[row, :n, :n]
        close = np.isclose(device, host, rtol=1e-6, atol=0.0)
        result["distance_mismatches"] += int(np.sum(other_read & ~close))
        if (float(min_gap[row]) < TIE_EPS or bool(has_wall[row])
                or bool(dedup_ambiguous[row]) or bool(dropped[row].any())):
            result["guard_flagged"] += 1
            continue
        z_device = z_from_merges(merges_lo[row], merges_hi[row], heights[row],
                                 n, float(threshold))
        if z_device is None:
            result["guard_flagged"] += 1
            continue
        z_host = average_linkage(accel.condensed_with_wall(
            host, sample_reads, wall_same_read=True))
        result["merge_rows_compared"] += 1
        if not (np.array_equal(z_device[:, [0, 1, 3]], z_host[:, [0, 1, 3]])
                and np.allclose(z_device[:, 2], z_host[:, 2], rtol=1e-5)):
            result["merge_mismatches"] += 1
    return result


def check_genotype(spy):
    """The genotype kernel's counts on the captured jobs against the numpy
    join.  Returns (jobs served by the kernel, mismatches)."""
    from svim_tpu.genotype import _ref_support_host

    jobs, per_tid, _options = spy.args
    served = 0
    bad = 0
    for (tid, start, end, type_class, support_ids, contig_length), got in zip(
            jobs, spy.result):
        if got is None:
            continue
        served += 1
        want = _ref_support_host(per_tid, tid, start, end,
                                 "DEL" if type_class == 0 else "INS",
                                 support_ids, contig_length)
        bad += int(got != want)
    return served, bad


def check_wavefront(pairs, hints, repeats: int = 1):
    """Device wavefront distances (batched_edit_distance_resident, host
    encoding included) against the native Myers batch on the same pairs.
    Call it after a run that compiled these shapes.  Returns (mismatches,
    device median s, native median s)."""
    import jax
    import numpy as np

    from svim_tpu.native import aligner
    from svim_tpu.ops.wavefront_kernel import batched_edit_distance_resident

    device_times = []
    native_times = []
    for _ in range(repeats):
        start = time.perf_counter()
        device = jax.block_until_ready(
            batched_edit_distance_resident(pairs, hints))
        device_times.append(time.perf_counter() - start)
        start = time.perf_counter()
        native = aligner.edit_distance_batch(pairs, band_hints=hints)
        native_times.append(time.perf_counter() - start)
    bad = int(np.sum(np.asarray(jax.device_get(device)) != np.asarray(native)))
    return bad, statistics.median(device_times), statistics.median(native_times)


# ------------------------------------------------------------- pipeline runs


def run_cli(arguments):
    """svim_tpu.cli.main in this process; returns (exit code, seconds)."""
    from svim_tpu import cli

    root = logging.getLogger()
    before = list(root.handlers)
    start = time.perf_counter()
    try:
        code = cli.main(arguments)
    finally:
        for handler in root.handlers[:]:
            if handler not in before:
                root.removeHandler(handler)
                handler.close()
    return code, time.perf_counter() - start


def start_child_cli(arguments, log_path, env_update=None, cpu=True,
                    cores=None):
    """`python -m svim_tpu <arguments>` in a child process; `cpu` pins it
    to the host (JAX_PLATFORMS=cpu, overwritten) so it never opens a card,
    and `cores` to a set of host cores."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if cpu:
        env["JAX_PLATFORMS"] = "cpu"
    env.update(env_update or {})
    command = [sys.executable, "-m", "svim_tpu"] + arguments
    if cores is not None and shutil.which("taskset"):
        command = ["taskset", "-c", ",".join(map(str, sorted(cores)))] + command
    log = open(log_path, "w")
    try:
        return subprocess.Popen(command, env=env, stdout=log,
                                stderr=subprocess.STDOUT, cwd=REPO)
    finally:
        log.close()


def wait_children(children, timeout_s: float):
    """Wait for every child; kill the ones still running at the deadline.
    Returns their exit codes."""
    deadline = time.monotonic() + timeout_s
    codes = []
    for child in children:
        try:
            codes.append(child.wait(timeout=max(1.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            child.kill()
            child.wait()
            codes.append(None)
    return codes


def reference_cores():
    """Host cores for the CPU reference runs that overlap the card's work:
    the last quarter, so the card's own process keeps most of the host."""
    cores = sorted(os.sched_getaffinity(0))
    return set(cores[-max(1, len(cores) // 4):])


def host_reference(workdir, bam, genome, log_path, cores=None):
    """The plain host path on the CPU (no kernels, exact linkage)."""
    return start_child_cli(["alignment", workdir, bam, genome,
                            "--device_backend", "host",
                            "--cluster_backend", "exact", "--profile"],
                           log_path,
                           cores=cores)


def require_same_vcf(say, label, got_dir, want_dir):
    got = vcf_body(os.path.join(got_dir, "variants.vcf"))
    want = vcf_body(os.path.join(want_dir, "variants.vcf"))
    if got != want:
        raise SmokeFailure("{0}: variants.vcf differs from {1}".format(
            got_dir, want_dir))
    say("{0}: variants.vcf identical ({1} lines, ##fileDate excluded)".format(
        label, len(got)))


def make_workloads(root, say):
    sys.path.insert(0, REPO)
    import bench
    from svim_tpu.sim2 import simulate_independent

    start = time.perf_counter()
    bam, genome = bench.make_workload(root, N_READS)
    say("set-up: bench workload {0} reads, {1:.1f} MB BAM, made in "
        "{2:.1f} s".format(N_READS, os.path.getsize(bam) / 1e6,
                           time.perf_counter() - start))
    sim_dir = os.path.join(root, "sim2")
    os.makedirs(sim_dir)
    start = time.perf_counter()
    sim_genome, sim_bam, truth = simulate_independent(sim_dir)
    say("set-up: sim2 dataset {0} truth SVs, made in {1:.1f} s".format(
        len(truth), time.perf_counter() - start))
    return bam, genome, sim_bam, sim_genome, truth


# ----------------------------------------------------------------- one card


def one_card(say, root):
    import jax

    from svim_tpu.cluster.device_cluster import TELEMETRY
    from svim_tpu.config import parse_arguments

    bam, genome, sim_bam, sim_genome, truth = make_workloads(root, say)
    wd = {name: os.path.join(root, name) for name in (
        "dev", "host", "cpu", "sim_dev", "sim_host", "wavefront")}
    # the CPU references run while the card works, on their own cores
    cores = reference_cores()
    children = [
        host_reference(wd["host"], bam, genome, wd["host"] + ".out", cores),
        start_child_cli(["alignment", wd["cpu"], bam, genome,
                         "--device_backend", "cpu"], wd["cpu"] + ".out",
                        cores=cores),
        host_reference(wd["sim_host"], sim_bam, sim_genome,
                       wd["sim_host"] + ".out", cores),
    ]
    try:
        spies = [KernelSpy("svim_tpu.ops.segments_kernel",
                           "classify_groups_fused"),
                 KernelSpy("svim_tpu.ops.genotype_kernel",
                           "genotype_ref_support_device"),
                 KernelSpy("svim_tpu.ops.genotype_kernel",
                           "genotype_support_batched")]
        for spy in spies:
            spy.__enter__()
        try:
            code, seconds = run_cli(["alignment", wd["dev"], bam, genome,
                                     "--profile"])
        finally:
            for spy in spies:
                spy.__exit__(None, None, None)
        if code != 0:
            raise SmokeFailure("device run on the bench input exited "
                               "{0}".format(code))
        gpu_telemetry = TELEMETRY.as_dict()
        dev_times = stage_times(wd["dev"])
        say("phase 2: {0}-read device run {1:.1f} s (cold, compiles "
            "included); stages {2}".format(N_READS, seconds,
                                           json.dumps(dev_times)))
        say("phase 2: device-cluster telemetry {0}".format(
            json.dumps(gpu_telemetry)))

        phase1(say, bam, spies, parse_arguments(
            arguments=["alignment", root, bam, genome]))

        # sim2: all six SV classes
        code, seconds = run_cli(["alignment", wd["sim_dev"], sim_bam,
                                 sim_genome, "--profile"])
        if code != 0:
            raise SmokeFailure("device run on sim2 exited {0}".format(code))
        say("phase 2: sim2 device run {0:.1f} s; stages {1}".format(
            seconds, json.dumps(stage_times(wd["sim_dev"]))))
        from svim_tpu.sim import evaluate_vcf, f1
        scores = evaluate_vcf(os.path.join(wd["sim_dev"], "variants.vcf"),
                              truth)
        say("phase 2: sim2 F1 per class {0}".format(json.dumps(
            {svtype: round(f1(*counts), 4)
             for svtype, counts in sorted(scores.items())})))

        phase3(say, bam, genome, wd, dev_times)

        codes = wait_children(children, timeout_s=900)
        for child_dir, child_code in zip((wd["host"], wd["cpu"],
                                          wd["sim_host"]), codes):
            if child_code != 0:
                with open(child_dir + ".out") as handle:
                    tail = handle.read()[-3000:]
                raise SmokeFailure("reference run {0} exited {1}:\n{2}".format(
                    child_dir, child_code, tail))
        say("phase 2: host path stages (CPU, {0} cores, concurrent with the "
            "card) {1}".format(len(cores), json.dumps(stage_times(wd["host"]))))
        require_same_vcf(say, "phase 2: {0}-read device vs host path".format(
            N_READS), wd["dev"], wd["host"])
        require_same_vcf(say, "phase 2: {0}-read host XLA (--device_backend "
                         "cpu) vs host path".format(N_READS), wd["cpu"],
                         wd["host"])
        require_same_vcf(say, "phase 2: sim2 device vs host path",
                         wd["sim_dev"], wd["sim_host"])
        say("phase 2: linkage guard share on the card {0} vs on host XLA "
            "(same input): {1}".format(gpu_telemetry["fallback_fraction"],
                                       telemetry_from_log(wd["cpu"])))
    finally:
        wait_children(children, timeout_s=0)

    phase_gpu_tests(say)
    device = jax.devices()[0]
    return {"platform": device.platform, "kind": device.device_kind,
            "count": 1}


def phase1(say, bam, spies, options):
    """Kernel checks; `spies` hold what the 65k device run sent to the
    split-read and genotype kernels."""
    from svim_tpu.cluster.cluster import MAX_PARTITION_SIZE
    from svim_tpu.cluster.partition import form_partitions
    from svim_tpu.collect import analyze_alignment_file_coordsorted
    from svim_tpu.collect.packed import collect_signatures_packed
    from svim_tpu.io.sam import AlignmentFile

    header, records = head_records(bam, SLICE_READS)
    scan, width = check_cigar_scan(records, options.min_sv_size)
    for name, (bad, first, warm) in scan.items():
        say("phase 1: {0} ({1} reads x {2} ops): first call {3:.3f} s, warm "
            "median {4:.5f} s, mismatched rows {5}".format(
                name, len(records), width, first, warm, bad))
        if bad:
            raise SmokeFailure("{0}: {1} rows differ from the host "
                               "scan".format(name, bad))

    sliced = AlignmentFile("slice", records=records, header=header)
    device_sigs, device_trans = collect_signatures_packed(sliced, options)
    host_sigs, host_trans = analyze_alignment_file_coordsorted(sliced, options)
    bad = (signature_mismatches(device_sigs, host_sigs)
           + signature_mismatches(device_trans, host_trans))
    classify = spies[0]
    say("phase 1: classify_groups_fused (bench run: {0} calls, first {1} "
        "groups): first call {2:.3f} s, warm median {3:.5f} s; COLLECT "
        "signatures on {4} reads vs collect/intra.py + inter.py: {5} device, "
        "{6} host, {7} mismatched".format(
            classify.calls, classify.args[0].shape if classify.calls else None,
            classify.first_s or 0.0,
            classify.warm_median() if classify.calls else 0.0,
            len(records), len(device_sigs), len(host_sigs), bad))
    if bad or not classify.calls:
        raise SmokeFailure("split-read COLLECT: {0} signature mismatches, "
                           "{1} kernel calls".format(bad, classify.calls))

    partitions = [p for p in form_partitions(
        [sig for sig in device_sigs if sig.type == "DEL"],
        options.partition_max_distance) if 3 <= len(p) <= MAX_PARTITION_SIZE]
    linkage = check_linkage(partitions, options)
    say("phase 1: linkage on {0} DEL partitions: {1}".format(
        len(partitions), json.dumps(linkage)))
    if linkage["distance_mismatches"] or linkage["merge_mismatches"]:
        raise SmokeFailure("linkage kernels disagree with the host")

    jobs_spy, kernel_spy = spies[1], spies[2]
    served, bad = check_genotype(jobs_spy)
    say("phase 1: genotype_support_batched ({0} jobs from the bench run): "
        "first call {1:.3f} s, warm median {2:.5f} s, mismatches vs the numpy "
        "join {3}".format(served, kernel_spy.first_s or 0.0,
                          kernel_spy.warm_median() if kernel_spy.calls
                          else 0.0, bad))
    if bad or not served:
        raise SmokeFailure("genotype kernel: {0} served, {1} mismatches".format(
            served, bad))


def phase3(say, bam, genome, wd, dev_times):
    spy = KernelSpy("svim_tpu.ops.wavefront_kernel",
                    "batched_edit_distance_resident")
    with spy:
        code, seconds = run_cli(["alignment", wd["wavefront"], bam, genome,
                                 "--edit_backend", "wavefront", "--profile"])
    if code != 0:
        raise SmokeFailure("wavefront run exited {0}".format(code))
    times = stage_times(wd["wavefront"])
    say("phase 3: --edit_backend wavefront run {0:.1f} s; CLUSTER {1} s "
        "vs {2} s on the default route; stages {3}".format(
            seconds, times.get("cluster"), dev_times.get("cluster"),
            json.dumps(times)))
    require_same_vcf(say, "phase 3: wavefront route vs default device route",
                     wd["wavefront"], wd["dev"])
    if not spy.calls:
        raise SmokeFailure("the wavefront route computed no edit distances")
    pairs, hints = spy.args
    lengths = [max(len(a), len(b)) for a, b in pairs]
    bad, device_s, native_s = check_wavefront(pairs, hints)
    say("phase 3: {0} INS haplotype pairs (max length {1}, median {2}): "
        "wavefront on the card {3:.4f} s vs native Myers batch on the host "
        "{4:.4f} s; mismatches {5}".format(
            len(pairs), max(lengths), statistics.median(lengths), device_s,
            native_s, bad))
    if bad:
        raise SmokeFailure("wavefront distances differ from native Myers")


def phase_gpu_tests(say):
    import pytest

    start = time.perf_counter()
    code = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                        "-p", "no:randomly", GPU_TESTS])
    say("phase 1: gpu-marked tests exit {0} in {1:.1f} s".format(
        int(code), time.perf_counter() - start))
    if code != 0:
        raise SmokeFailure("gpu-marked tests failed ({0})".format(int(code)))


# --------------------------------------------------------------- four cards


def probe_devices():
    """(platform, device_kind, count) from a child process, so the parent
    never opens a card."""
    code = ("import json, jax; d = jax.devices(); "
            "print(json.dumps([d[0].platform, d[0].device_kind, len(d)]))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    if out.returncode != 0:
        raise SmokeFailure("device probe failed:\n" + out.stderr[-2000:])
    return json.loads(out.stdout.strip().splitlines()[-1])


def four_cards(say, root, count):
    sys.path.insert(0, REPO)
    import bench

    if count < 4:
        raise SmokeFailure("--chips 4 needs four cards, JAX sees {0}".format(
            count))
    start = time.perf_counter()
    bam, genome = bench.make_workload(root, N_READS)
    say("set-up: bench workload {0} reads made in {1:.1f} s".format(
        N_READS, time.perf_counter() - start))
    wd_host = os.path.join(root, "host")
    wd_shards = os.path.join(root, "shards")
    wd_ranks = os.path.join(root, "ranks")
    host = host_reference(wd_host, bam, genome, wd_host + ".out")
    try:
        start = time.perf_counter()
        shards = start_child_cli(["alignment", wd_shards, bam, genome,
                                  "--num_shards", "4", "--profile"],
                                 wd_shards + ".out", cpu=False)
        (code,) = wait_children([shards], timeout_s=900)
        if code != 0:
            raise SmokeFailure("--num_shards 4 run exited {0}".format(code))
        say("--num_shards 4 (one process, 4 cards): {0:.1f} s; stages "
            "{1}".format(time.perf_counter() - start,
                         json.dumps(stage_times(wd_shards))))

        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        start = time.perf_counter()
        ranks = [start_child_cli(
            ["alignment", wd_ranks, bam, genome, "--distributed", "--profile"],
            "{0}.rank{1}.out".format(wd_ranks, rank), cpu=False,
            env_update={"CUDA_VISIBLE_DEVICES": str(rank),
                        "SVIM_COORDINATOR": "localhost:{0}".format(port),
                        "SVIM_NUM_PROCESSES": "4",
                        "SVIM_PROCESS_ID": str(rank)}) for rank in range(4)]
        codes = wait_children(ranks, timeout_s=900)
        if any(code != 0 for code in codes):
            raise SmokeFailure("--distributed ranks exited {0}".format(codes))
        say("--distributed (4 ranks, one card each): {0:.1f} s; rank 0 "
            "stages {1}".format(time.perf_counter() - start,
                                json.dumps(stage_times(wd_ranks, "SVIM_*.p0.log"))))
        (code,) = wait_children([host], timeout_s=900)
        if code != 0:
            raise SmokeFailure("host reference exited {0}".format(code))
        require_same_vcf(say, "--num_shards 4 vs host path", wd_shards,
                         wd_host)
        require_same_vcf(say, "--distributed 4 ranks vs host path", wd_ranks,
                         wd_host)
    finally:
        wait_children([host], timeout_s=0)


# --------------------------------------------------------------------- main


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = parser.parse_args(argv)

    card = card_name()
    print(card, flush=True)
    say = Reporter(card)
    import jax

    from svim_tpu.utils.device import compilation_cache_dir

    say("jax {0}; compile cache {1}".format(jax.__version__,
                                           compilation_cache_dir()))
    if args.chips == 4:
        platform, kind, count = probe_devices()
    else:
        from svim_tpu.utils.device import pin_platform

        pin_platform("gpu")
        devices = jax.devices()
        platform, kind, count = (devices[0].platform, devices[0].device_kind,
                                 len(devices))
    if platform != "gpu":
        print("chip_smoke: no GPU: JAX's default platform is {0!r}".format(
            platform), file=sys.stderr)
        return 2
    from svim_tpu import native

    if native.get_library() is None:
        print("chip_smoke: the native library did not build (see the g++ "
              "error above)", file=sys.stderr)
        return 3
    say("phase 0: {0} x {1} ({2}); native library built".format(
        count, kind, platform))

    root = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        if args.chips == 4:
            four_cards(say, root, count)
            device = {"platform": platform, "kind": kind, "count": 4}
        else:
            device = one_card(say, root)
    except SmokeFailure as failure:
        print("chip_smoke: FAILED: {0}".format(failure), file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
