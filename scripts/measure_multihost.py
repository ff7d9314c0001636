#!/usr/bin/env python3
"""Measure 2-process scaling: wall clock + exchange bytes.

Runs the same workload through the pipeline single-process and as a
2-process jax.distributed job (per-process BAM block ranges, fixed-dtype
SoA exchange, sharded CLUSTER), parses the --profile stage timers from
each log, and prints ONE JSON line:

  {"single_s", "two_proc_s", "efficiency", "collect_cluster_single_s",
   "collect_cluster_two_proc_s", "collect_cluster_efficiency",
   "exchange_sent_bytes", "exchange_rounds", "caveat"}

Efficiency is strong-scaling T1 / (2 * T2).  CAVEAT: on this box both
processes share the same 4 cores, so host-bound stages (BGZF inflate, the
INS edit-distance pool) contend — a real 2-host deployment gives each rank
its own cores and DCN; the number printed here is therefore a LOWER bound
on true 2-host efficiency for the parallelized stages.

SVIM_SCALE_PINNED=1 runs the CORE-PINNED experiment instead (VERDICT r4
next-step #2): the single-rank control is pinned to cores 0-1 and each of
the two ranks to a DISJOINT 2-core set (rank0 -> 0-1, rank1 -> 2-3), so
every process sees the same per-rank core budget — a like-for-like stand-in
for two separate 2-core hosts.  Worker pools size themselves from the
affinity set (svim_tpu/utils/cores.py), so a pinned rank really runs
2-core-wide.  Efficiency stays T1 / (2 * T2): with twice the total cores,
ideal strong scaling halves the wall.
"""

import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)

N_READS = int(os.environ.get("SVIM_SCALE_READS", "8192"))
PINNED = os.environ.get("SVIM_SCALE_PINNED") == "1"
# disjoint 2-core sets; override for boxes with a different topology
SINGLE_CORES = os.environ.get("SVIM_SCALE_SINGLE_CORES", "0,1")
RANK_CORES = os.environ.get("SVIM_SCALE_RANK_CORES", "0,1;2,3").split(";")


def _pin(cores):
    """taskset prefix pinning a subprocess to `cores` (pinned mode only)."""
    return ["taskset", "-c", cores] if PINNED else []


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _stage_seconds(log_text):
    """{stage: seconds} from the --profile report lines."""
    stages = {}
    for match in re.finditer(r"(collect|cluster|combine|genotype)\s+"
                             r"([0-9.]+)s\s+\(", log_text):
        stages[match.group(1)] = float(match.group(2))
    return stages


def _exchange_stats(log_text):
    match = re.search(r"Exchange: (\d+) bytes sent, (\d+) bytes received "
                      r"over (\d+) gather rounds", log_text)
    if match is None:
        return 0, 0, 0
    return int(match.group(1)), int(match.group(2)), int(match.group(3))


def _payload_sizes(bam, genome, tmp_dir):
    """(fixed-dtype exchange bytes, object-pickle bytes) for one rank's full
    COLLECT output — the round-3 design pickled Signature object lists."""
    import pickle

    import numpy as np

    from svim_tpu.collect.packed import collect_soa_from_bam
    from svim_tpu.config import parse_arguments
    from svim_tpu.parallel.multihost import arrays_to_bytes, soa_to_arrays

    options = parse_arguments(arguments=["alignment", tmp_dir, bam, genome])
    _header, table, soa, twins = collect_soa_from_bam(bam, options)
    geno = {"ref_id": np.asarray(table.ref_id, np.int32),
            "ref_start": np.asarray(table.ref_start, np.int64),
            "ref_end": np.asarray(table.ref_end, np.int64),
            "mapq": np.asarray(table.mapq, np.int32),
            "flag": np.zeros(len(table.ref_id), np.int32),
            "names": list(table.names)}
    soa_bytes = len(arrays_to_bytes(soa_to_arrays(soa, twins, geno)))
    pickled = pickle.dumps({"sigs": soa.materialize_all(), "twins": twins,
                            "columns": geno}, protocol=4)
    return soa_bytes, len(pickled)


def main():
    os.environ["SVIM_BENCH_READS"] = str(N_READS)
    import bench

    tmp_dir = tempfile.mkdtemp(prefix="svim_scale_")
    # SVIM_SCALE_WORKLOAD_DIR reuses a pre-generated bench workload
    reuse = os.environ.get("SVIM_SCALE_WORKLOAD_DIR")
    if reuse and os.path.exists(os.path.join(reuse, "bench.bam")):
        bam = os.path.join(reuse, "bench.bam")
        genome = os.path.join(reuse, "genome.fa")
    else:
        bam, genome = bench.make_workload(reuse or tmp_dir)
    soa_bytes, pickle_bytes = _payload_sizes(bam, genome, tmp_dir)

    base_env = dict(os.environ)
    base_env.update({"JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO_ROOT})
    common = ["--device_backend", "cpu", "--profile", "--skip_genotyping"]

    # warm passes populate the persistent jit cache so neither timed run
    # pays cold compiles (and the 2-proc ranks stay inside Gloo's timeout).
    # The distributed warm matters separately: rank batch shapes differ
    # from the single-process ones, so a timed FIRST distributed run would
    # charge scaling with one-time compiles.  Pinned mode warms under the
    # same affinities as the timed runs.
    subprocess.run(_pin(SINGLE_CORES)
                   + [sys.executable, "-m", "svim_tpu", "alignment",
                      os.path.join(tmp_dir, "wd_warm"), bam, genome] + common,
                   env=base_env, capture_output=True, timeout=1800)
    warm_coord = "127.0.0.1:{0}".format(_free_port())
    warm_ranks = []
    for rank in range(2):
        env = dict(base_env)
        env.update({"SVIM_COORDINATOR": warm_coord,
                    "SVIM_NUM_PROCESSES": "2",
                    "SVIM_PROCESS_ID": str(rank)})
        warm_ranks.append(subprocess.Popen(
            _pin(RANK_CORES[rank % len(RANK_CORES)])
            + [sys.executable, "-m", "svim_tpu", "alignment",
               os.path.join(tmp_dir, "wd_warm_multi"), bam, genome,
               "--distributed"] + common,
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
    for proc in warm_ranks:
        proc.wait(timeout=1800)

    t0 = time.perf_counter()
    single = subprocess.run(
        _pin(SINGLE_CORES)
        + [sys.executable, "-m", "svim_tpu", "alignment",
           os.path.join(tmp_dir, "wd_single"), bam, genome] + common,
        env=base_env, capture_output=True, text=True, timeout=1800)
    single_s = time.perf_counter() - t0
    assert single.returncode == 0, single.stdout + single.stderr
    single_stages = _stage_seconds(single.stdout + single.stderr)

    coordinator = "127.0.0.1:{0}".format(_free_port())
    ranks = []
    t0 = time.perf_counter()
    for rank in range(2):
        env = dict(base_env)
        env.update({"SVIM_COORDINATOR": coordinator,
                    "SVIM_NUM_PROCESSES": "2",
                    "SVIM_PROCESS_ID": str(rank)})
        ranks.append(subprocess.Popen(
            _pin(RANK_CORES[rank % len(RANK_CORES)])
            + [sys.executable, "-m", "svim_tpu", "alignment",
               os.path.join(tmp_dir, "wd_multi"), bam, genome,
               "--distributed"] + common,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outputs = [proc.communicate(timeout=1800)[0] for proc in ranks]
    two_proc_s = time.perf_counter() - t0
    for rank, proc in enumerate(ranks):
        assert proc.returncode == 0, "rank {0}:\n{1}".format(
            rank, outputs[rank][-4000:])
    multi_stages = _stage_seconds(outputs[0])
    sent, _received, rounds = _exchange_stats(outputs[0])

    single_cc = (single_stages.get("collect", 0.0)
                 + single_stages.get("cluster", 0.0))
    multi_cc = (multi_stages.get("collect", 0.0)
                + multi_stages.get("cluster", 0.0))
    result = {
        "single_s": round(single_s, 2),
        "two_proc_s": round(two_proc_s, 2),
        "efficiency": round(single_s / (2 * two_proc_s), 3),
        "collect_cluster_single_s": round(single_cc, 2),
        "collect_cluster_two_proc_s": round(multi_cc, 2),
        "collect_cluster_efficiency": round(
            single_cc / (2 * multi_cc), 3) if multi_cc else None,
        "exchange_sent_bytes": sent,
        "exchange_rounds": rounds,
        "payload_soa_bytes": soa_bytes,
        "payload_pickle_bytes_round3_design": pickle_bytes,
        "n_reads": N_READS,
        "pinned": PINNED,
        "caveat": ("single rank pinned to cores {0}; ranks pinned to "
                   "disjoint sets {1} — like-for-like per-rank core budget "
                   "standing in for two 2-core hosts".format(
                       SINGLE_CORES, ";".join(RANK_CORES)) if PINNED else
                   "both ranks share this box's 4 cores: host-bound stages "
                   "contend, so this lower-bounds true 2-host efficiency"),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
