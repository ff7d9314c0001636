#!/usr/bin/env python3
"""Streaming vs one-shot COLLECT on the bench workload, stage-timed.

Answers: where does collect_streaming spend its wall time at bench scale,
and does the one-shot path beat it now that scan_bam is steady?"""
import json
import logging
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
logging.disable(logging.INFO)

import bench
from svim_tpu.config import parse_arguments
from svim_tpu.utils.device import setup_jax_cache


def main():
    setup_jax_cache()
    tmp_dir = tempfile.mkdtemp(prefix="svim_profile_sv1_")
    bam_path, genome_path = bench.make_workload(tmp_dir)
    options = parse_arguments(arguments=["alignment", tmp_dir, bam_path,
                                         genome_path])

    import jax
    print("platform:", jax.devices()[0].platform, flush=True)

    from svim_tpu.io.bamstream import collect_streaming, stream_bam, _prefetch
    from svim_tpu.io.bamscan import scan_bam
    from svim_tpu.collect.packed import (
        dispatch_collect_scan,
        finish_collect_scan,
        signatures_from_packed,
    )
    from svim_tpu.cluster import cluster_sv_signatures

    # warm compiles
    collect_streaming(bam_path, options)

    for _round in range(3):
        t = {}
        # host-only stream drain (prefetch thread + row building, no device)
        t0 = time.perf_counter()
        stream = stream_bam(bam_path, options.min_mapq, options.batch_reads,
                            min_sv_size=options.min_sv_size)
        next(stream)
        n_batches = 0
        for _batch in stream:
            n_batches += 1
        t["stream_host_only"] = time.perf_counter() - t0
        t["n_batches"] = n_batches

        t0 = time.perf_counter()
        _h, _table, sigs, _tw = collect_streaming(bam_path, options)
        t["collect_streaming"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        header2, packed, sa_tags = scan_bam(bam_path, options.min_mapq,
                                            options.min_sv_size)
        t["oneshot_scan"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dispatched = dispatch_collect_scan(packed, options)
        finish_collect_scan(packed, dispatched, options)
        t["oneshot_device"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sigs2, _tw2 = signatures_from_packed(packed, sa_tags, header2, options)
        t["oneshot_materialize"] = time.perf_counter() - t0
        t["sig_parity"] = len(sigs) == len(sigs2)

        t0 = time.perf_counter()
        cluster_sv_signatures(sigs, options)
        t["cluster"] = time.perf_counter() - t0
        print(json.dumps({k: (round(v, 3) if isinstance(v, float) else v)
                          for k, v in t.items()}), flush=True)


if __name__ == "__main__":
    main()
