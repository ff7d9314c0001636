#!/usr/bin/env python3
"""Stage breakdown of the bench array path on JAX's default device (set
JAX_PLATFORMS=cpu to profile host XLA)."""
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
    tmp_dir = tempfile.mkdtemp(prefix="svim_profile_")
    bam_path, genome_path = bench.make_workload(tmp_dir)
    options = parse_arguments(arguments=["alignment", tmp_dir, bam_path, genome_path])

    import jax
    print("platform:", jax.devices()[0].platform, flush=True)

    from svim_tpu.io.bamscan import scan_bam
    from svim_tpu.collect.packed import signatures_from_packed, dispatch_collect_scan, finish_collect_scan
    from svim_tpu.cluster import cluster_sv_signatures

    for round_no in range(3):
        t = {}
        t0 = time.perf_counter()
        header2, packed, sa_tags = scan_bam(bam_path, options.min_mapq,
                                           options.min_sv_size)
        t["scan_pack"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        dispatched = dispatch_collect_scan(packed, options)
        t["dispatch"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        events = finish_collect_scan(packed, dispatched, options)
        t["device_collect_wait"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        sigs, twins = signatures_from_packed(packed, sa_tags, header2, options)
        t["materialize+classify"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        cluster_sv_signatures(sigs, options)
        t["cluster_total_overlapped"] = round(time.perf_counter() - t0, 3)

        by_type = {}
        from svim_tpu.cluster.cluster import partition_and_cluster
        groups = {k: [] for k in ("DEL","INS","INV","DUP_TAN","BND","DUP_INT")}
        for s in sigs:
            groups[s.type].append(s)
        names = {"DEL":"deleted regions","INS":"inserted regions","INV":"inverted regions",
                 "DUP_TAN":"tandem duplicated regions",
                 "DUP_INT":"inserted regions with detected region of origin",
                 "BND":"translocation breakpoints"}
        for k, lst in groups.items():
            t0 = time.perf_counter()
            partition_and_cluster(lst, options, names[k])
            by_type[k] = round(time.perf_counter() - t0, 3)
        t["cluster_by_type"] = by_type
        t["n_sigs"] = len(sigs)
        print(json.dumps({k: (round(v,3) if isinstance(v,float) else v) for k,v in t.items()}), flush=True)


if __name__ == "__main__":
    main()
