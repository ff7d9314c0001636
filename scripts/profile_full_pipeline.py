#!/usr/bin/env python3
"""Stage breakdown of the COMPLETE pipeline (COLLECT .. GENOTYPE + writers +
plots) on the bench workload — the costs the COLLECT+CLUSTER headline never
sees (consensus DP, plots, VCF emit).

Runs the CLI three times in one process: run 0 pays jit compiles and the
first inflate-buffer allocation; run 2 is the honest warm number.  Runs on
JAX's default device (set JAX_PLATFORMS=cpu to profile host XLA).
"""

import gc
import logging
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


def main():
    tmp_dir = tempfile.mkdtemp(prefix="svim_fullprof_")
    bam_path, genome_path = bench.make_workload(tmp_dir)

    import svim_tpu.cli as cli

    logging.disable(logging.INFO)
    for run in range(3):
        gc.collect()  # free prior runs' cycles so the inflate pool recycles
        workdir = os.path.join(tmp_dir, "wd{0}".format(run))
        t0 = time.perf_counter()
        cli.main(["alignment", workdir, bam_path, genome_path])
        label = ("cold (compiles + first alloc)", "second", "warm")[run]
        print("run {0} [{1}]: {2:.2f} s".format(
            run, label, time.perf_counter() - t0), flush=True)


if __name__ == "__main__":
    main()
