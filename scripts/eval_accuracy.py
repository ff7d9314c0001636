#!/usr/bin/env python3
"""Accuracy evaluation: simulate all six SV classes, run the pipeline,
report per-class precision/recall/F1 vs the simulated truth
(BASELINE config 2 shape).

Usage: python scripts/eval_accuracy.py [seed] [--big | --independent]

--independent runs the INDEPENDENT donor-genome harness (svim_tpu/sim2.py):
SVs applied to a donor haplotype, reads sampled from both strands and both
haplotypes, alignments derived by projection — a different generator family
from sim.py (VERDICT r3 #6), including the DUP_TAN-vs-INS representation
ambiguity whose surviving INS records are documented precision cost.

--big runs the large-scale stress harness: 54 Mb over five contigs, 15%
of each contig under repeat arrays, 12% per-base read noise, ~215 SV
loci across all six classes including cut&paste DUP:INT (whose origin
deletion must flag the candidate CUTPASTE to count as a match).
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import logging

    logging.disable(logging.INFO)
    from svim_tpu.cli import main as run_cli
    from svim_tpu.sim import SimConfig, evaluate_vcf, f1, simulate

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    big = "--big" in sys.argv[1:]
    independent = "--independent" in sys.argv[1:]
    seed = int(args[0]) if args else 1
    if independent:
        from svim_tpu.sim2 import Sim2Config, simulate_independent

        out_dir = tempfile.mkdtemp(prefix="svim_eval2_")
        start = time.time()
        genome_path, bam_path, truth = simulate_independent(
            out_dir, Sim2Config(seed=seed))
        sim_seconds = time.time() - start
        workdir = os.path.join(out_dir, "wd")
        start = time.time()
        assert run_cli(["alignment", workdir, bam_path, genome_path]) == 0
        print(json.dumps({"harness": "independent (donor-genome projection)",
                          "truth_records": len(truth),
                          "sim_s": round(sim_seconds, 1),
                          "pipeline_s": round(time.time() - start, 1)}))
        results = evaluate_vcf(os.path.join(workdir, "variants.vcf"), truth)
        for svtype, (tp, fp, fn) in sorted(results.items()):
            print(json.dumps({"svtype": svtype, "tp": tp, "fp": fp, "fn": fn,
                              "f1": round(f1(tp, fp, fn), 3)}))
        return
    if big:
        config = SimConfig(
            seed=seed, genome_length=18_000_000,
            second_contig_length=4_000_000,
            extra_contigs=(14_000_000, 10_000_000, 8_000_000),
            coverage=8, n_del=50, n_ins=50, n_inv=35, n_tan=35,
            n_dup_int=15, n_dup_int_cutpaste=10, n_bnd=20,
            n_background=2500, error_rate=0.12, repeat_fraction=0.15)
    else:
        config = SimConfig(seed=seed)
    out_dir = tempfile.mkdtemp(prefix="svim_eval_")
    start = time.time()
    genome_path, bam_path, truth = simulate(out_dir, config)
    sim_seconds = time.time() - start
    workdir = os.path.join(out_dir, "wd")
    start = time.time()
    assert run_cli(["alignment", workdir, bam_path, genome_path]) == 0
    if big:
        genome_mb = (config.genome_length + config.second_contig_length
                     + sum(config.extra_contigs)) / 1e6
        print(json.dumps({
            "harness": "big", "genome_mb": genome_mb,
            "contigs": 2 + len(config.extra_contigs),
            "truth_records": len(truth),
            "error_rate": config.error_rate,
            "repeat_fraction": config.repeat_fraction,
            "sim_s": round(sim_seconds, 1),
            "pipeline_s": round(time.time() - start, 1)}))

    results = evaluate_vcf(os.path.join(workdir, "variants.vcf"), truth)
    for svtype, (tp, fp, fn) in sorted(results.items()):
        print(json.dumps({"svtype": svtype, "tp": tp, "fp": fp, "fn": fn,
                          "f1": round(f1(tp, fp, fn), 3)}))


if __name__ == "__main__":
    main()
