#!/usr/bin/env python3
"""Weak-scaling measurement of the sharded pipeline step on a virtual device
mesh (xla_force_host_platform_device_count).  Fixed per-device read load.

CAVEAT: virtual CPU devices share one host's cores, so wall time necessarily
grows with device count here — the meaningful signal is the aggregate
throughput ratio (total reads / time, relative to 1 device): values ~>=1 mean
the collectives add no serial bottleneck, and on real multi-chip hardware
(each device its own silicon) the same program's weak-scaling time stays
flat.  The program is identical to what drives real cards
(`python chip_smoke.py --chips 4` runs the multi-card pipeline on them).

Usage: python scripts/bench_scaling.py
"""

import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from svim_tpu.parallel.mesh import build_pipeline_step, make_mesh  # noqa: E402

READS_PER_DEVICE = 512
K = 4096


def workload(n_devices, rng):
    n = READS_PER_DEVICE * n_devices
    ops = rng.integers(0, 3, size=(n, K), dtype=np.int32)
    lens = rng.integers(1, 60, size=(n, K), dtype=np.int32)
    words = (lens << 4) | ops
    ref_start = rng.integers(0, 50_000_000, size=(n,), dtype=np.int32)
    ref_end = ref_start + 20_000
    loci = np.stack([np.arange(64, dtype=np.int32) * 1_000_000,
                     np.arange(64, dtype=np.int32) * 1_000_000 + 5_000], axis=1)
    return words, ref_start, ref_end, loci


def main():
    rng = np.random.default_rng(0)
    results = []
    base_time = None
    for n_devices in (1, 2, 4, 8):
        mesh = make_mesh(n_devices)
        step = build_pipeline_step(mesh)
        args = workload(n_devices, rng)
        jax.block_until_ready(step(*args))  # compile + warm
        best = min(_timed(step, args) for _ in range(3))
        if base_time is None:
            base_time = best
        throughput_ratio = (base_time * n_devices) / best
        results.append({"devices": n_devices,
                        "reads": READS_PER_DEVICE * n_devices,
                        "seconds": round(best, 4),
                        "aggregate_throughput_ratio": round(throughput_ratio, 3)})
        print(json.dumps(results[-1]))
    return results


def _timed(step, args):
    t0 = time.perf_counter()
    jax.block_until_ready(step(*args))
    return time.perf_counter() - t0


if __name__ == "__main__":
    main()
