"""Multi-chip execution: the production pipeline steps over a device mesh.

Scaling recipe (per BASELINE north star): sorted read batches shard
data-parallel over the 'data' mesh axis; each shard scans its CIGARs locally
(the same fused kernel as the single-chip path); per-shard signature events
are compacted into fixed-size tables and all-gathered over the mesh, together
with the TRUE per-shard event counts so the host can detect overflow and
re-run with a larger table (no silent truncation); per-locus depth counts
are psum-reduced for genotyping.

Shard-boundary reconciliation: the reference's partitioning is a GLOBAL
gap-cut scan over sorted signatures (SVIM_clustering.py:17-29), so
partitions may straddle shard edges.  The design here is merge-then-cut:
COLLECT is per-read independent (embarrassingly parallel), the event tables
are all-gathered in global row order BEFORE the host forms partitions, and
clustering then shards over whole partitions (batch axis) — so the gap-cut
always sees the serial order and boundary partitions are never split.
tests/test_parallel.py asserts full-pipeline VCF byte-parity between
num_shards=1 and 8 on inputs whose partitions straddle shard edges.

The clustering and genotyping kernels shard through jit + NamedSharding on
their batch axes (GSPMD inserts the collectives); the COLLECT step below is
an explicit shard_map so the all_gather/psum structure is visible and
portable to multi-host meshes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from svim_tpu.ops.cigar_kernel import cigar_indel_scan

EVENTS_PER_SHARD = 128  # default per-shard event table (grown on overflow)


def make_mesh(n_devices: int = None) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), axis_names=("data",))


def put_global(mesh: Mesh, spec, array):
    """Place a host array (identical on every process) onto a mesh sharding.

    jax.device_put cannot target non-addressable devices, so multi-process
    meshes go through make_array_from_callback: each process materializes
    only the shards its local devices own."""
    array = np.asarray(array)
    sharding = NamedSharding(mesh, spec)
    if all(d.process_index == jax.process_index() for d in mesh.devices.flat):
        return jax.device_put(array, sharding)
    return jax.make_array_from_callback(array.shape, sharding,
                                        lambda index: array[index])


def fetch_replicated(*arrays):
    """device_get that works for cross-process sharded outputs: reshard each
    array to fully-replicated (an all_gather) before fetching."""
    out = []
    for array in arrays:
        sharding = getattr(array, "sharding", None)
        if (sharding is not None and hasattr(array, "is_fully_addressable")
                and not array.is_fully_addressable):
            mesh = sharding.mesh
            array = jax.jit(lambda x: x,
                            out_shardings=NamedSharding(mesh, P()))(array)
        out.append(np.asarray(jax.device_get(array)))
    return out if len(out) > 1 else out[0]


def shard_batch(num_shards: int, *arrays):
    """Lay batch-leading arrays out over a 'data' mesh (leading axis sharded)
    so jit/GSPMD splits the batched kernels across devices.  Falls back to
    the unsharded arrays when the mesh or divisibility is unavailable."""
    if num_shards <= 1:
        return arrays if len(arrays) > 1 else arrays[0]
    devices = jax.devices()
    if len(devices) < num_shards or arrays[0].shape[0] % num_shards != 0:
        return arrays if len(arrays) > 1 else arrays[0]
    mesh = make_mesh(num_shards)
    out = tuple(
        put_global(mesh, P(*(("data",) + (None,) * (array.ndim - 1))), array)
        for array in arrays)
    return out if len(out) > 1 else out[0]


def _local_collect(cigar_words, ref_start, min_sv_size, events_per_shard):
    """Per-shard COLLECT: scan CIGARs, compact indel events into a fixed-size
    local table.  Returns (start, length, is_ins, local_row, true_count);
    entries past the table size are lost HERE but the true count travels with
    the table so the caller re-runs with a larger bound."""
    cigar_words = cigar_words.astype(jnp.int32)
    cigar_lens = cigar_words >> 4
    del_mask, ins_mask, pos_ref, _pos_read = cigar_indel_scan(
        cigar_words, min_sv_size)
    k = cigar_words.shape[1]
    event = (del_mask | ins_mask).ravel()
    count = jnp.sum(event, dtype=jnp.int32)
    (flat_idx,) = jnp.nonzero(event, size=events_per_shard, fill_value=-1)
    present = flat_idx >= 0
    rows = jnp.maximum(flat_idx, 0) // k
    cols = jnp.maximum(flat_idx, 0) % k
    start = ref_start[rows] + pos_ref[rows, cols]
    length = cigar_lens[rows, cols]
    is_ins = ins_mask[rows, cols]
    return (jnp.where(present, start, -1),
            jnp.where(present, length, 0),
            jnp.where(present, is_ins, False),
            jnp.where(present, rows, -1),
            count)


def build_pipeline_step(mesh: Mesh, min_sv_size: int = 40,
                        events_per_shard: int = EVENTS_PER_SHARD):
    """The jitted sharded COLLECT + merge + depth step.

    Inputs (global shapes, sharded over 'data' on the leading axis):
      cigar_words (N, K) int32 (raw BAM encoding), ref_start (N,) int32,
      ref_end (N,) int32, loci (L, 2) int32 (replicated genotyping windows).

    Returns (replicated):
      starts, lengths, is_ins, rows: (n_shards * events_per_shard,) gathered
        event tables in global row order (rows are GLOBAL row indices);
      counts: (n_shards,) TRUE per-shard event counts — if any exceeds
        events_per_shard the tables are incomplete and the caller must
        re-run with a larger bound (run_collect_step does this);
      depth: (L,) psum-reduced alignment depth per locus.
    """

    def step(cigar_words, ref_start, ref_end, loci):
        starts, lengths, is_ins, rows, count = _local_collect(
            cigar_words, ref_start, min_sv_size, events_per_shard)
        rows_per_shard = cigar_words.shape[0]
        shard = jax.lax.axis_index("data")
        global_rows = jnp.where(rows >= 0, rows + shard * rows_per_shard, -1)

        # merge per-shard signature tables across the mesh;
        # shard-major tiling preserves global row order (shards are
        # contiguous row blocks of the sorted input)
        all_starts = jax.lax.all_gather(starts, "data", tiled=True)
        all_lengths = jax.lax.all_gather(lengths, "data", tiled=True)
        all_is_ins = jax.lax.all_gather(is_ins, "data", tiled=True)
        all_rows = jax.lax.all_gather(global_rows, "data", tiled=True)
        counts = jax.lax.all_gather(count, "data")

        # genotyping depth: local interval-overlap counts, psum over the mesh
        locus_start = loci[:, 0]
        locus_end = loci[:, 1]
        overlaps = ((ref_start[None, :] < locus_end[:, None])
                    & (ref_end[None, :] > locus_start[:, None]))
        local_depth = jnp.sum(overlaps, axis=1, dtype=jnp.int32)
        depth = jax.lax.psum(local_depth, "data")
        return all_starts, all_lengths, all_is_ins, all_rows, counts, depth

    data = P("data")
    replicated = P()
    return jax.jit(jax.shard_map(
        step, mesh=mesh,
        in_specs=(P("data", None), data, data, replicated),
        out_specs=(replicated, replicated, replicated, replicated,
                   replicated, replicated),
        check_vma=False))


def _round_up_pow2(value: int, floor: int = EVENTS_PER_SHARD) -> int:
    result = floor
    while result < value:
        result *= 2
    return result


_step_cache = {}


def run_collect_step(mesh: Mesh, cigar_words, ref_start, ref_end, loci,
                     min_sv_size: int = 40,
                     events_per_shard: int = EVENTS_PER_SHARD):
    """Run the sharded COLLECT step, growing the per-shard event tables until
    no shard overflows (the overflow check reads the gathered TRUE counts, so
    events are never silently dropped).

    Returns (starts, lengths, is_ins, rows, depth) as numpy arrays with the
    event tables compacted to real entries in global row order."""
    n_shards = mesh.devices.size
    rows_total = cigar_words.shape[0]
    if rows_total % n_shards != 0:
        raise ValueError("rows ({0}) must divide over {1} shards — pad the "
                         "batch first".format(rows_total, n_shards))
    # multi-process meshes need explicit global-array placement (every
    # process passes the same host arrays; each materializes its shards)
    multiprocess = any(d.process_index != jax.process_index()
                       for d in mesh.devices.flat)
    if multiprocess:
        data = P("data")
        cigar_words = put_global(mesh, P("data", None), cigar_words)
        ref_start = put_global(mesh, data, ref_start)
        ref_end = put_global(mesh, data, ref_end)
        loci = put_global(mesh, P(), loci)
    while True:
        key = (id(mesh), min_sv_size, events_per_shard)
        step = _step_cache.get(key)
        if step is None:
            step = build_pipeline_step(mesh, min_sv_size, events_per_shard)
            _step_cache.clear()
            _step_cache[key] = step
        starts, lengths, is_ins, rows, counts, depth = jax.device_get(
            step(cigar_words, ref_start, ref_end, loci))
        max_count = int(counts.max())
        if max_count <= events_per_shard:
            break
        events_per_shard = _round_up_pow2(max_count, floor=events_per_shard * 2)
    keep = rows >= 0
    return (starts[keep], lengths[keep], is_ins[keep], rows[keep],
            np.asarray(depth))
