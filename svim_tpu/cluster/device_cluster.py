"""Device clustering: batched on-device agglomeration with exact host parity.

The default CLUSTER backend.  Partitions of 3..128 signatures are batched
into padded arrays and agglomerated on device (ops.linkage_kernel); the host
reconstructs a scipy-format Z from each returned merge sequence and calls
scipy's fcluster on it, which reproduces the reference's flat-cluster
numbering (and therefore cluster ORDER) exactly — see ops/linkage_kernel.py.

Exactness: the device computes in float32 while the reference (scipy) uses
float64.  Every comparison the dendrogram depends on is guarded: the kernel
reports the minimum relative gap between the best and second-best pair over
all merge steps, near-threshold dedup comparisons, and surviving same-read
walls; any partition where float32 could arbitrate differently than float64
returns None and the caller re-runs it on the exact host path
(cluster/cluster.py).  On tie-free data no fallback occurs and results are
bit-identical to the reference (scipy linkage+fcluster over float64 —
SVIM_clustering.py:159-171).

Three routes:
  * fused (DEL / INV / DUP_TAN / DUP_INT / BND): the exact float64 matrix
    is ALSO built on host at dispatch time (it is a cheap vectorized
    expression of integer columns) so same-read dedup
    (SVIM_clustering.py:145-151) and the tie/wall arbitration run exactly
    before any dispatch; partitions float32 could mis-order resolve on host
    immediately (no round trip), and only provably-orderable partitions
    ship — as coordinates, with matrix build + agglomeration in one
    batched device call.
  * matrix (INS default, and the DUP_INT candidate round): the exact
    float64 matrix is built on host (cluster/accel.py — edit distances,
    destination terms, direction walls), dedup happens on host in float64,
    and the device performs the agglomeration.  Partitions whose surviving
    matrix contains a 99999 wall (same-read survivors, BND direction
    mismatches) fall back to host.
  * resident (INS with --edit_backend wavefront): haplotype edit distances
    compute on device (wavefront kernel) and feed the on-device matrix
    assembly + agglomeration without visiting the host
    (dispatch_ins_resident) — all six types then run coordinates-in /
    merges-out on the device.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
from svim_tpu.cluster.scipy_fast import average_linkage, fcluster_distance

from svim_tpu.cluster import accel
from svim_tpu.cluster.distance import SAME_READ_WALL
from svim_tpu.ops.linkage_kernel import (
    KIND_BND,
    KIND_DUP_INT,
    KIND_SPAN_POSITION,
    MERGE_CUTOFF,
    TIE_EPS,
    agglomerate_batched,
    span_position_agglomerate_batched,
)

_FUSED_KIND = {"DEL": KIND_SPAN_POSITION, "INV": KIND_SPAN_POSITION,
               "DUP_TAN": KIND_SPAN_POSITION, "DUP_INT": KIND_DUP_INT,
               "BND": KIND_BND}

# coordinate (fused) route: the device rebuilds the distance matrix from
# int32 columns and agglomerates — DUP_INT adds a destination term, BND uses
# the /3000 formula.  NOTE the host ALSO builds the exact f64 matrix for
# every partition at dispatch time (cheap vectorized numpy at n<=128): exact
# dedup, wall detection, and the f32-tie pre-check all need it, and partitions
# it disqualifies skip the kernel round trip entirely instead of bouncing
# back flagged ambiguous (see _dispatch_fused).  Only coordinates ship to the
# device; the host matrix is reused verbatim by any fallback.  INS
# defaults to the matrix route: its distances embed exact edit distances
# computed by the native host batch (cluster/edit_distance.py), so the f64
# matrix already exists on host and only the agglomeration ships.
# `--edit_backend wavefront` opts INS into the fully device-resident route
# instead (dispatch_ins_resident: on-device eds -> on-device matrices ->
# agglomeration, one batched fetch).
FUSED_TYPES = ("DEL", "INV", "DUP_TAN", "DUP_INT", "BND")
MATRIX_TYPES = ("INS",)
DEVICE_TYPES = FUSED_TYPES + MATRIX_TYPES
PARTITION_BUCKETS = (32, 128)


class FallbackTelemetry:
    """Counts where device-eligible partitions were resolved (VERDICT r2:
    the silent-degradation risk of the exact-scipy fallback).

    device: agglomerated on device, labels accepted.
    pre_tie / pre_wall: exact f64 ties / surviving 99999 walls detected at
        dispatch time -> resolved on host over the already-built matrix
        WITHOUT paying a device round trip.  Exact ties are intrinsic to
        deep-coverage data (integer breakpoint jitter collides); scipy's
        nn-chain tie-breaking decides them and no finite-precision kernel
        can replicate that, so these are data properties, not degradation.
    post_tie / post_wall: the kernel ran but f32 could not arbitrate
        (min_gap under TIE_EPS, dedup ambiguity, near-threshold heights) —
        these WASTE a dispatch+fetch round trip and re-run on host; the
        regression bound pins this fraction near zero.
    resident_relink: resident-INS partitions whose LABELING the f32 guard
        rejected; the expensive device work (the wavefront edit distances)
        is REUSED by the exact host re-linkage, so unlike post_tie only the
        cheap O(n^3 | n<=100) linkage re-runs.  Near-tied merge heights are
        intrinsic to deep INS coverage (near-identical haplotypes), so this
        counts separately from wasted dispatches.
    """

    __slots__ = ("device", "pre_tie", "pre_wall", "post_tie", "post_wall",
                 "resident_relink")

    def __init__(self):
        self.reset()

    def reset(self):
        self.device = 0
        self.pre_tie = 0
        self.pre_wall = 0
        self.post_tie = 0
        self.post_wall = 0
        self.resident_relink = 0

    @property
    def eligible(self):
        return (self.device + self.pre_tie + self.pre_wall
                + self.post_tie + self.post_wall + self.resident_relink)

    @property
    def fallback_fraction(self):
        total = self.eligible
        host = total - self.device - self.resident_relink
        return host / total if total else 0.0

    @property
    def wasted_fraction(self):
        """Partitions that paid a device round trip and then re-ran on host."""
        total = self.eligible
        return (self.post_tie + self.post_wall) / total if total else 0.0

    def as_dict(self):
        return {"device": self.device, "pre_tie": self.pre_tie,
                "pre_wall": self.pre_wall, "post_tie": self.post_tie,
                "post_wall": self.post_wall,
                "resident_relink": self.resident_relink,
                "fallback_fraction": round(self.fallback_fraction, 4),
                "wasted_fraction": round(self.wasted_fraction, 4)}

    def log_summary(self):
        import logging
        total = self.eligible
        if not total:
            return
        logging.info(
            "Device clustering: {0}/{1} eligible partitions agglomerated on "
            "device; {2} resolved by exact host linkage at dispatch "
            "({3} f64 ties, {4} walls — no device cost); {5} re-linked on "
            "host over device-computed edit distances (near-tied heights); "
            "{6} wasted a device round trip on f32 ambiguity ({7:.2%}).".format(
                self.device, total, self.pre_tie + self.pre_wall,
                self.pre_tie, self.pre_wall, self.resident_relink,
                self.post_tie + self.post_wall, self.wasted_fraction))


TELEMETRY = FallbackTelemetry()


def _bucket(n: int) -> int:
    for bucket in PARTITION_BUCKETS:
        if n <= bucket:
            return bucket
    raise ValueError("partition of {0} exceeds the device pad".format(n))


def _round_up_pow2(value: int, floor: int = 8) -> int:
    result = floor
    while result < value:
        result *= 2
    return result


def z_from_merges(merge_lo, merge_hi, heights, n_survivors: int,
                  threshold: float, slot_rank=None) -> Optional[np.ndarray]:
    """Reconstruct scipy's linkage matrix Z from a kernel merge sequence.
    `slot_rank` maps kernel slot indices to survivor ranks (identity when
    the matrix was pre-compacted).  Returns None when a merge height sits
    too close to the cut threshold for float32 to arbitrate (caller falls
    back to host) or the sequence is incomplete."""
    m = n_survivors
    ids = {}
    sizes = {}
    z = np.zeros((m - 1, 4), dtype=np.float64)
    rows = 0
    for k in range(len(heights)):
        height = float(heights[k])
        if height >= MERGE_CUTOFF:
            break
        if abs(height - threshold) < TIE_EPS * max(height, 1.0):
            return None
        a = int(merge_lo[k])
        b = int(merge_hi[k])
        id_a = ids.get(a, slot_rank[a] if slot_rank is not None else a)
        id_b = ids.get(b, slot_rank[b] if slot_rank is not None else b)
        size_a = sizes.get(a, 1)
        size_b = sizes.get(b, 1)
        z[rows, 0] = min(id_a, id_b)
        z[rows, 1] = max(id_a, id_b)
        z[rows, 2] = height
        z[rows, 3] = size_a + size_b
        ids[a] = m + rows
        sizes[a] = size_a + size_b
        rows += 1
    if rows != m - 1:
        return None
    return z


def labels_from_merges(merge_lo, merge_hi, heights, n_survivors: int,
                       threshold: float,
                       slot_rank=None) -> Optional[np.ndarray]:
    """Cut the Z rebuilt from a kernel merge sequence (z_from_merges) with
    scipy's fcluster — identical flat-cluster numbering to the host path.
    Returns None where z_from_merges does (caller falls back to host)."""
    if n_survivors == 1:
        return np.ones(1, dtype=np.int64)
    z = z_from_merges(merge_lo, merge_hi, heights, n_survivors, threshold,
                      slot_rank)
    if z is None:
        return None
    return fcluster_distance(z, threshold)


def _group_survivors(survivors, labels):
    """Group surviving elements by fcluster label (same regrouping as the
    host path's _group_by_labels).  Table views group by index — member
    order within each group is ascending position, identical to the append
    order of the object path."""
    if getattr(survivors, "table", None) is not None:
        labels = np.asarray(labels)
        return [survivors.take(np.flatnonzero(labels == label))
                for label in range(1, int(labels.max()) + 1)]
    groups = [[] for _ in range(int(max(labels)))]
    for element, label in zip(survivors, labels):
        groups[int(label) - 1].append(element)
    return groups


class DeviceClusterResult:
    """Per-partition outcome of a batched device pass."""

    __slots__ = ("clusters", "dropped_count")

    def __init__(self, clusters, dropped_count):
        self.clusters = clusters          # list of clusters, or None => fallback
        self.dropped_count = dropped_count


class DeviceBatcher:
    """Cross-type accumulator for the CLUSTER stage's device work.

    Every type's eligible partitions register here (fused route: coordinate
    rows with a per-row wall flag; matrix route: prebuilt float64 matrices);
    flush() dispatches ONE kernel invocation per (route, pad bucket) for the
    WHOLE stage, and device_outputs() exposes the output trees so a driver
    can pull every result in a single jax.device_get.  Each kernel call
    costs a transfer, a dispatch and its own jit shape variant, so
    collapsing per-type calls into shared batches turns ~10 calls into
    ~2."""

    __slots__ = ("options", "fused_rows", "matrix_rows", "outputs",
                 "fused_flushed", "extra_outputs")

    def __init__(self, options):
        self.options = options
        self.fused_rows = {}    # pad -> [(starts, ends, reads, valid, wall)]
        self.matrix_rows = {}   # pad -> [float64 matrix]
        self.outputs = None
        self.fused_flushed = False
        self.extra_outputs = {}  # routes dispatched eagerly (INS resident)

    def add_fused(self, sample, wall_same_read: bool, element_type: str = "DEL"):
        assert not self.fused_flushed, \
            "fused buckets already dispatched; register fused types first"
        n = len(sample)
        pad = _bucket(n)
        starts = np.zeros(pad, dtype=np.int32)
        ends = np.zeros(pad, dtype=np.int32)
        dest = np.zeros(pad, dtype=np.int32)
        # distinct negative ids per padded slot would still compare equal
        # across rows of padding; keep padding invalid instead
        reads = np.full(pad, -1, dtype=np.int32)
        valid = np.zeros(pad, dtype=bool)
        sample_starts, sample_ends = accel._source_columns(sample)
        starts[:n] = sample_starts
        ends[:n] = sample_ends
        kind = _FUSED_KIND[element_type]
        if element_type in ("DUP_INT", "BND"):
            dest[:n] = accel._dest_start_column(sample)
        reads[:n] = accel.read_index_array(sample)
        valid[:n] = True
        rows = self.fused_rows.setdefault(pad, [])
        rows.append((starts, ends, dest, reads, valid, wall_same_read, kind))
        return ("fused", pad, len(rows) - 1)

    def add_matrix(self, matrix):
        pad = _bucket(matrix.shape[0])
        rows = self.matrix_rows.setdefault(pad, [])
        rows.append(matrix)
        return ("matrix", pad, len(rows) - 1)

    def flush_fused(self):
        """Dispatch the fused-route buckets accumulated so far (async).

        Called by the stage driver after the five coordinate types have
        registered and BEFORE the INS staging: the fused kernels then compute
        while the host runs the native INS edit-distance batch and matrix
        prep, instead of idling until one terminal flush."""
        if self.outputs is None:
            self.outputs = {}
        options = self.options
        num_shards = getattr(options, "num_shards", 1)
        outputs = self.outputs
        for pad, rows in sorted(self.fused_rows.items()):
            batch = _round_up_pow2(len(rows))
            starts = np.zeros((batch, pad), dtype=np.int32)
            ends = np.zeros((batch, pad), dtype=np.int32)
            dest = np.zeros((batch, pad), dtype=np.int32)
            reads = np.full((batch, pad), -1, dtype=np.int32)
            valid = np.zeros((batch, pad), dtype=bool)
            wall = np.zeros(batch, dtype=bool)
            kinds = np.zeros(batch, dtype=np.int32)
            for row, (row_starts, row_ends, row_dest, row_reads, row_valid,
                      row_wall, row_kind) in enumerate(rows):
                starts[row] = row_starts
                ends[row] = row_ends
                dest[row] = row_dest
                reads[row] = row_reads
                valid[row] = row_valid
                wall[row] = row_wall
                kinds[row] = row_kind
            arrays = (starts, ends, dest, reads, valid, wall, kinds)
            if num_shards > 1:
                # lay the partition batch out over the data mesh: GSPMD
                # splits the vmapped agglomeration across devices
                from svim_tpu.parallel.mesh import shard_batch
                arrays = shard_batch(num_shards, *arrays)
            starts, ends, dest, reads, valid, wall, kinds = arrays
            outputs[("fused", pad)] = span_position_agglomerate_batched(
                starts, ends, reads, valid,
                np.float32(options.position_distance_normalizer),
                np.float32(options.cluster_max_distance), wall,
                dest=dest, kind=kinds)
        self.fused_rows = {}
        self.fused_flushed = True

    def flush(self):
        """Dispatch every accumulated bucket (async; results not fetched)."""
        self.flush_fused()
        options = self.options
        num_shards = getattr(options, "num_shards", 1)
        outputs = self.outputs
        for pad, matrices_f64 in sorted(self.matrix_rows.items()):
            batch = _round_up_pow2(len(matrices_f64))
            matrices = np.full((batch, pad, pad), 3.0e38, dtype=np.float32)
            valid = np.zeros((batch, pad), dtype=bool)
            for row, matrix in enumerate(matrices_f64):
                n = matrix.shape[0]
                matrices[row, :n, :n] = matrix
                valid[row, :n] = True
            arrays = (matrices, valid)
            if num_shards > 1:
                from svim_tpu.parallel.mesh import shard_batch
                arrays = shard_batch(num_shards, *arrays)
            outputs[("matrix", pad)] = agglomerate_batched(*arrays)
        self.matrix_rows = {}

    def device_outputs(self):
        """{bucket key: output tree} — fetch with one jax.device_get."""
        self.flush()
        if self.extra_outputs:
            merged = dict(self.outputs)
            merged.update(self.extra_outputs)
            return merged
        return self.outputs


class PendingDeviceClusters:
    """Registered device agglomerations for one signature type.

    Registration and consumption are split so a driver can stage every
    type's work on one DeviceBatcher, flush once, fetch once, then consume
    each type from the shared fetched results."""

    __slots__ = ("samples", "threshold", "batcher", "fused", "matrix",
                 "resident", "ready")

    def __init__(self, samples, threshold, batcher):
        self.samples = samples
        self.threshold = threshold
        self.batcher = batcher
        self.fused = []    # (sample index, batcher handle)
        self.matrix = []   # (sample index, survivors, matrix, reads, dropped, handle)
        self.resident = []  # (index, sample, pairs_i, pairs_j, ed_slice, pad, row)
        self.ready = {}    # index -> DeviceClusterResult decided at dispatch


def _dispatch_fused(samples, element_type, reference, options, batcher):
    """DEL / INV / DUP_TAN: exact host arbitration + device agglomeration.

    The f64 distance matrix for these types is a cheap vectorized expression
    of integer columns, so dedup (SVIM_clustering.py:145-151) and the
    tie/wall arbitration run EXACTLY on host at dispatch time; only
    partitions the f32 kernel can provably order are dispatched.  Deep
    coverage ties pair distances exactly (integer jitter grids collide), and
    before this pre-check those partitions paid the kernel dispatch + fetch
    round trips only to come back flagged ambiguous, then rebuilt the matrix
    from scratch on the host path — twice the work of resolving them here."""
    wall_same_read = element_type != "INV"
    threshold = float(options.cluster_max_distance)
    pending = PendingDeviceClusters(samples, threshold, batcher)
    fallback = pending.ready
    for index, sample in enumerate(samples):
        matrix = accel.distance_matrix(sample, element_type, reference, options)
        reads = accel.read_index_array(sample)
        dropped_count = 0
        survivors = sample
        if wall_same_read:
            drop = accel.dedup_same_read(matrix, reads, threshold)
            dropped_count = len(drop)
            if drop:
                keep = [i for i in range(len(sample)) if i not in drop]
                if getattr(sample, "table", None) is not None:
                    survivors = sample.take(keep)
                else:
                    survivors = [sample[i] for i in keep]
                matrix = matrix[np.ix_(keep, keep)]
                reads = reads[keep]
        if len(survivors) == 1:
            if getattr(survivors, "table", None) is not None:
                fallback[index] = DeviceClusterResult([survivors], dropped_count)
            else:
                fallback[index] = DeviceClusterResult([[survivors[0]]],
                                                      dropped_count)
            continue
        if wall_same_read:
            same = reads[:, None] == reads[None, :]
            np.fill_diagonal(same, False)
            if same.any():
                # surviving same-read pairs put 99999 walls into the linkage
                TELEMETRY.pre_wall += 1
                fallback[index] = DeviceClusterResult(_host_linkage_clusters(
                    matrix, reads, survivors, threshold, True), dropped_count)
                continue
        off_diagonal = ~np.eye(len(survivors), dtype=bool)
        if (matrix[off_diagonal] >= SAME_READ_WALL).any():
            # BND direction-mismatch pairs wall the linkage; the device
            # coordinate formula carries no direction info — host arbitrates
            TELEMETRY.pre_wall += 1
            fallback[index] = DeviceClusterResult(_host_linkage_clusters(
                matrix, reads, survivors, threshold, wall_same_read),
                dropped_count)
            continue
        condensed = matrix[accel.triu_indices_cached(len(survivors))]
        if len(np.unique(condensed)) != len(condensed):
            # exact f64 ties: scipy's nn-chain tie-breaking decides these
            # and f32 cannot replicate it — resolve on the exact host path
            # (reusing this matrix) without paying the device round trip
            TELEMETRY.pre_tie += 1
            fallback[index] = DeviceClusterResult(_host_linkage_clusters(
                matrix, reads, survivors, threshold, wall_same_read),
                dropped_count)
            continue
        pending.fused.append((index, survivors, dropped_count,
                              batcher.add_fused(survivors, wall_same_read,
                                                element_type)))
    return pending


def _consume_fused(pending, fetched):
    results = dict(pending.ready)
    threshold = pending.threshold
    for index, survivors, dropped_count, (_route, pad, row) in pending.fused:
        (merges_lo, merges_hi, heights, min_gap, dropped, has_wall,
         dedup_ambiguous) = fetched[("fused", pad)]
        if bool(has_wall[row]):
            TELEMETRY.post_wall += 1
            results[index] = DeviceClusterResult(None, 0)
            continue
        if bool(dedup_ambiguous[row]) or float(min_gap[row]) < TIE_EPS:
            TELEMETRY.post_tie += 1
            results[index] = DeviceClusterResult(None, 0)
            continue
        # dedup already happened exactly on host; dispatched rows are all
        # survivors, so kernel slots map 1:1 to survivor ranks
        labels = labels_from_merges(merges_lo[row], merges_hi[row],
                                    heights[row], len(survivors), threshold)
        if labels is None:
            TELEMETRY.post_tie += 1
            results[index] = DeviceClusterResult(None, 0)
            continue
        TELEMETRY.device += 1
        results[index] = DeviceClusterResult(
            _group_survivors(survivors, labels), dropped_count)
    return results


def _host_linkage_clusters(matrix, reads, survivors, threshold, wall_same_read):
    """Exact float64 host linkage over an already-built (deduped) matrix —
    identical math/order to the fallback path in cluster/cluster.py, reusing
    the matrix instead of recomputing every pair distance."""
    if wall_same_read:
        distances = accel.condensed_with_wall(matrix, reads, wall_same_read=True)
    else:
        distances = matrix[accel.triu_indices_cached(matrix.shape[0])]
    dendrogram = average_linkage(distances)
    labels = fcluster_distance(dendrogram, threshold)
    return _group_survivors(survivors, labels)


def _dispatch_matrix(samples, element_type, reference, options, ed_cache,
                     batcher, dedup_same_read=True, indices=None,
                     pending=None):
    """INS / DUP_INT / BND (and the candidate round): host float64 matrix +
    exact dedup, device agglomeration (rows registered on the batcher).

    Partitions the device cannot arbitrate — walls surviving into linkage at
    dispatch time, float32 ties at consume time — are resolved by exact host
    linkage over the SAME float64 matrix (never rebuilt).

    `indices`/`pending` let the resident INS route register its same-read
    partitions here under their original sample positions."""
    threshold = float(options.cluster_max_distance)
    if pending is None:
        pending = PendingDeviceClusters(samples, threshold, batcher)
    fallback = pending.ready
    indexed = enumerate(samples) if indices is None else zip(indices, samples)
    for index, sample in indexed:
        matrix = accel.distance_matrix(sample, element_type, reference,
                                       options, ed_cache=ed_cache)
        dropped_count = 0
        survivors = sample
        reads = None
        if dedup_same_read:
            reads = accel.read_index_array(sample)
            drop = accel.dedup_same_read(matrix, reads, threshold)
            dropped_count = len(drop)
            if drop:
                keep = [i for i in range(len(sample)) if i not in drop]
                if getattr(sample, "table", None) is not None:
                    survivors = sample.take(keep)
                else:
                    survivors = [sample[i] for i in keep]
                matrix = matrix[np.ix_(keep, keep)]
                reads = reads[keep]
            if len(survivors) > 1:
                same = reads[:, None] == reads[None, :]
                np.fill_diagonal(same, False)
                if same.any():
                    TELEMETRY.pre_wall += 1
                    fallback[index] = DeviceClusterResult(_host_linkage_clusters(
                        matrix, reads, survivors, threshold, True), dropped_count)
                    continue
        if len(survivors) == 1:
            if getattr(survivors, "table", None) is not None:
                fallback[index] = DeviceClusterResult([survivors], dropped_count)
            else:
                fallback[index] = DeviceClusterResult([[survivors[0]]],
                                                      dropped_count)
            continue
        off_diagonal = ~np.eye(len(survivors), dtype=bool)
        if (matrix[off_diagonal] >= SAME_READ_WALL).any():
            # direction walls (BND) participate in above-cut averages that
            # float32 cannot order safely — host arbitrates those partitions
            TELEMETRY.pre_wall += 1
            fallback[index] = DeviceClusterResult(_host_linkage_clusters(
                matrix, reads, survivors, threshold, dedup_same_read),
                dropped_count)
            continue
        condensed = matrix[accel.triu_indices_cached(len(survivors))]
        if len(np.unique(condensed)) != len(condensed):
            # exactly-tied pair distances (common for deep-coverage INS
            # pileups with identical inserts): the kernel would flag the tie
            # (min_gap 0) and fall back anyway — skip the wasted dispatch and
            # the fetch round trip, resolve on the exact host path now
            TELEMETRY.pre_tie += 1
            fallback[index] = DeviceClusterResult(_host_linkage_clusters(
                matrix, reads, survivors, threshold, dedup_same_read),
                dropped_count)
            continue
        pending.matrix.append((index, survivors, matrix, reads, dropped_count,
                               batcher.add_matrix(matrix)))
    return pending


def _consume_matrix(pending, fetched, wall_same_read=True):
    results = dict(pending.ready)
    threshold = pending.threshold
    for (index, survivors, matrix, reads, dropped_count,
         (_route, pad, row)) in pending.matrix:
        merges_lo, merges_hi, heights, min_gap = fetched[("matrix", pad)]
        if float(min_gap[row]) < TIE_EPS:
            labels = None
        else:
            labels = labels_from_merges(merges_lo[row], merges_hi[row],
                                        heights[row], len(survivors),
                                        threshold)
        if labels is None:
            # float32 could not arbitrate: exact host linkage over the
            # float64 matrix built at dispatch (no recomputation)
            TELEMETRY.post_tie += 1
            clusters = _host_linkage_clusters(
                matrix, reads, survivors, threshold,
                wall_same_read and reads is not None)
            results[index] = DeviceClusterResult(clusters, dropped_count)
            continue
        TELEMETRY.device += 1
        results[index] = DeviceClusterResult(
            _group_survivors(survivors, labels), dropped_count)
    return results


def dispatch_partitions_device(samples: List[list], element_type: str,
                               reference, options, ed_cache=None,
                               batcher=None):
    """Register the device agglomerations for same-type partitions (each
    3..128 elements) on `batcher` (one is created when None); pair with
    consume_partitions_device.  A driver staging several types on one
    batcher gets ONE kernel dispatch per (route, pad bucket) and can fetch
    everything with one device_get."""
    if batcher is None:
        batcher = DeviceBatcher(options)
    if element_type in FUSED_TYPES:
        return _dispatch_fused(samples, element_type, reference, options,
                               batcher)
    if element_type in MATRIX_TYPES:
        if ins_resident_enabled(options):
            return dispatch_ins_resident(samples, reference, options, batcher)
        return _dispatch_matrix(samples, element_type, reference, options,
                                ed_cache, batcher)
    raise ValueError("unknown signature type {0}".format(element_type))


def ins_resident_enabled(options) -> bool:
    """Should INS clustering run the device-resident route (on-device
    wavefront eds -> on-device matrices -> agglomeration)?  Only when the
    user asks for it with --edit_backend wavefront; the default runs the
    native host edit-distance batch."""
    return getattr(options, "edit_backend", "auto") == "wavefront"


def dispatch_ins_resident(samples, reference, options, batcher=None):
    """Fully device-resident INS route (opt-in: --edit_backend wavefront).

    Near-pair haplotype edit distances compute ON DEVICE (wavefront kernel;
    the host-proven band hints make each pow4 band bucket exact in one
    pass), the distance matrices assemble on device from integer columns
    plus the still-resident ed values (ops.linkage_kernel.
    ins_matrices_from_pairs), and the agglomeration is the same batched
    kernel as the matrix route — the ed values never visit the host before
    the stage's single batched fetch.  Contract: SVIM_clustering.py:64-77.

    Partitions containing same-read duplicates register on the classic
    matrix route under their original indices (exact dedup needs the f64
    matrix); float32-ambiguous partitions rebuild the EXACT f64 matrix at
    consume time from the fetched integer ed values and run exact host
    linkage — so flat clusters stay bit-identical to the host path."""
    import jax.numpy as jnp

    from svim_tpu.ops.linkage_kernel import ins_matrices_from_pairs
    from svim_tpu.ops.wavefront_kernel import batched_edit_distance_resident

    if batcher is None:
        batcher = DeviceBatcher(options)
    threshold = float(options.cluster_max_distance)
    pending = PendingDeviceClusters(samples, threshold, batcher)

    resident = []   # (index, sample, starts, spans, pairs_i, pairs_j, hints)
    classic_indices = []
    classic_samples = []
    for index, sample in enumerate(samples):
        reads = accel.read_index_array(sample)
        if len(np.unique(reads)) != len(reads):
            classic_indices.append(index)
            classic_samples.append(sample)
            continue
        starts, spans, pairs_i, pairs_j, hints = accel.ins_near_pairs(
            sample, options)
        resident.append((index, sample, starts, spans, pairs_i, pairs_j,
                         hints))
    if classic_samples:
        ed_cache = accel.precompute_ins_edit_distances(classic_samples,
                                                       reference, options)
        _dispatch_matrix(classic_samples, "INS", reference, options,
                         ed_cache, batcher, indices=classic_indices,
                         pending=pending)
    if not resident:
        return pending

    # one flat haplotype-pair list across every resident partition
    all_pairs = []
    all_hints = []
    pair_offsets = []
    for index, sample, starts, _spans, pairs_i, pairs_j, hints in resident:
        pair_offsets.append(len(all_pairs))
        if len(pairs_i):
            all_pairs.extend(accel.ins_haplotype_pairs(
                sample, starts, pairs_i, pairs_j, reference))
            all_hints.extend(hints.tolist())
    ed_all = (batched_edit_distance_resident(all_pairs, all_hints)
              if all_pairs else jnp.zeros(1, dtype=jnp.int32))
    batcher.extra_outputs[("ins_ed",)] = ed_all

    buckets = {}
    for slot, entry in enumerate(resident):
        buckets.setdefault(_bucket(len(entry[1])), []).append(slot)
    for pad, slots in sorted(buckets.items()):
        batch = _round_up_pow2(len(slots))
        col_starts = np.zeros((batch, pad), dtype=np.int32)
        col_spans = np.zeros((batch, pad), dtype=np.int32)
        valid = np.zeros((batch, pad), dtype=bool)
        bucket_pairs = []   # (partition row, i, j, flat ed index)
        for row, slot in enumerate(slots):
            index, sample, starts, spans, pairs_i, pairs_j, _hints = \
                resident[slot]
            n = len(sample)
            col_starts[row, :n] = starts
            col_spans[row, :n] = spans
            valid[row, :n] = True
            offset = pair_offsets[slot]
            for k in range(len(pairs_i)):
                bucket_pairs.append((row, int(pairs_i[k]), int(pairs_j[k]),
                                     offset + k))
            pending.resident.append((index, sample, pairs_i, pairs_j,
                                     offset, pad, row))
        pair_pad = _round_up_pow2(max(len(bucket_pairs), 1))
        # padding pairs scatter onto (0, 0, 0) — the masked diagonal
        pair_part = np.zeros(pair_pad, dtype=np.int32)
        pair_i = np.zeros(pair_pad, dtype=np.int32)
        pair_j = np.zeros(pair_pad, dtype=np.int32)
        gather = np.zeros(pair_pad, dtype=np.int32)
        for k, (row, i, j, flat) in enumerate(bucket_pairs):
            pair_part[k] = row
            pair_i[k] = i
            pair_j[k] = j
            gather[k] = flat
        pair_ed = ed_all[gather]
        matrices = ins_matrices_from_pairs(
            col_starts, col_spans, pair_part, pair_i, pair_j, pair_ed,
            np.float32(options.position_distance_normalizer),
            np.float32(options.edit_distance_normalizer))
        batcher.extra_outputs[("ins_res", pad)] = agglomerate_batched(
            matrices, valid)
    return pending


def _consume_resident(pending, fetched):
    """Consume device-resident INS partitions: accept kernel labelings the
    float32 guard clears; rebuild the EXACT f64 matrix from the fetched
    integer ed values for the rest and run exact host linkage."""
    results = {}
    threshold = pending.threshold
    options = pending.batcher.options
    ed_all = fetched.get(("ins_ed",))
    for (index, sample, pairs_i, pairs_j, offset, pad, row) in pending.resident:
        merges_lo, merges_hi, heights, min_gap = fetched[("ins_res", pad)]
        if float(min_gap[row]) < TIE_EPS:
            labels = None
        else:
            labels = labels_from_merges(merges_lo[row], merges_hi[row],
                                        heights[row], len(sample), threshold)
        if labels is None:
            # the fetched DEVICE edit distances feed the exact rebuild — only
            # the cheap linkage re-runs, so this is not a wasted dispatch
            TELEMETRY.resident_relink += 1
            values = np.asarray(ed_all[offset:offset + len(pairs_i)],
                                dtype=np.int64)
            cache = accel.InsEditCache()
            cache.by_partition[id(sample)] = (pairs_i, pairs_j, values)
            # exact f64 matrix, identical op order to the host path (the
            # arrays route touches no reference window)
            matrix = accel.distance_matrix(sample, "INS", None, options,
                                           ed_cache=cache)
            reads = accel.read_index_array(sample)
            results[index] = DeviceClusterResult(_host_linkage_clusters(
                matrix, reads, sample, threshold, True), 0)
            continue
        TELEMETRY.device += 1
        results[index] = DeviceClusterResult(
            _group_survivors(sample, labels), 0)
    return results


def consume_partitions_device(pending: PendingDeviceClusters, fetched=None):
    """Fetch registered results and reconstruct clusters.

    `fetched` optionally supplies the already-fetched batcher outputs
    ({bucket key: arrays}, from one jax.device_get over
    pending.batcher.device_outputs()) so a driver can batch the fetch across
    types; when None the batcher's outputs are fetched here.

    Returns {index: DeviceClusterResult}; a result with clusters=None means
    float32 could not safely arbitrate that partition and the caller must
    re-run it through the exact host path."""
    if fetched is None:
        import jax

        # one batched fetch instead of a device->host sync per array
        fetched = jax.device_get(pending.batcher.device_outputs())
    if pending.fused:
        return _consume_fused(pending, fetched)
    results = _consume_matrix(pending, fetched)
    if pending.resident:
        results.update(_consume_resident(pending, fetched))
    return results


def cluster_partitions_device(samples: List[list], element_type: str,
                              reference, options, ed_cache=None):
    """Dispatch + consume in one call (single-type callers)."""
    return consume_partitions_device(dispatch_partitions_device(
        samples, element_type, reference, options, ed_cache=ed_cache))


def cluster_candidates_device(samples: List[list], options):
    """Device agglomeration for the second DUP_INT candidate round
    (reference: SVIM_clustering.py:306-372 — no dedup, no walls)."""
    import jax

    pending = _dispatch_matrix(samples, "DUP_INT", None, options, None,
                               DeviceBatcher(options), dedup_same_read=False)
    fetched = jax.device_get(pending.batcher.device_outputs())
    return _consume_matrix(pending, fetched, wall_same_read=False)
