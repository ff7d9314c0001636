"""Array-path COLLECT: packed batches -> device kernels -> signatures.

This is the throughput path replacing the per-alignment Python loop
(reference: SVIM_COLLECT.py:132-167, HOT LOOP #1).  All alignments of a batch
are packed once (svim_tpu.io.packing / io.bamscan), the CIGAR indel scan and
split-read pair classification run as single device calls, and Signature
objects are materialized only for the sparse events.  Emission order matches
the sequential host path record-for-record, so everything downstream
(partition order, sampling, VCF) is identical.
"""

from __future__ import annotations

import logging
from typing import Dict, List

import numpy as np

from svim_tpu.collect.inter import _Emitter, _merge_tandem_runs, _pair_translocations
from svim_tpu.io import cigar as cigar_utils
from svim_tpu.io.packing import FSUPPLEMENTARY, FSECONDARY, FUNMAP, pack_alignments
from svim_tpu.signatures import (
    SignatureDeletion,
    SignatureInsertion,
    SignatureInversion,
    SignatureTranslocation,
)

_INV_DIRECTIONS = ("left_fwd", "left_rev", "right_fwd", "right_rev")
MAX_SEGMENTS = 64  # reads with more alignments fall back to the host analyzer


class _SATagSegment:
    """A supplementary alignment reconstructed from one SA-tag entry,
    carrying just the geometry the pair classifier needs."""

    __slots__ = ("ref_id", "ref_start", "ref_end", "mapq", "is_reverse",
                 "q_start", "q_end")

    def __init__(self, ref_id, ref_start, cigar_string, mapq, is_reverse):
        tuples = cigar_utils.parse_cigar(cigar_string)
        (_bases, _ops, ref_len, _q_len, read_length,
         qa_start, qa_end) = cigar_utils.derived_stats(tuples)
        self.ref_id = ref_id
        self.ref_start = ref_start
        self.ref_end = ref_start + ref_len
        self.mapq = mapq
        self.is_reverse = is_reverse
        if is_reverse:
            self.q_start = read_length - qa_end
            self.q_end = read_length - qa_start
        else:
            self.q_start = qa_start
            self.q_end = qa_end


def _parse_sa_segments(sa_tag: str, header_get_tid, mapq_min: int):
    segments = []
    for element in sa_tag.split(";"):
        if element == "":
            continue
        fields = element.split(",")
        if len(fields) != 6:
            continue
        mapq = int(fields[4])
        if not (0 <= mapq <= 255):
            mapq = 0
        if mapq < mapq_min:
            continue
        segments.append(_SATagSegment(header_get_tid(fields[0]), int(fields[1]) - 1,
                                      fields[3], mapq, fields[2] == "-"))
    return segments


def collect_signatures_packed(bam, options):
    """COLLECT over an opened AlignmentFile using the device kernels.

    Returns (sv_signatures, translocation_signatures_all_bnds) with the same
    contents and order as analyze_alignment_file_coordsorted."""
    records = list(bam.fetch(until_eof=True))
    keep = [record for record in records
            if not (record.flag & (FUNMAP | FSECONDARY))
            and record.mapping_quality >= options.min_mapq]
    if not keep:
        return [], []
    packed = pack_alignments(keep, min_sv_size=options.min_sv_size)
    sa_tags = [record.get_tag("SA") if record.has_tag("SA") else None
               for record in keep]
    return signatures_from_packed(packed, sa_tags, bam, options)


def collect_signatures_packed_querysorted(bam, options):
    """COLLECT over a queryname-sorted file using the device kernels.

    Groups records per read (reference: SVIM_COLLECT.py:96-129): exactly one
    mapped primary above min_mapq, real supplementary records (SA tags are
    ignored on this path), secondaries dropped.  Segment geometry comes from
    the fused device pass, so no per-record CIGAR walking happens on the
    host."""
    from svim_tpu.collect.collect import bam_iterator

    keep_records = []
    group_sizes = []   # rows per kept read group (primary first)
    for primary_aln, suppl_aln, _sec in bam_iterator(bam):
        if (len(primary_aln) != 1 or primary_aln[0].is_unmapped
                or primary_aln[0].mapping_quality < options.min_mapq):
            continue
        good_suppl = [aln for aln in suppl_aln
                      if not aln.is_unmapped
                      and aln.mapping_quality >= options.min_mapq]
        keep_records.append(primary_aln[0])
        keep_records.extend(good_suppl)
        group_sizes.append(1 + len(good_suppl))
    if not keep_records:
        return [], []
    packed = pack_alignments(keep_records, min_sv_size=options.min_sv_size)
    return _signatures_from_grouped_packed(packed, group_sizes, bam, options)


def _signatures_from_grouped_packed(packed, group_sizes, name_table, options):
    """Kernel-driven COLLECT over per-read row groups (row 0 of each group is
    the primary)."""
    getrname = (name_table.getrname if hasattr(name_table, "getrname")
                else name_table.get_reference_name)
    per_row_sigs: Dict[int, List] = {}
    per_row_twins: Dict[int, List] = {}

    dispatched = dispatch_collect_scan(packed, options)
    rerun, result, max_events = dispatched

    # split-read groups from the real supplementary rows: every slot is a
    # packed row, so the fused kernel derives all geometry on device and the
    # events + classifications come back in one fetch
    group_rows: List[int] = []
    slot_rows: List[List[int]] = []
    row_base = 0
    for size in group_sizes:
        if size >= 2:
            group_rows.append(row_base)  # attach split sigs to the primary row
            slot_rows.append(list(range(row_base, row_base + size)))
        row_base += size

    classify_outputs = None
    if group_rows:
        classify_outputs = _dispatch_classify_fused(
            packed, group_rows, [], result, options, slot_rows=slot_rows)

    import jax

    if classify_outputs is not None:
        fetched_collect, fetched_classify = jax.device_get(
            (result, classify_outputs))
    else:
        fetched_collect = jax.device_get(result)
        fetched_classify = None
    events = _consume_collect(packed, rerun, max_events, fetched_collect)
    _emit_indel_events(packed, events, getrname, options,
                       per_row_sigs, per_row_twins)

    if fetched_classify is not None:
        # attach split-read signatures AFTER the group's indel signatures:
        # route them to the group's LAST row + a sub-order past any indels
        split_sigs: Dict[int, List] = {}
        split_twins: Dict[int, List] = {}
        group_n = [min(len(slot_list), MAX_SEGMENTS)
                   for slot_list in slot_rows]
        _emit_classified(group_rows, group_n, fetched_classify, packed,
                         getrname, options, split_sigs, split_twins)
        # reference order within a read: primary indels, suppl indels, split
        # signatures — so splice split sigs after the group's final row
        group_end = {}
        row_base = 0
        for size in group_sizes:
            group_end[row_base] = row_base + size - 1
            row_base += size
        for primary_row, sigs in split_sigs.items():
            per_row_sigs.setdefault(group_end[primary_row], []).extend(sigs)
        for primary_row, twin_sigs in split_twins.items():
            per_row_twins.setdefault(group_end[primary_row], []).extend(twin_sigs)

    sv_signatures = []
    twins = []
    # events are sparse: iterate only rows that produced signatures (sorted,
    # so emission order still matches the sequential host path)
    for row in sorted(set(per_row_sigs) | set(per_row_twins)):
        sv_signatures.extend(per_row_sigs.get(row, ()))
        twins.extend(per_row_twins.get(row, ()))
    return sv_signatures, twins


# streaming exists for bounded memory: the one-shot scanner holds the whole
# uncompressed stream (~12x the compressed size for long-read BAMs).  After
# the round-4 window-buffer pool + prefetch pipeline, streaming BEATS the
# one-shot above ~100 MB compressed (measured: 199 MB BAM 1.1 s streaming vs
# 1.4-5.2 s one-shot — the multi-GB resident buffer pays this kernel's page
# churn; 99 MB is a tie; 25 MB one-shot wins 0.165 vs 0.19), so the
# threshold sits at the crossover and --stream_input forces streaming below
# it.
STREAMING_THRESHOLD_BYTES = 96 * 1024 * 1024


def collect_signatures_from_bam(bam_path: str, options):
    """COLLECT straight from a BAM file via the packed scanner (no
    AlignmentRecord materialization).

    Large inputs (or --stream_input) go through the bounded-memory streaming
    scanner; small ones through the one-shot scanner.  Returns
    (header, table, signatures, twins) where `table` carries the per-record
    columns for downstream region queries (genotyping)."""
    import os

    if (getattr(options, "stream_input", False)
            or os.path.getsize(bam_path) > STREAMING_THRESHOLD_BYTES):
        from svim_tpu.io.bamstream import collect_streaming
        return collect_streaming(bam_path, options)
    from svim_tpu.io.bamscan import scan_bam
    header, packed, sa_tags = scan_bam(bam_path, options.min_mapq,
                                       options.min_sv_size)
    signatures, twins = signatures_from_packed(packed, sa_tags, header, options)
    return header, packed, signatures, twins


def collect_soa_from_bam(bam_path: str, options):
    """COLLECT straight from a BAM into struct-of-arrays tables.

    Returns (header, table, SignatureSoA, twins).  Large inputs stream
    with bounded memory, each batch appending straight to shared SoA tables
    (no Signature objects for the dense mass); the one-shot path pipelines
    the native scan session against the device passes (chunked
    scan/dispatch overlap, one deferred fetch)."""
    import os

    if (getattr(options, "stream_input", False)
            or os.path.getsize(bam_path) > STREAMING_THRESHOLD_BYTES):
        from svim_tpu.io.bamstream import collect_streaming
        return collect_streaming(bam_path, options, soa=True)
    try:
        from svim_tpu import native
        pipelined = native.get_library() is not None
    except Exception:
        pipelined = False
    if pipelined:
        return collect_soa_pipelined(bam_path, options)
    from svim_tpu.io.bamscan import scan_bam
    header, packed, sa_tags = scan_bam(bam_path, options.min_mapq,
                                       options.min_sv_size)
    soa, twins = signatures_from_packed_soa(packed, sa_tags, header, options)
    return header, packed, soa, twins


def collect_soa_pipelined(bam_path: str, options):
    """One-shot SoA COLLECT pipelined against the native scan session.

    The session's background threads inflate + walk the whole stream
    (io/native BamScanSession) while this thread packs each delivered row
    range and dispatches its COLLECT + classify device passes — the device
    work and host->device transfers ride inside the scan's wall time
    instead of after it (the inflate floor was >40% of the serial warm
    path).  Nothing is fetched until every batch is staged: ONE
    jax.device_get then syncs with the device once for the whole file.

    Returns (header, GenotypeTable, SignatureSoA, twins) — the same shape
    the streaming path produces.  Replaces the ingest the reference pays
    inside COLLECT (SVIM_COLLECT.py:132-167) for the array path."""
    with open(bam_path, "rb") as handle:
        compressed = handle.read()
    return _collect_soa_pipelined_stream(compressed, options,
                                         fallback_path=bam_path)


def collect_soa_pipelined_range(bam_path: str, options, num_processes: int,
                                process_id: int):
    """Pipelined SoA COLLECT over ONE process's record range (multi-host).

    Same contract as io.bamrange.scan_bam_range — concatenating per-rank
    outputs in rank order reproduces the serial stream exactly (both ends
    of every boundary run the identical deterministic record-chain scan) —
    but through the native scan session instead of a one-shot inflate:
    the rank's stream is header blocks + its owned blocks + a small
    overhang, the session's walker skips to walk_start and stops at
    walk_end (inflated coordinates), and inflate/walk/device dispatch
    overlap exactly as in the single-process pipelined path.  This
    replaces the copy-heavy scan_bam_range route whose fresh
    hundreds-of-MB buffers per rank paid the kernel's page-churn stalls."""
    import struct as _struct

    from svim_tpu.io.bamrange import BamRangePlan

    plan = BamRangePlan(bam_path)
    comp = plan.compressed
    offs = plan.block_offsets
    n_blocks = len(offs) - 1
    b_lo, b_hi = plan.block_range(num_processes, process_id)

    def _isize(j):
        # BGZF ISIZE field: inflated size of block j
        return _struct.unpack_from("<I", comp, offs[j + 1] - 4)[0]

    if b_lo >= b_hi:
        return _empty_rank_collect(plan, options)
    range_infl = sum(_isize(j) for j in range(b_lo, b_hi))
    if b_lo == 0:
        head = b""
        head_infl = 0
        my_first = plan.first_record_offset
    else:
        head = comp[:offs[plan.header_blocks]]
        head_infl = plan.header_inflated_len
        my_first = plan._range_first_record(b_lo)
        if my_first is None or my_first >= range_infl:
            # whole range is the interior of one giant upstream record
            return _empty_rank_collect(plan, options)
    parts = [head, comp[offs[b_lo]:offs[b_hi]]]
    walk_end = -1
    if b_hi < n_blocks:
        next_first = plan._range_first_record(b_hi)
        if next_first is None:
            # everything after this range is a straddling tail we own
            parts.append(comp[offs[b_hi]:])
        else:
            tail_infl = 0
            j = b_hi
            while tail_infl < next_first:
                tail_infl += _isize(j)
                j += 1
            parts.append(comp[offs[b_hi]:offs[j]])
            walk_end = head_infl + range_infl + next_first
    return _collect_soa_pipelined_stream(
        b"".join(parts), options, walk_start=head_infl + my_first,
        walk_end=walk_end, allow_incremental=False)


def _empty_rank_collect(plan, options):
    """(header, empty GenotypeTable, empty SoA, no twins) for a rank that
    owns no whole record."""
    from svim_tpu.io.bamstream import GenotypeTable, _parse_header

    header, _offset = _parse_header(plan.header_bytes)
    state = SoAState()
    soa, twins = state.finalize()
    table = GenotypeTable(np.zeros(0, np.int32), np.zeros(0, np.int64),
                          np.zeros(0, np.int64), np.zeros(0, np.int32), [])
    return header, table, soa, twins


def _collect_soa_pipelined_stream(compressed: bytes, options,
                                  fallback_path=None, walk_start: int = -1,
                                  walk_end: int = -1,
                                  allow_incremental: bool = True):
    """collect_soa_pipelined over in-memory BGZF bytes with optional walker
    bounds (multi-host byte ranges)."""
    import jax

    from svim_tpu import native
    from svim_tpu.io.bamscan import LazySequences, LazyStrings, build_packed
    from svim_tpu.io.bamstream import GenotypeTable, _parse_header, _row_bucket
    from svim_tpu.io.packing import bucket_size
    # Inflate worker count by platform: with an accelerator the staged
    # kernels run off the host cores, so the scan session takes them all;
    # on the CPU backend XLA executes the staged kernels on these same
    # cores mid-scan, so the native default reserves two.
    scan_workers = 0   # native default: cores - 2
    try:
        if jax.devices()[0].platform != "cpu":
            scan_workers = native._scan_workers(reserve=0)
    except Exception:
        pass
    try:
        session = native.BamScanSession(compressed, options.min_mapq,
                                        options.min_sv_size,
                                        n_threads=scan_workers,
                                        walk_start=walk_start,
                                        walk_end=walk_end)
    except ValueError:
        if fallback_path is None:
            raise
        # not BGZF (e.g. plain-gzip BAM): the classic scanner handles it
        from svim_tpu.io.bamscan import scan_bam
        header, packed, sa_tags = scan_bam(fallback_path, options.min_mapq,
                                           options.min_sv_size)
        soa, twins = signatures_from_packed_soa(packed, sa_tags, header,
                                                options)
        return header, packed, soa, twins

    batch_reads = max(1, int(getattr(options, "batch_reads", 4096)))
    header = None
    staged: List = []   # (StagedCollectSoA, global row start, real rows)
    state = SoAState()
    consumed = 0        # staged entries already fetched + consumed mid-scan
    incremental = None  # mid-scan clustering (cluster/incremental.py)
    try:
        while True:
            row_start, n, max_ops, _body, done = session.next_rows(batch_reads)
            if header is None:
                # the walker parsed the header before delivering any rows,
                # so the leading bytes of session.data are final
                header, _offset = _parse_header(session.data)
                from svim_tpu.cluster.incremental import (
                    IncrementalClusterer,
                    incremental_enabled,
                )
                if allow_incremental and incremental_enabled(options):
                    incremental = IncrementalClusterer(options, header)
            if n:
                k = bucket_size(max(1, max_ops))
                (cigar_words, ref_id, pos, mapq, flag, name_off, name_len,
                 seq_off, seq_len, sa_off, sa_len) = session.fill(
                    row_start, n, k)
                n_pad = _row_bucket(n)

                def pad(values, dtype, fill=0):
                    out = np.full(n_pad, fill, dtype=dtype)
                    out[:n] = values
                    return out

                padded_words = np.zeros((n_pad, k), dtype=np.int32)
                padded_words[:n] = cigar_words
                packed = build_packed(
                    pad(ref_id, np.int32, -1), pad(pos, np.int32),
                    pad(mapq, np.int32), pad(flag, np.int32), padded_words,
                    LazyStrings(session.data, pad(name_off, np.int64, -1),
                                pad(name_len, np.int64)),
                    LazySequences(session.data, pad(seq_off, np.int64),
                                  pad(seq_len, np.int64)))
                sa_tags = LazyStrings(session.data,
                                      pad(sa_off, np.int64, -1),
                                      pad(sa_len, np.int64),
                                      none_when_negative=True)
                stage = stage_signatures_soa(packed, sa_tags, header, options)
                if stage is not None:
                    staged.append((stage, row_start, n))
            # Opportunistic consumption: fetch + consume any stage that has
            # had at least one full batch-time to compute, WHILE the session
            # walker runs ahead in its background threads — the fetch
            # and the host-side consume ride inside the scan's
            # wall time instead of serializing after it.  The newest stage
            # is left computing so the fetch never waits on the device.
            advanced = False
            while len(staged) - consumed >= 2:
                stage, stage_start, _sn = staged[consumed]
                fetched = jax.device_get(stage.device_tree())
                consume_signatures_soa(stage, fetched, header, options,
                                       state, row_tag_offset=stage_start)
                consumed += 1
                advanced = True
            if advanced and incremental is not None and consumed < len(staged):
                # cluster partitions already final behind the frontier (the
                # first un-consumed row) while the walker threads own the
                # scan; the CLUSTER stage reuses whatever still matches
                next_packed = staged[consumed][0].packed
                incremental.observe(state, int(next_packed.ref_id[0]),
                                    int(next_packed.ref_start[0]))
            if done:
                break
    except Exception:
        if incremental is not None:
            incremental.finish()
        session.close()
        raise

    rest = staged[consumed:]
    if rest:
        # ONE deferred device_get for whatever the scan shadow didn't cover
        fetched_all = jax.device_get([stage.device_tree()
                                      for stage, _, _ in rest])
        for (stage, row_start, _n), fetched in zip(rest, fetched_all):
            consume_signatures_soa(stage, fetched, header, options, state,
                                   row_tag_offset=row_start)
    soa, twins = state.finalize()
    if incremental is not None:
        soa.cluster_memo = incremental.finish()

    ref_id_parts, ref_start_parts, ref_end_parts, mapq_parts = [], [], [], []
    names_all: List[str] = []
    for stage, _row_start, n_real in staged:
        packed = stage.packed
        ref_id_parts.append(np.asarray(packed.ref_id[:n_real]))
        ref_start_parts.append(np.asarray(packed.ref_start[:n_real]))
        ref_end_parts.append(np.asarray(packed.ref_end[:n_real]))
        mapq_parts.append(np.asarray(packed.mapq[:n_real]))
        names_all.extend(packed.names.take(np.arange(n_real)))
    if ref_id_parts:
        table = GenotypeTable(np.concatenate(ref_id_parts),
                              np.concatenate(ref_start_parts),
                              np.concatenate(ref_end_parts),
                              np.concatenate(mapq_parts), names_all)
    else:
        table = GenotypeTable(np.zeros(0, np.int32), np.zeros(0, np.int64),
                              np.zeros(0, np.int64), np.zeros(0, np.int32), [])
    session.close()
    return header, table, soa, twins


def dispatch_collect_scan(packed, options):
    """Dispatch the fused geometry+events device pass WITHOUT waiting
    (async): returns (rerun fn, device result tuple, max_events) for
    finish_collect_scan.  Lets a streaming caller overlap device compute with
    host-side work on the previous batch."""
    import jax.numpy as jnp

    from svim_tpu.io.packing import encode_cigars_u8
    from svim_tpu.ops.cigar_kernel import (
        _round_up_pow2,
        collect_scan,
        collect_scan_u8,
    )

    def transfer_words():
        """Halve the host->device traffic when every word fits uint16 (the
        kernels upcast on device)."""
        words = packed.cigar_words
        if words.size and words.dtype != np.uint16 and int(words.max()) < 65536:
            words = words.astype(np.uint16)
        return words

    num_shards = getattr(options, "num_shards", 1)
    if num_shards > 1:
        import jax
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        devices = jax.devices()[:num_shards]
        if len(devices) == num_shards and packed.n % num_shards == 0:
            mesh = Mesh(np.asarray(devices), axis_names=("data",))
            words_batch = jax.device_put(transfer_words(),
                                         NamedSharding(mesh, P("data", None)))
            ref_start = jax.device_put(
                np.asarray(packed.ref_start, dtype=np.int32),
                NamedSharding(mesh, P("data")))

            def rerun(max_events):
                return collect_scan(words_batch, ref_start,
                                    jnp.int32(options.min_sv_size), max_events)

            max_events = _round_up_pow2(max(1024, packed.n * 4))
            return (rerun, rerun(max_events), max_events)

    ref_start = jnp.asarray(np.asarray(packed.ref_start, dtype=np.int32))
    max_events = _round_up_pow2(max(1024, packed.n * 4))

    device = packed.device_cigars
    if device is None:
        encoded = encode_cigars_u8(packed.cigar_words)
        if encoded is not None:
            device = tuple(jnp.asarray(part) for part in encoded)
        else:
            device = jnp.asarray(transfer_words())
        packed.device_cigars = device

    if isinstance(device, tuple):
        words8, overflow_rows, overflow_cols, overflow_deltas = device

        def rerun(max_events):
            return collect_scan_u8(words8, overflow_rows, overflow_cols,
                                   overflow_deltas, ref_start,
                                   jnp.int32(options.min_sv_size), max_events)
    else:
        words_batch = device

        def rerun(max_events):
            return collect_scan(words_batch, ref_start,
                                jnp.int32(options.min_sv_size), max_events)

    return (rerun, rerun(max_events), max_events)


def finish_collect_scan(packed, dispatched, options):
    """Wait on a dispatched device pass, fill the packed batch's geometry
    columns, return the compacted events (re-running with a larger bound on
    overflow)."""
    import jax

    rerun, result, max_events = dispatched
    return _consume_collect(packed, rerun, max_events, jax.device_get(result))


def _consume_collect(packed, rerun, max_events, fetched):
    """Consume an already-fetched COLLECT result (re-running with a larger
    event bound on overflow), fill the geometry columns, return events."""
    import jax

    from svim_tpu.ops.cigar_kernel import _round_up_pow2

    while True:
        (ref_end, read_len, qa_start, qa_end, has_hard, rows, pos_ref,
         pos_read, lengths, is_ins, count) = fetched
        if count <= max_events:
            break
        max_events = _round_up_pow2(int(count))
        fetched = jax.device_get(rerun(max_events))
    packed.ref_end = np.asarray(ref_end)
    packed.read_len = np.asarray(read_len)
    packed.qa_start = np.asarray(qa_start)
    packed.qa_end = np.asarray(qa_end)
    packed.has_hard_clip = np.asarray(has_hard)
    count = int(count)
    return (rows[:count], pos_ref[:count], pos_read[:count], lengths[:count],
            is_ins[:count])


def _run_collect_scan(packed, options):
    return finish_collect_scan(packed, dispatch_collect_scan(packed, options),
                               options)


def _slice_sequence(sequences, row, start, end):
    """Window of a row's sequence; lazy containers decode only the window."""
    slicer = getattr(sequences, "slice", None)
    if slicer is not None:
        return slicer(row, start, end)
    sequence = sequences[row]
    return sequence[start:end] if sequence is not None else ""


def _slice_sequences_batch(sequences, rows, starts, ends):
    """Many windows at once; vectorized for lazy containers."""
    batch = getattr(sequences, "slice_batch", None)
    if batch is not None:
        return batch(rows, starts, ends)
    return [_slice_sequence(sequences, int(row), int(start), int(end))
            for row, start, end in zip(rows, starts, ends)]


def _take_names(names, rows):
    """Many read names at once; vectorized for lazy containers."""
    take = getattr(names, "take", None)
    if take is not None:
        return take(rows)
    return [names[int(row)] for row in rows]


def _emit_indel_events(packed, events, getrname, options,
                       per_row_sigs, per_row_twins):
    """Materialize CIGAR indel events (the dense COLLECT output) into
    Signature objects, batching every per-event decode: insertion windows and
    read names come from single vectorized passes instead of per-event numpy
    calls.  Emission order is event order, identical to the host scan."""
    rows, pos_ref, pos_read, lengths, is_ins = events
    rows = np.asarray(rows)
    if rows.size == 0:
        return
    pos_ref = np.asarray(pos_ref, dtype=np.int64)
    lengths_arr = np.asarray(lengths, dtype=np.int64)
    ins_mask = np.asarray(is_ins, dtype=bool)
    seqs = iter(())
    if ins_mask.any():
        ins_read_pos = np.asarray(pos_read, dtype=np.int64)[ins_mask]
        seqs = iter(_slice_sequences_batch(
            packed.sequences, rows[ins_mask], ins_read_pos,
            ins_read_pos + lengths_arr[ins_mask]))
    names = _take_names(packed.names, rows)
    contig_of = {}
    row_tids = np.asarray(packed.ref_id)[rows].tolist()
    event_starts = (np.asarray(packed.ref_start, dtype=np.int64)[rows]
                    + pos_ref).tolist()
    for row, tid, start, length, ins, name in zip(
            rows.tolist(), row_tids, event_starts, lengths_arr.tolist(),
            ins_mask.tolist(), names):
        contig = contig_of.get(tid)
        if contig is None:
            contig = contig_of.setdefault(tid, getrname(tid))
        sigs = per_row_sigs.setdefault(row, [])
        if ins:
            sigs.append(SignatureInsertion(contig, start, start + length,
                                           "cigar", name, next(seqs)))
        else:
            sigs.append(SignatureDeletion(contig, start, start + length,
                                          "cigar", name))
            if options.all_bnds:
                per_row_twins.setdefault(row, []).append(SignatureTranslocation(
                    contig, start, "fwd", contig, start + length, "fwd",
                    "cigar", name))


def _emit_indel_events_soa(packed, events, getrname, options, builders,
                           contigs_pool, reads_pool, twin_rows,
                           tag_offset=0):
    """SoA materialization of CIGAR indel events: the whole batch becomes
    table columns in a few vectorized passes — no Signature objects, no
    per-event Python loop for DEL/INS (all_bnds twins stay objects: rare and
    clustered separately).  Row order parity with _emit_indel_events comes
    from the row tags (TableBuilder.finalize stable-sorts by packed row)."""
    rows, pos_ref, pos_read, lengths, is_ins = events
    rows = np.asarray(rows, dtype=np.int64)
    if rows.size == 0:
        return
    lengths_arr = np.asarray(lengths, dtype=np.int64)
    ins_mask = np.asarray(is_ins, dtype=bool)
    tids = np.asarray(packed.ref_id)[rows]
    starts = np.asarray(packed.ref_start, dtype=np.int64)[rows] + np.asarray(
        pos_ref, dtype=np.int64)
    names = _take_names(packed.names, rows)
    read_codes = reads_pool.encode_all(names)
    # tid -> contig pool code via a tiny lookup table
    unique_tids = np.unique(tids)
    lut = np.zeros(int(unique_tids.max()) + 1 if unique_tids.size else 1,
                   dtype=np.int32)
    for tid in unique_tids.tolist():
        lut[tid] = contigs_pool.code(getrname(tid))
    contig_codes = lut[tids]

    del_mask = ~ins_mask
    if del_mask.any():
        builders["DEL"].add_chunk(rows[del_mask] + tag_offset, {
            "contig_code": contig_codes[del_mask],
            "start": starts[del_mask],
            "end": starts[del_mask] + lengths_arr[del_mask],
            "read_code": read_codes[del_mask],
            "source_code": np.zeros(int(del_mask.sum()), dtype=np.int8),
        })
        if options.all_bnds:
            del_rows = rows[del_mask].tolist()
            del_starts = starts[del_mask].tolist()
            del_ends = (starts[del_mask] + lengths_arr[del_mask]).tolist()
            contig_names = [contigs_pool.names[code]
                            for code in contig_codes[del_mask].tolist()]
            del_names = [name for name, ins in zip(names, ins_mask.tolist())
                         if not ins]
            for row, contig, start, end, name in zip(
                    del_rows, contig_names, del_starts, del_ends, del_names):
                twin_rows.append((row + tag_offset, SignatureTranslocation(
                    contig, start, "fwd", contig, end, "fwd", "cigar", name)))
    if ins_mask.any():
        ins_read_pos = np.asarray(pos_read, dtype=np.int64)[ins_mask]
        seqs = _slice_sequences_batch(
            packed.sequences, rows[ins_mask], ins_read_pos,
            ins_read_pos + lengths_arr[ins_mask])
        blob = "".join(seqs).encode()
        seq_lens = np.fromiter(map(len, seqs), dtype=np.int64, count=len(seqs))
        seq_off = np.zeros(len(seqs), dtype=np.int64)
        if len(seqs) > 1:
            np.cumsum(seq_lens[:-1], out=seq_off[1:])
        builders["INS"].add_chunk(rows[ins_mask] + tag_offset, {
            "contig_code": contig_codes[ins_mask],
            "start": starts[ins_mask],
            "end": starts[ins_mask] + lengths_arr[ins_mask],
            "read_code": read_codes[ins_mask],
            "source_code": np.zeros(int(ins_mask.sum()), dtype=np.int8),
            "seq_blob": blob,
            "seq_off": seq_off,
            "seq_len": seq_lens,
        })


class SoAState:
    """Shared accumulation state for multi-batch SoA COLLECT (streaming):
    every batch appends to the same builders/pools with globally increasing
    row tags; finalize() restores the sequential emission order once."""

    __slots__ = ("builders", "contigs_pool", "reads_pool", "twin_rows")

    def __init__(self):
        from svim_tpu.sigtable import SIG_TYPES, StringPool, TableBuilder

        self.contigs_pool = StringPool()
        self.reads_pool = StringPool()
        self.builders = {sig_type: TableBuilder(sig_type, self.contigs_pool,
                                                self.reads_pool)
                         for sig_type in SIG_TYPES}
        self.twin_rows = []  # (global row tag, SignatureTranslocation)

    def finalize(self):
        from svim_tpu.sigtable import SignatureSoA

        self.twin_rows.sort(key=lambda pair: pair[0])
        twins = [twin for _, twin in self.twin_rows]
        soa = SignatureSoA(
            {t: b.finalize() for t, b in self.builders.items()},
            self.contigs_pool, self.reads_pool)
        return soa, twins


class StagedCollectSoA:
    """One packed batch's in-flight device work plus the host context needed
    to consume it later: lets a pipelined driver stage many batches (device
    passes dispatched, nothing fetched) and fetch them ALL with one
    jax.device_get at the end instead of one device sync per batch."""

    __slots__ = ("packed", "dispatched", "classify_outputs", "group_rows",
                 "group_sa_segments", "fallback_rows")

    def __init__(self, packed, dispatched, classify_outputs, group_rows,
                 group_sa_segments, fallback_rows):
        self.packed = packed
        self.dispatched = dispatched
        self.classify_outputs = classify_outputs
        self.group_rows = group_rows
        self.group_sa_segments = group_sa_segments
        self.fallback_rows = fallback_rows

    def device_tree(self):
        """(collect result, classify outputs or None) — pass through ONE
        jax.device_get, then hand to consume_signatures_soa."""
        _rerun, result, _max_events = self.dispatched
        return (result, self.classify_outputs)


def stage_signatures_soa(packed, sa_tags, name_table, options,
                         dispatched=None):
    """Dispatch the COLLECT + classify device passes for one packed batch
    (async; nothing fetched) and return the StagedCollectSoA to consume
    later.  Returns None for an empty batch (after installing empty geometry
    columns).  SA-tag parsing runs here, overlapping the in-flight COLLECT
    pass exactly as the object path does."""
    get_tid = name_table.get_tid

    if packed.n == 0:
        if packed.ref_end is None:
            empty = np.zeros(0, dtype=np.int32)
            packed.ref_end = empty
            packed.read_len = empty
            packed.qa_start = empty
            packed.qa_end = empty
            packed.has_hard_clip = np.zeros(0, dtype=bool)
        return None

    if dispatched is None:
        dispatched = dispatch_collect_scan(packed, options)

    supplementary = (packed.flag & FSUPPLEMENTARY) != 0
    sa_parsed: Dict[int, List] = {}
    present = getattr(sa_tags, "present_rows", None)
    sa_rows = present().tolist() if present is not None else range(packed.n)
    for row in sa_rows:
        sa_tag = sa_tags[row]
        if sa_tag is None or supplementary[row]:
            continue
        segments_supplementary = _parse_sa_segments(sa_tag, get_tid, options.min_mapq)
        if segments_supplementary:
            sa_parsed[row] = segments_supplementary

    group_rows: List[int] = []
    group_sa_segments: List[List] = []
    fallback_rows: List[int] = []
    for row, segments_supplementary in sa_parsed.items():
        size = 1 + len(segments_supplementary)
        if size > MAX_SEGMENTS:
            if packed.records is not None:
                fallback_rows.append(row)
                continue
            logging.warning("read %s has %d alignment segments; truncating to %d",
                            packed.names[row], size, MAX_SEGMENTS)
        group_rows.append(row)
        group_sa_segments.append(segments_supplementary)

    classify_outputs = None
    if group_rows:
        _rerun, result, _max_events = dispatched
        classify_outputs = _dispatch_classify_fused(
            packed, group_rows, group_sa_segments, result, options)
    return StagedCollectSoA(packed, dispatched, classify_outputs, group_rows,
                            group_sa_segments, fallback_rows)


def consume_signatures_soa(staged, fetched, name_table, options, state,
                           row_tag_offset=0):
    """Consume one staged batch's fetched device outputs into a SoAState.

    `fetched` is the device_get of staged.device_tree():
    (collect outputs, classify outputs or None)."""
    packed = staged.packed
    builders = state.builders
    contigs_pool = state.contigs_pool
    reads_pool = state.reads_pool
    twin_rows = state.twin_rows
    getrname = (name_table.getrname if hasattr(name_table, "getrname")
                else name_table.get_reference_name)

    fetched_collect, fetched_classify = fetched
    rerun, _result, max_events = staged.dispatched
    events = _consume_collect(packed, rerun, max_events, fetched_collect)
    _emit_indel_events_soa(packed, events, getrname, options, builders,
                           contigs_pool, reads_pool, twin_rows,
                           tag_offset=row_tag_offset)

    # split-read signatures stay on the object emitters (sparse); they join
    # the tables with row tags so ordering matches the object path
    split_sigs: Dict[int, List] = {}
    split_twins: Dict[int, List] = {}
    for row in staged.fallback_rows:
        from svim_tpu.collect.collect import retrieve_other_alignments
        from svim_tpu.collect.inter import analyze_read_segments
        record = packed.records[row]
        supplementary_records = [
            aln for aln in retrieve_other_alignments(record, name_table)
            if not aln.is_unmapped and aln.mapping_quality >= options.min_mapq]
        sigs, twin_sigs = analyze_read_segments(record, supplementary_records,
                                                name_table, options)
        split_sigs.setdefault(row, []).extend(sigs)
        split_twins.setdefault(row, []).extend(twin_sigs)
    if fetched_classify is not None:
        group_sizes = [min(1 + len(segs), MAX_SEGMENTS)
                       for segs in staged.group_sa_segments]
        _emit_classified(staged.group_rows, group_sizes, fetched_classify,
                         packed, getrname, options, split_sigs, split_twins)
    if split_sigs:
        per_type: Dict[str, List] = {}
        for row, sigs in split_sigs.items():
            for sig in sigs:
                per_type.setdefault(sig.type, []).append((row, sig))
        for sig_type, tagged in per_type.items():
            builders[sig_type].add_objects(
                [tag + row_tag_offset for tag, _ in tagged],
                [sig for _, sig in tagged])
    for row, twin_list in split_twins.items():
        for twin in twin_list:
            twin_rows.append((row + row_tag_offset, twin))


def signatures_from_packed_soa(packed, sa_tags, name_table, options,
                               dispatched=None, state=None,
                               row_tag_offset=0):
    """signatures_from_packed with struct-of-arrays output.

    Returns (SignatureSoA, twins) where twins is the all_bnds object list.
    CIGAR indel events (the dense mass) become table columns directly;
    split-read signatures run through the object emitters (sparse) and are
    appended to the tables with their packed-row tags, so each table's row
    order equals the object path's per-type signature order exactly.

    `state`/`row_tag_offset` serve the streaming scanner: batches append to
    one shared SoAState under globally increasing row tags and the caller
    finalizes once (this call then returns (None, None))."""
    shared = state is not None
    if state is None:
        state = SoAState()
    staged = stage_signatures_soa(packed, sa_tags, name_table, options,
                                  dispatched=dispatched)
    if staged is not None:
        import jax

        # one batched fetch for BOTH device passes (one device sync)
        fetched = jax.device_get(staged.device_tree())
        consume_signatures_soa(staged, fetched, name_table, options, state,
                               row_tag_offset=row_tag_offset)
    return (None, None) if shared else state.finalize()


def signatures_from_packed(packed, sa_tags, name_table, options,
                           dispatched=None):
    """Shared core: device kernels over one packed batch.

    name_table provides get_tid / the reference-name lookup (an AlignmentFile
    or an AlignmentHeader).  `dispatched` accepts an in-flight device pass
    from dispatch_collect_scan (streaming pipelining)."""
    getrname = (name_table.getrname if hasattr(name_table, "getrname")
                else name_table.get_reference_name)
    get_tid = name_table.get_tid

    if packed.n == 0:
        # nothing passed the COLLECT filter: skip the device pass entirely
        # (zero-row batches cannot compile) but leave usable empty geometry
        # columns for downstream consumers (genotyping table index)
        if packed.ref_end is None:
            empty = np.zeros(0, dtype=np.int32)
            packed.ref_end = empty
            packed.read_len = empty
            packed.qa_start = empty
            packed.qa_end = empty
            packed.has_hard_clip = np.zeros(0, dtype=bool)
        return [], []

    per_row_sigs: Dict[int, List] = {}
    per_row_twins: Dict[int, List] = {}

    # ---- fused device pass: geometry + compacted CIGAR indel events ---------------
    if dispatched is None:
        dispatched = dispatch_collect_scan(packed, options)

    # overlap with the in-flight device pass: SA-tag parsing needs no geometry
    supplementary = (packed.flag & FSUPPLEMENTARY) != 0
    sa_parsed: Dict[int, List] = {}
    present = getattr(sa_tags, "present_rows", None)
    sa_rows = present().tolist() if present is not None else range(packed.n)
    for row in sa_rows:
        sa_tag = sa_tags[row]
        if sa_tag is None or supplementary[row]:
            continue
        segments_supplementary = _parse_sa_segments(sa_tag, get_tid, options.min_mapq)
        if segments_supplementary:
            sa_parsed[row] = segments_supplementary

    # ---- split-read segment groups: the fused classify kernel sorts segments
    # and takes primary geometry straight from the in-flight COLLECT pass, so
    # NO geometry fetch is needed before dispatching it — COLLECT events and
    # classifications come back in ONE round trip -----------------------------------
    group_rows: List[int] = []
    group_sa_segments: List[List] = []
    fallback_rows: List[int] = []
    for row, segments_supplementary in sa_parsed.items():
        size = 1 + len(segments_supplementary)
        if size > MAX_SEGMENTS:
            if packed.records is not None:
                # pathological chimeras: run the sequential host analyzer
                # later (after indel materialization, preserving row order)
                fallback_rows.append(row)
                continue
            logging.warning("read %s has %d alignment segments; truncating to %d",
                            packed.names[row], size, MAX_SEGMENTS)
        group_rows.append(row)
        group_sa_segments.append(segments_supplementary)

    classify_outputs = None
    if group_rows:
        rerun, result, max_events = dispatched
        classify_outputs = _dispatch_classify_fused(
            packed, group_rows, group_sa_segments, result, options)

    # one batched fetch for BOTH device passes (one device sync)
    import jax

    rerun, result, max_events = dispatched
    if classify_outputs is not None:
        fetched_collect, fetched_classify = jax.device_get(
            (result, classify_outputs))
    else:
        fetched_collect = jax.device_get(result)
        fetched_classify = None
    events = _consume_collect(packed, rerun, max_events, fetched_collect)
    # host indel materialization (batched decodes)
    _emit_indel_events(packed, events, getrname, options,
                       per_row_sigs, per_row_twins)

    for row in fallback_rows:
        from svim_tpu.collect.collect import retrieve_other_alignments
        from svim_tpu.collect.inter import analyze_read_segments
        record = packed.records[row]
        supplementary_records = [
            aln for aln in retrieve_other_alignments(record, name_table)
            if not aln.is_unmapped and aln.mapping_quality >= options.min_mapq]
        sigs, twin_sigs = analyze_read_segments(record, supplementary_records,
                                                name_table, options)
        per_row_sigs.setdefault(row, []).extend(sigs)
        per_row_twins.setdefault(row, []).extend(twin_sigs)

    if fetched_classify is not None:
        group_sizes = [min(1 + len(segs), MAX_SEGMENTS)
                       for segs in group_sa_segments]
        _emit_classified(group_rows, group_sizes, fetched_classify, packed,
                         getrname, options, per_row_sigs, per_row_twins)

    sv_signatures = []
    twins = []
    # events are sparse: iterate only rows that produced signatures (sorted,
    # so emission order still matches the sequential host path)
    for row in sorted(set(per_row_sigs) | set(per_row_twins)):
        sv_signatures.extend(per_row_sigs.get(row, ()))
        twins.extend(per_row_twins.get(row, ()))
    return sv_signatures, twins


def _dispatch_classify_fused(packed, group_rows, group_sa_segments,
                             device_result, options, slot_rows=None):
    """Dispatch the fused sort+classify kernel (async).

    Slot 0 of each group is the primary row (geometry gathered on device from
    the in-flight COLLECT outputs); remaining slots carry host-parsed SA-tag
    segment geometry.  `slot_rows` overrides the slot layout with real packed
    rows per slot (queryname-sorted path), in which case group_sa_segments
    must be empty lists and no hard-clip gate applies."""
    from svim_tpu.ops.segments_kernel import classify_groups_fused

    if slot_rows is not None:
        s_pad = max(2, max(len(slot_list) for slot_list in slot_rows))
    else:
        # oversized groups are sorted fully on device, then truncated to the
        # first MAX_SEGMENTS — so every segment participates in the sort,
        # exactly like the host's segments.sort()[:MAX_SEGMENTS]
        s_pad = max(2, max(1 + len(segs) for segs in group_sa_segments))

    # bucket both axes to powers of two: each distinct shape is its own jit
    # compile (padded groups carry valid=False and emit nothing)
    def _pow2(value, floor):
        result = floor
        while result < value:
            result *= 2
        return result

    n_groups = _pow2(len(group_rows), 8)
    s_pad = _pow2(s_pad, 2)

    slot_row = np.full((n_groups, s_pad), -1, dtype=np.int32)
    q_start = np.zeros((n_groups, s_pad), dtype=np.int32)
    q_end = np.zeros((n_groups, s_pad), dtype=np.int32)
    ref_id = np.zeros((n_groups, s_pad), dtype=np.int32)
    ref_start = np.zeros((n_groups, s_pad), dtype=np.int32)
    ref_end = np.zeros((n_groups, s_pad), dtype=np.int32)
    is_reverse = np.zeros((n_groups, s_pad), dtype=bool)
    valid = np.zeros((n_groups, s_pad), dtype=bool)
    if slot_rows is not None:
        hard_gate = np.full(n_groups, -1, dtype=np.int32)
        for g, slot_list in enumerate(slot_rows):
            slot_row[g, :len(slot_list)] = slot_list
            valid[g, :len(slot_list)] = True
    else:
        hard_gate = np.full(n_groups, -1, dtype=np.int32)
        hard_gate[:len(group_rows)] = group_rows
        for g, (row, segments) in enumerate(zip(group_rows,
                                                group_sa_segments)):
            slot_row[g, 0] = row
            valid[g, 0] = True
            for s, seg in enumerate(segments, start=1):
                q_start[g, s] = seg.q_start
                q_end[g, s] = seg.q_end
                ref_id[g, s] = seg.ref_id
                ref_start[g, s] = seg.ref_start
                ref_end[g, s] = seg.ref_end
                is_reverse[g, s] = seg.is_reverse
                valid[g, s] = True

    ref_end_dev, read_len_dev, qa_start_dev, qa_end_dev, has_hard_dev = (
        device_result[:5])
    return classify_groups_fused(
        slot_row, q_start, q_end, ref_id, ref_start, ref_end, is_reverse,
        valid, hard_gate,
        np.asarray(packed.ref_id, dtype=np.int32),
        np.asarray(packed.ref_start, dtype=np.int32),
        np.asarray(packed.is_reverse),
        ref_end_dev, read_len_dev, qa_start_dev, qa_end_dev, has_hard_dev,
        np.int32(options.min_sv_size), np.int32(options.max_sv_size),
        np.int32(options.segment_gap_tolerance),
        np.int32(options.segment_overlap_tolerance),
        max_segments=MAX_SEGMENTS)


def _emit_classified(group_rows, group_sizes, fetched, packed, getrname,
                     options, per_row_sigs, per_row_twins):
    """Consume fetched pair-classification outputs and assemble per-read
    signatures in reference order."""
    (code, p1, p2, aux, contig2, qpos, twin_mask, twin_p1, twin_p2,
     twin_aux, is_reverse, ref_id) = fetched

    for g, row in enumerate(group_rows):
        if not (code[g] != 0).any() and not twin_mask[g].any():
            continue
        emit = _Emitter(packed.names[row], options)
        n_pairs = group_sizes[g] - 1
        for pair in range(n_pairs):
            event = int(code[g, pair])
            if twin_mask[g, pair] and options.all_bnds:
                taux = int(twin_aux[g, pair])
                emit.all_bnds.append(SignatureTranslocation(
                    getrname(int(ref_id[g, pair])), int(twin_p1[g, pair]),
                    "rev" if taux & 1 else "fwd",
                    getrname(int(ref_id[g, pair])), int(twin_p2[g, pair]),
                    "rev" if taux & 2 else "fwd", "suppl", emit.read_name))
            if event == 0:
                continue
            contig = getrname(int(ref_id[g, pair]))
            if event == 1:  # INS
                anchor, deviation = int(p1[g, pair]), int(p2[g, pair])
                position = int(qpos[g, pair])
                if is_reverse[g, pair]:
                    position = int(packed.read_len[row]) - position
                sequence = _slice_sequence(packed.sequences, row, position,
                                           position + deviation)
                emit.signatures.append(SignatureInsertion(
                    contig, anchor, anchor + deviation, "suppl",
                    emit.read_name, sequence))
            elif event == 2:  # DEL
                anchor, length = int(p1[g, pair]), int(p2[g, pair])
                emit.signatures.append(SignatureDeletion(
                    contig, anchor, anchor + length, "suppl", emit.read_name))
            elif event == 3:  # INV
                emit.signatures.append(SignatureInversion(
                    contig, int(p1[g, pair]), int(p2[g, pair]), "suppl",
                    emit.read_name, _INV_DIRECTIONS[int(aux[g, pair])]))
            elif event == 4:  # tandem duplication run entry
                bits = int(aux[g, pair])
                emit.tandem_runs.append((contig, int(p1[g, pair]), int(p2[g, pair]),
                                         bool(bits & 1), bool(bits & 2)))
            elif event == 5:  # BND
                bits = int(aux[g, pair])
                emit.bnd(contig, int(p1[g, pair]), "rev" if bits & 1 else "fwd",
                         getrname(int(contig2[g, pair])), int(p2[g, pair]),
                         "rev" if bits & 2 else "fwd")
        _merge_tandem_runs(emit)
        _pair_translocations(emit)
        per_row_sigs.setdefault(row, []).extend(emit.signatures)
        if options.all_bnds:
            per_row_twins.setdefault(row, []).extend(emit.all_bnds)
