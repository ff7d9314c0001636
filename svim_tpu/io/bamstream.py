"""Streaming BAM scanner: bounded-memory COLLECT for whole-genome inputs.

The one-shot scanner (io.bamscan) keeps the uncompressed BAM and one giant
padded CIGAR batch in memory — fine for per-host shards, catastrophic for a
30x whole genome.  This module streams instead: the compressed file is
mmapped, BGZF blocks are decompressed window-by-window (native parallel
inflate), records are carved incrementally across window boundaries, and
packed batches are emitted with rows/K padded to buckets so the device
kernels compile once.

Per-record state kept for the whole file is only what genotyping needs
(ref_id/start/end/mapq + read name); sequences stay window-local and are
only touched for insertion events of the current batch.
"""

from __future__ import annotations

import gzip
import mmap
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

from svim_tpu.io.bamscan import LazySequences, LazyStrings, build_packed
from svim_tpu.io.packing import bucket_size
from svim_tpu.io.sam import AlignmentHeader

FUNMAP = 0x4
FSECONDARY = 0x100

# target decompressed window size.  Streaming is the bounded-memory path for
# whole-genome inputs (the one-shot scanner handles anything under the
# collect.packed threshold), so windows are sized to fill whole batches:
# each window-bound batch pays a dispatch + fetch, and at ~40 KB per
# long-read record a 128 MiB window fills one 4096-read batch.
# Peak residency is ~3 windows (prefetch depth 2).
WINDOW_UNCOMPRESSED = 128 * 1024 * 1024

ROW_BUCKETS = (1024, 2048, 4096, 8192, 16384)


def _row_bucket(n: int) -> int:
    for bucket in ROW_BUCKETS:
        if n <= bucket:
            return bucket
    return n


def scan_bgzf_blocks(data) -> Iterator[Tuple[int, int, int]]:
    """Yield (offset, compressed_size, uncompressed_size) per BGZF member."""
    offset = 0
    size = len(data)
    while offset + 18 <= size:
        if data[offset] != 0x1F or data[offset + 1] != 0x8B:
            raise ValueError("not a BGZF stream at offset {0}".format(offset))
        (xlen,) = struct.unpack_from("<H", data, offset + 10)
        extra = offset + 12
        extra_end = extra + xlen
        bsize = None
        while extra + 4 <= extra_end:
            s1, s2, slen = data[extra], data[extra + 1], struct.unpack_from(
                "<H", data, extra + 2)[0]
            if s1 == 0x42 and s2 == 0x43 and slen == 2:
                bsize = struct.unpack_from("<H", data, extra + 4)[0] + 1
            extra += 4 + slen
        if bsize is None:
            raise ValueError("BGZF member without BC subfield")
        if offset + bsize > size:
            raise ValueError(
                "truncated or corrupt BGZF stream: member at offset {0} "
                "claims {1} bytes but only {2} remain".format(
                    offset, bsize, size - offset))
        (isize,) = struct.unpack_from("<I", data, offset + bsize - 4)
        yield offset, bsize, isize
        offset += bsize


def _decompress_window(data, blocks, prefix=b"") -> bytes:
    """Inflate a BGZF block range into a buffer that starts with `prefix`
    (the carried partial record from the previous window) — one small
    prefix copy instead of concatenating carry + the whole inflated
    window."""
    start = blocks[0][0]
    end = blocks[-1][0] + blocks[-1][1]
    window = bytes(data[start:end])
    try:
        from svim_tpu import native
        out = native.bgzf_decompress_with_prefix(window, prefix)
        if out is not None:
            return out
    except Exception:
        pass
    return prefix + gzip.decompress(window)


class StreamedBatch:
    """One packed batch plus its SA tags (same contract the fused COLLECT
    pass consumes)."""

    __slots__ = ("packed", "sa_tags", "row_offset", "n_real")

    def __init__(self, packed, sa_tags, row_offset, n_real):
        self.packed = packed
        self.sa_tags = sa_tags
        self.row_offset = row_offset  # global row index of this batch's row 0
        self.n_real = n_real          # rows beyond this are padding


class GenotypeTable:
    """Whole-file per-record columns for genotyping region queries."""

    __slots__ = ("ref_id", "ref_start", "ref_end", "mapq", "names")

    def __init__(self, ref_id, ref_start, ref_end, mapq, names):
        self.ref_id = ref_id
        self.ref_start = ref_start
        self.ref_end = ref_end
        self.mapq = mapq
        self.names = names


def peek_bam_header(path: str):
    """Decode just enough leading BGZF blocks to parse the header (cheap
    sort-order dispatch without touching the record stream)."""
    with open(path, "rb") as handle:
        data = handle.read(8 * 1024 * 1024)
    buffer = b""
    for offset, bsize, _isize in scan_bgzf_blocks(data):
        if offset + bsize > len(data):
            break
        buffer += gzip.decompress(bytes(data[offset:offset + bsize]))
        end = _try_header_end(buffer)
        if end is not None:
            header, _ = _parse_header(buffer)
            return header
    raise ValueError("could not parse BAM header from the leading blocks")


def stream_bam(path: str, min_mapq: int, batch_reads: int = 4096,
               min_sv_size: int = 0):
    """Yield the header, then StreamedBatch objects.

    Returns a generator whose first item is the AlignmentHeader and whose
    subsequent items are StreamedBatch; use collect_streaming() for the
    assembled pipeline.  With the native library available each window runs
    the FUSED inflate+count pass (records counted/compacted while the
    blocks inflate, rows filled by memcpy from the scan cache — the same
    machinery as the one-shot scanner, per window); otherwise the
    carve/compact path runs, and with no library at all a pure-Python
    walk."""
    handle = open(path, "rb")
    data = mmap.mmap(handle.fileno(), 0, access=mmap.ACCESS_READ)
    try:
        from svim_tpu import native
        fused = native.get_library() is not None
    except Exception:
        fused = False
    if fused:
        yield from _stream_bam_fused(data, min_mapq, batch_reads, min_sv_size)
    else:
        yield from _stream_bam_carve(data, min_mapq, batch_reads, min_sv_size)


def _batch_from_columns(buffer, cigar_words, ref_id, pos, mapq, flag,
                        name_off, name_len, seq_off, seq_len, sa_off, sa_len,
                        row_offset) -> StreamedBatch:
    """StreamedBatch from row slices of a window's scan columns (fused
    path).  Names/sequences/SA decode lazily from the window buffer."""
    n_real = len(ref_id)
    n_pad = _row_bucket(n_real)
    k = cigar_words.shape[1]
    padded_words = np.zeros((n_pad, k), dtype=np.int32)
    padded_words[:n_real] = cigar_words

    def pad_column(values, dtype, fill=0):
        out = np.full(n_pad, fill, dtype=dtype)
        out[:n_real] = values
        return out

    from svim_tpu.io.bamscan import LazyStrings as _LazyStrings

    packed = build_packed(
        pad_column(ref_id, np.int32, -1), pad_column(pos, np.int32),
        pad_column(mapq, np.int32), pad_column(flag, np.int32), padded_words,
        _LazyStrings(buffer, pad_column(name_off, np.int64, -1),
                     pad_column(name_len, np.int64)),
        LazySequences(buffer, pad_column(seq_off, np.int64),
                      pad_column(seq_len, np.int64)))
    sa_tags = _LazyStrings(buffer, pad_column(sa_off, np.int64, -1),
                           pad_column(sa_len, np.int64),
                           none_when_negative=True)
    return StreamedBatch(packed, sa_tags, row_offset, n_real)


def _stream_bam_fused(data, min_mapq: int, batch_reads: int,
                      min_sv_size: int):
    """Window-fused streaming scan: per window ONE native pass inflates the
    blocks behind the carried partial record AND counts/compacts its
    records chasing the inflate frontier; rows then fill by memcpy from the
    scan cache (bamscan_native with the window's body offset)."""
    from svim_tpu import native

    block_iter = scan_bgzf_blocks(data)
    pending_blocks = []
    pending_out = 0

    def next_raw():
        nonlocal pending_blocks, pending_out
        for block in block_iter:
            pending_blocks.append(block)
            pending_out += block[2]
            if pending_out >= WINDOW_UNCOMPRESSED:
                break
        if not pending_blocks:
            return None
        raw = bytes(data[pending_blocks[0][0]:
                         pending_blocks[-1][0] + pending_blocks[-1][1]])
        pending_blocks = []
        pending_out = 0
        return raw

    carry = b""
    walk_start = -1   # window 0 parses the header behind the frontier
    header = None
    row_offset = 0
    while True:
        raw = next_raw()
        if raw is None:
            if carry:
                raise ValueError("truncated BAM record at end of stream")
            if header is None:
                raise ValueError("empty BAM stream")
            return
        scanned = native.bam_scan_fused_window(raw, carry, walk_start,
                                               min_mapq, min_sv_size)
        if scanned is None:
            if header is None:
                # e.g. a header spanning multiple windows: delegate the
                # whole stream to the incremental carve path
                yield from _stream_bam_carve(data, min_mapq, batch_reads,
                                             min_sv_size)
                return
            raise ValueError("truncated or corrupt BGZF BAM window")
        # buffer is a POOLED mmap: bytes at >= out_size are stale garbage
        # from an earlier window — always slice by out_size, never len(buffer)
        buffer, out_size, n, max_ops, body_offset, consumed = scanned
        if header is None:
            if not out_size:
                raise ValueError("empty BAM stream")
            header, _parsed_offset = _parse_header(buffer)
            yield header
        if n:
            result = native.bamscan_native(
                buffer, min_mapq, bucket_size, min_sv_size,
                counted=(n, max_ops, body_offset), body_offset=body_offset,
                size=out_size)
            if result is None:
                raise ValueError("window scan failed")
            (_text, _refs, _lens, cigar_words, ref_id, pos, mapq, flag,
             name_off, name_len, seq_off, seq_len, sa_off, sa_len) = result
            for start in range(0, n, batch_reads):
                stop = min(start + batch_reads, n)
                yield _batch_from_columns(
                    buffer, cigar_words[start:stop], ref_id[start:stop],
                    pos[start:stop], mapq[start:stop], flag[start:stop],
                    name_off[start:stop], name_len[start:stop],
                    seq_off[start:stop], seq_len[start:stop],
                    sa_off[start:stop], sa_len[start:stop],
                    row_offset + start)
            row_offset += n
        carry = bytes(buffer[consumed:out_size])
        # drop this frame's reference before the next window's scan so the
        # pool can recycle the buffer once downstream batches release it
        buffer = None
        walk_start = 0


def _stream_bam_carve(data, min_mapq: int, batch_reads: int,
                      min_sv_size: int):
    """Incremental carve/compact streaming scan (fallback when the fused
    window pass is unavailable)."""
    block_iter = scan_bgzf_blocks(data)
    pending_blocks = []
    pending_out = 0

    def next_window(prefix=b"") -> Optional[bytes]:
        nonlocal pending_blocks, pending_out
        for block in block_iter:
            pending_blocks.append(block)
            pending_out += block[2]
            if pending_out >= WINDOW_UNCOMPRESSED:
                window = _decompress_window(data, pending_blocks, prefix)
                pending_blocks = []
                pending_out = 0
                return window
        if pending_blocks:
            window = _decompress_window(data, pending_blocks, prefix)
            pending_blocks = []
            pending_out = 0
            return window
        return None

    buffer = next_window()
    if buffer is None:
        raise ValueError("empty BAM stream")
    # header may span windows
    while True:
        header_end = _try_header_end(buffer)
        if header_end is not None:
            break
        more = next_window(prefix=bytes(buffer))
        if more is None:
            raise ValueError("truncated BAM header")
        buffer = more
    header, body_offset = _parse_header(buffer)
    yield header

    position = body_offset
    row_offset = 0
    rows: List[tuple] = []   # (ref_id, pos, mapq, flag, name, cigar_off, n_cigar, seq_off, l_seq, sa)
    max_ops = 1
    pending_columns: List[dict] = []   # carve results for the current batch
    pending_count = 0

    def flush():
        nonlocal rows, max_ops, row_offset
        if not rows:
            return None
        batch = _pack_rows(rows, max_ops, buffer, row_offset, min_sv_size)
        row_offset += len(rows)
        rows = []
        max_ops = 1
        return batch

    def flush_columns():
        nonlocal pending_columns, pending_count, max_ops, row_offset
        if not pending_count:
            return None
        if len(pending_columns) == 1:
            columns = pending_columns[0]
        else:
            columns = {key: np.concatenate([c[key] for c in pending_columns])
                       for key in pending_columns[0]}
        batch = _pack_columns(columns, max_ops, buffer, row_offset,
                              min_sv_size)
        row_offset += pending_count
        pending_columns = []
        pending_count = 0
        max_ops = 1
        return batch

    try:
        from svim_tpu import native
        carver = native.bam_carve_window if native.get_library() else None
    except Exception:
        carver = None

    def roll_window():
        """Carry trailing partial bytes into a fresh window; returns False at
        end of stream.  The carry (at most one partial record, <=64 KB-ish)
        is the only copied data: the next window inflates directly behind
        it (bgzf_decompress_with_prefix)."""
        nonlocal buffer, position
        carry = bytes(buffer[position:])
        nxt = next_window(prefix=carry)
        if nxt is None:
            if carry:
                raise ValueError("truncated BAM record")
            return False
        buffer = nxt
        position = 0
        return True

    while True:
        if carver is not None:
            carved = carver(buffer, position, min_mapq,
                            batch_reads - pending_count)
        else:
            carved = None
        if carved is not None:
            # columns stay numpy arrays end-to-end: names/sequences/SA decode
            # lazily from the window buffer exactly like the one-shot
            # scanner's batches (no per-record Python tuples)
            columns, consumed, _exhausted = carved
            count = len(columns["ref_id"])
            if count:
                pending_columns.append(columns)
                pending_count += count
                top = int(columns["n_cigar"].max())
                if top > max_ops:
                    max_ops = top
            position = consumed
            if pending_count >= batch_reads:
                yield flush_columns()
                continue  # budget reset; keep carving this window
            # under budget: the window is exhausted or ends in a partial
            # record — emit what we have (columns reference this buffer)
            # and roll
            flushed = flush_columns()
            if flushed is not None:
                yield flushed
            if not roll_window():
                return
            continue

        # ---- pure-Python fallback (no native library) -------------------------
        if position + 4 > len(buffer):
            flushed = flush()
            if flushed is not None:
                yield flushed
            if not roll_window():
                return
            continue
        (block_size,) = struct.unpack_from("<i", buffer, position)
        if position + 4 + block_size > len(buffer):
            flushed = flush()
            if flushed is not None:
                yield flushed
            if not roll_window():
                return
            continue
        record_offset = position + 4
        (ref_id, pos, l_read_name, mapq, _bin, n_cigar_op, flag, l_seq,
         _nr, _np, _tl) = struct.unpack_from("<iiBBHHHiiii", buffer, record_offset)
        if (flag & (FUNMAP | FSECONDARY)) == 0 and mapq >= min_mapq:
            p = record_offset + 32
            name = buffer[p:p + l_read_name - 1].decode()
            p += l_read_name
            cigar_offset = p
            p += 4 * n_cigar_op
            seq_offset = p
            p += (l_seq + 1) // 2 + l_seq
            sa = _find_sa_py(buffer, p, record_offset + block_size)
            rows.append((ref_id, pos, mapq, flag, name, cigar_offset,
                         n_cigar_op, seq_offset, l_seq, sa))
            if n_cigar_op > max_ops:
                max_ops = n_cigar_op
            if len(rows) >= batch_reads:
                yield flush()
        position += 4 + block_size


_TAG_SIZES = {ord("c"): 1, ord("C"): 1, ord("s"): 2, ord("S"): 2,
              ord("i"): 4, ord("I"): 4, ord("f"): 4, ord("A"): 1}


def _find_sa_py(buffer, p, end) -> Optional[str]:
    if buffer.find(b"SAZ", p, end) < 0:
        return None
    while p + 3 <= end:
        value_type = buffer[p + 2]
        if buffer[p] == 0x53 and buffer[p + 1] == 0x41 and value_type == 0x5A:
            nul = buffer.index(b"\x00", p + 3, end)
            return buffer[p + 3:nul].decode()
        p += 3
        if value_type in _TAG_SIZES:
            p += _TAG_SIZES[value_type]
        elif value_type in (0x5A, 0x48):
            p = buffer.index(b"\x00", p, end) + 1
        elif value_type == 0x42:
            sub = buffer[p]
            (count,) = struct.unpack_from("<i", buffer, p + 1)
            p += 5 + count * _TAG_SIZES[sub]
        else:
            return None
    return None


def _try_header_end(buffer) -> Optional[int]:
    if len(buffer) < 12 or buffer[:4] != b"BAM\x01":
        if buffer[:4] != b"BAM\x01":
            raise ValueError("not a BAM stream")
        return None
    (l_text,) = struct.unpack_from("<i", buffer, 4)
    offset = 8 + l_text
    if offset + 4 > len(buffer):
        return None
    (n_ref,) = struct.unpack_from("<i", buffer, offset)
    offset += 4
    for _ in range(n_ref):
        if offset + 4 > len(buffer):
            return None
        (l_name,) = struct.unpack_from("<i", buffer, offset)
        offset += 4 + l_name + 4
    if offset > len(buffer):
        return None
    return offset


def _parse_header(buffer):
    (l_text,) = struct.unpack_from("<i", buffer, 4)
    text = buffer[8:8 + l_text].split(b"\x00", 1)[0].decode()
    offset = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", buffer, offset)
    offset += 4
    references, lengths = [], []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", buffer, offset)
        offset += 4
        references.append(buffer[offset:offset + l_name - 1].decode())
        offset += l_name
        lengths.append(struct.unpack_from("<i", buffer, offset)[0])
        offset += 4
    header = AlignmentHeader.from_text(text)
    if not header.references:
        header = AlignmentHeader(header.hd, references, lengths, text)
    return header, offset


def _pack_columns(columns, max_ops, buffer, row_offset,
                  min_sv_size: int = 0) -> StreamedBatch:
    """StreamedBatch straight from carve column arrays — no per-record
    Python.  Names, sequences and SA tags decode lazily from the window
    buffer (LazyStrings / LazySequences), matching the one-shot scanner."""
    n_real = len(columns["ref_id"])
    n_pad = _row_bucket(n_real)
    k = bucket_size(max_ops)
    cigar_words = None
    if min_sv_size > 0 and n_real:
        try:
            from svim_tpu import native
            compact = native.cigar_compact_rows(
                buffer, columns["cigar_off"], columns["n_cigar"],
                min_sv_size, bucket_size)
        except Exception:
            compact = None
        if compact is not None:
            k = compact.shape[1]
            cigar_words = np.zeros((n_pad, k), dtype=np.int32)
            cigar_words[:n_real] = compact
    if cigar_words is None:
        cigar_words = np.zeros((n_pad, k), dtype=np.int32)
        if min_sv_size > 0:
            from svim_tpu.io.packing import compact_cigar_row
        for row in range(n_real):
            n_cigar = int(columns["n_cigar"][row])
            if not n_cigar:
                continue
            words = np.frombuffer(buffer, dtype="<i4", count=n_cigar,
                                  offset=int(columns["cigar_off"][row]))
            if min_sv_size > 0:
                compacted_row = compact_cigar_row(words, min_sv_size)
                if compacted_row is not None:
                    cigar_words[row, :len(compacted_row)] = compacted_row
                    continue
            cigar_words[row, :n_cigar] = words

    def pad_column(values, dtype, fill=0):
        out = np.full(n_pad, fill, dtype=dtype)
        out[:n_real] = values
        return out

    ref_id = pad_column(columns["ref_id"], np.int32, -1)
    ref_start = pad_column(columns["pos"], np.int32)
    mapq = pad_column(columns["mapq"], np.int32)
    flag = pad_column(columns["flag"], np.int32)
    names = LazyStrings(buffer,
                        pad_column(columns["name_off"], np.int64, -1),
                        pad_column(columns["name_len"], np.int64))
    sequences = LazySequences(buffer,
                              pad_column(columns["seq_off"], np.int64),
                              pad_column(columns["seq_len"], np.int64))
    sa_tags = LazyStrings(buffer,
                          pad_column(columns["sa_off"], np.int64, -1),
                          pad_column(columns["sa_len"], np.int64),
                          none_when_negative=True)
    packed = build_packed(ref_id, ref_start, mapq, flag, cigar_words, names,
                          sequences)
    return StreamedBatch(packed, sa_tags, row_offset, n_real)


def _pack_rows(rows, max_ops, buffer, row_offset,
               min_sv_size: int = 0) -> StreamedBatch:
    n_real = len(rows)
    n_pad = _row_bucket(n_real)
    k = bucket_size(max_ops)
    cigar_words = None
    if min_sv_size > 0 and n_real:
        # native batch compaction straight from the window bytes: the padded
        # batch is sized from compacted op counts (typically K=32, not 8192)
        try:
            from svim_tpu import native
            compact = native.cigar_compact_rows(
                buffer,
                [r[5] for r in rows], [r[6] for r in rows],
                min_sv_size, bucket_size)
        except Exception:
            compact = None
        if compact is not None:
            k = compact.shape[1]
            cigar_words = np.zeros((n_pad, k), dtype=np.int32)
            cigar_words[:n_real] = compact
    if cigar_words is None:
        cigar_words = np.zeros((n_pad, k), dtype=np.int32)
        if min_sv_size > 0:
            from svim_tpu.io.packing import compact_cigar_row
        for row, (_r_id, _pos, _mapq, _flag, _name, cigar_offset, n_cigar,
                  _s_off, _l_seq, _sa) in enumerate(rows):
            if not n_cigar:
                continue
            words = np.frombuffer(buffer, dtype="<i4", count=n_cigar,
                                  offset=cigar_offset)
            if min_sv_size > 0:
                compacted_row = compact_cigar_row(words, min_sv_size)
                if compacted_row is not None:
                    cigar_words[row, :len(compacted_row)] = compacted_row
                    continue
            cigar_words[row, :n_cigar] = words
    ref_id = np.full(n_pad, -1, dtype=np.int32)
    ref_start = np.zeros(n_pad, dtype=np.int32)
    mapq = np.zeros(n_pad, dtype=np.int32)
    flag = np.zeros(n_pad, dtype=np.int32)
    names: List[Optional[str]] = [None] * n_pad
    seq_off = np.zeros(n_pad, dtype=np.int64)
    seq_len = np.zeros(n_pad, dtype=np.int64)
    sa_tags: List[Optional[str]] = [None] * n_pad
    for row, (r_id, pos, r_mapq, r_flag, name, _cigar_offset, _n_cigar,
              s_off, l_seq, sa) in enumerate(rows):
        ref_id[row] = r_id
        ref_start[row] = pos
        mapq[row] = r_mapq
        flag[row] = r_flag
        names[row] = name
        seq_off[row] = s_off
        seq_len[row] = l_seq
        sa_tags[row] = sa
    packed = build_packed(ref_id, ref_start, mapq, flag, cigar_words, names,
                          LazySequences(buffer, seq_off, seq_len))
    return StreamedBatch(packed, sa_tags, row_offset, n_real)


def _prefetch(iterator, depth: int = 2):
    """Run `iterator` on a background thread with a bounded queue: the BGZF
    decompress + record carve of batch N+1/N+2 overlaps the device pass and
    host materialization of batch N (window buffers are immutable bytes, so
    already-yielded batches stay valid).  Exceptions propagate."""
    import queue
    import threading

    sentinel = object()
    q = queue.Queue(maxsize=depth)

    def worker():
        try:
            for item in iterator:
                q.put(item)
            q.put(sentinel)
        except BaseException as error:  # noqa: BLE001 - re-raised on the consumer
            q.put(error)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def collect_streaming(path: str, options, soa: bool = False):
    """Streaming COLLECT: bounded-memory scan -> per-batch device kernels.

    Returns (header, GenotypeTable, signatures, twins); with soa=True the
    signatures come back as one SignatureSoA built incrementally (no
    Signature objects for the dense mass — same fast shape as the one-shot
    scanner)."""
    from svim_tpu.collect.packed import (
        SoAState,
        dispatch_collect_scan,
        signatures_from_packed,
        signatures_from_packed_soa,
    )

    stream = _prefetch(stream_bam(path, options.min_mapq, options.batch_reads,
                                  min_sv_size=options.min_sv_size),
                       depth=2)
    header = next(stream)
    signatures = []
    twins = []
    state = SoAState() if soa else None
    ref_id_parts = []
    ref_start_parts = []
    ref_end_parts = []
    mapq_parts = []
    names_all: List[str] = []

    def consume(batch, dispatched):
        if soa:
            signatures_from_packed_soa(
                batch.packed, batch.sa_tags, header, options,
                dispatched=dispatched, state=state,
                row_tag_offset=batch.row_offset)
        else:
            batch_sigs, batch_twins = signatures_from_packed(
                batch.packed, batch.sa_tags, header, options,
                dispatched=dispatched)
            signatures.extend(batch_sigs)
            twins.extend(batch_twins)
        n = batch.n_real
        ref_id_parts.append(np.asarray(batch.packed.ref_id[:n]))
        ref_start_parts.append(np.asarray(batch.packed.ref_start[:n]))
        ref_end_parts.append(np.asarray(batch.packed.ref_end[:n]))
        mapq_parts.append(np.asarray(batch.packed.mapq[:n]))
        take = getattr(batch.packed.names, "take", None)
        if take is not None:
            names_all.extend(take(np.arange(n)))
        else:
            names_all.extend(batch.packed.names[row] for row in range(n))

    # two-deep pipeline: batch N+1's device pass runs while batch N's events
    # materialize on the host
    in_flight = None
    for batch in stream:
        dispatched = dispatch_collect_scan(batch.packed, options)
        if in_flight is not None:
            consume(*in_flight)
        in_flight = (batch, dispatched)
    if in_flight is not None:
        consume(*in_flight)
    if ref_id_parts:
        table = GenotypeTable(np.concatenate(ref_id_parts),
                              np.concatenate(ref_start_parts),
                              np.concatenate(ref_end_parts),
                              np.concatenate(mapq_parts), names_all)
    else:
        table = GenotypeTable(np.zeros(0, np.int32), np.zeros(0, np.int64),
                              np.zeros(0, np.int64), np.zeros(0, np.int32), [])
    if soa:
        soa_tables, twins = state.finalize()
        return header, table, soa_tables, twins
    return header, table, signatures, twins
