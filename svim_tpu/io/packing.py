"""Packing of alignment records into fixed-width struct-of-array tensors.

This is the boundary between the host data plane and the device kernels: ragged
CIGARs become padded (N, K) op/len arrays (bucketed K to bound recompiles),
per-alignment scalars become int32 columns, and read names/sequences stay on
the host, addressed by row index.  The reference has no analog — it hands
pysam objects to Python loops (SVIM_COLLECT.py:132-167); this layout is what
lets COLLECT run as vectorized array ops.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

# CIGAR padding buckets: K is rounded up to one of these to bound the number
# of distinct jit shapes (small buckets serve compacted CIGARs)
CIGAR_BUCKETS = (32, 128, 512, 2048, 8192, 32768, 131072)

FUNMAP = 0x4
FREVERSE = 0x10
FSECONDARY = 0x100
FSUPPLEMENTARY = 0x800

def bucket_size(max_ops: int) -> int:
    for bucket in CIGAR_BUCKETS:
        if max_ops <= bucket:
            return bucket
    return max_ops


class PackedAlignments:
    """A batch of alignments as dense arrays plus host-side string columns."""

    __slots__ = ("n", "ref_id", "ref_start", "ref_end", "mapq", "flag",
                 "qa_start", "qa_end", "read_len", "cigar_words",
                 "names", "sequences", "records", "device_cigars",
                 "has_hard_clip")

    def __init__(self, n, ref_id, ref_start, ref_end, mapq, flag, qa_start,
                 qa_end, read_len, cigar_words, names, sequences,
                 records=None, device_cigars=None, has_hard_clip=None):
        self.n = n
        self.ref_id = ref_id
        self.ref_start = ref_start
        self.ref_end = ref_end
        self.mapq = mapq
        self.flag = flag
        self.qa_start = qa_start
        self.qa_end = qa_end
        self.read_len = read_len
        # CIGAR batch in raw BAM word encoding: length << 4 | op, padded with 0
        self.cigar_words = cigar_words
        self.names = names
        self.sequences = sequences
        self.records = records
        self.device_cigars = device_cigars
        self.has_hard_clip = has_hard_clip

    @property
    def cigar_ops(self):
        return (self.cigar_words & 0xF).astype(np.int8)

    @property
    def cigar_lens(self):
        return (self.cigar_words >> 4).astype(np.int32)

    @property
    def is_reverse(self):
        return (self.flag & FREVERSE) != 0

    @property
    def is_supplementary(self):
        return (self.flag & FSUPPLEMENTARY) != 0


def encode_cigars_u8(cigar_words: np.ndarray):
    """uint8 CIGAR transfer encoding: (len<<4 | op) with len saturated at 15,
    plus a sparse (rows, cols, deltas) table for the ops whose length
    exceeds 15 (typically ~2 per long read: the terminal match run and the
    SV op).  Decode on device: lens = (w >> 4) + scatter_add(deltas).

    Quarters the host->device traffic vs int32.  Returns None when
    too many ops overflow for the encoding to pay off."""
    lens = cigar_words >> 4
    ops = cigar_words & 0xF
    over = lens > 15
    n_over = int(over.sum())
    if n_over * 10 > cigar_words.size:
        return None
    words8 = (ops | (np.minimum(lens, 15) << 4)).astype(np.uint8)
    rows, cols = np.nonzero(over)
    deltas = (lens[rows, cols] - 15).astype(np.int32)
    pad = 8
    while pad < len(rows):
        pad *= 2
    rows_padded = np.zeros(pad, dtype=np.int32)
    cols_padded = np.zeros(pad, dtype=np.int32)
    deltas_padded = np.zeros(pad, dtype=np.int32)  # zero delta: harmless add
    rows_padded[:len(rows)] = rows
    cols_padded[:len(cols)] = cols
    deltas_padded[:len(deltas)] = deltas
    return words8, rows_padded, cols_padded, deltas_padded


# synthetic op codes understood by ops/cigar_kernel (real BAM uses 0-8)
OP_REF_ADVANCE = 9    # scan pos_ref + geometry ref_end advance, never an event
OP_READ_ADVANCE = 10  # scan pos_read + geometry query advance, never an event
_LEN_MAX = (1 << 27) - 1  # keeps (len << 4 | op) a positive int32


def compact_cigar_row(words, min_sv_size: int):
    """Collapse sub-threshold op runs between SV events into synthetic
    advance ops (host reference implementation; the native scanner does the
    same transformation in C++).

    Preserves EXACTLY, vs the raw word sequence, every quantity the device
    kernels derive (ops/cigar_kernel): the scan prefix sums at each D/I event
    >= min_sv_size (SVIM_intra.py:14-29 semantics), the event order, and all
    geometry outputs (reference_end incl. N, query length, read length incl.
    hard clips, leading/trailing soft-clip bounds, hard-clip presence).

    Returns a Python list of compacted words, or None when compaction does
    not shrink the row (caller keeps the raw words; both encodings may mix
    freely within one batch)."""
    n = len(words)
    # leading / trailing clip runs stay literal (qa_start / qa_end read them)
    lo = 0
    while lo < n:
        word = int(words[lo])
        op, length = word & 0xF, word >> 4
        if length == 0 or op in (4, 5):
            lo += 1
        else:
            break
    hi = n
    while hi > lo:
        word = int(words[hi - 1])
        op, length = word & 0xF, word >> 4
        if length == 0 or op in (4, 5):
            hi -= 1
        else:
            break
    out = [int(words[i]) for i in range(lo) if int(words[i]) >> 4]
    ref_acc = read_acc = skip_acc = 0

    def flush():
        nonlocal ref_acc, read_acc, skip_acc
        while ref_acc > 0:
            piece = min(ref_acc, _LEN_MAX)
            out.append((piece << 4) | OP_REF_ADVANCE)
            ref_acc -= piece
        while skip_acc > 0:
            piece = min(skip_acc, _LEN_MAX)
            out.append((piece << 4) | 3)
            skip_acc -= piece
        while read_acc > 0:
            piece = min(read_acc, _LEN_MAX)
            out.append((piece << 4) | OP_READ_ADVANCE)
            read_acc -= piece

    for i in range(lo, hi):
        word = int(words[i])
        op, length = word & 0xF, word >> 4
        if length == 0:
            continue
        if op == 6:
            out.append(word)    # nonzero P: nonclip in geometry, keep literal
        elif op in (0, 7, 8):
            ref_acc += length
            read_acc += length
        elif op == 2:
            if length >= min_sv_size:
                flush()
                out.append(word)
            else:
                ref_acc += length
        elif op == 1:
            if length >= min_sv_size:
                flush()
                out.append(word)
            else:
                read_acc += length
        elif op == 4:
            read_acc += length  # interior soft clip: read advance only
        elif op == 3:
            skip_acc += length
        elif op == 5:
            out.append(word)    # interior hard clip (invalid SAM): literal
        else:
            return None         # unknown op code: keep the raw row
    flush()
    out.extend(int(words[i]) for i in range(hi, n) if int(words[i]) >> 4)
    if len(out) >= n:
        return None
    return out


def compact_cigar_words(cigar_words: np.ndarray, min_sv_size: int):
    """Batch form of compact_cigar_row over a padded (N, K) array.  Returns a
    new (N, K') int32 array (K' bucketed), or None when compaction would not
    shrink the batch."""
    if min_sv_size <= 0 or cigar_words.size == 0:
        return None
    n, k = cigar_words.shape
    nonzero = cigar_words != 0
    counts = np.where(nonzero.any(axis=1),
                      k - np.argmax(nonzero[:, ::-1], axis=1), 0)
    compacted: List[Optional[list]] = []
    max_ops = 1
    for row in range(n):
        words = compact_cigar_row(cigar_words[row, :int(counts[row])]
                                  if counts[row] else (), min_sv_size)
        compacted.append(words)
        ops = len(words) if words is not None else int(counts[row])
        if ops > max_ops:
            max_ops = ops
    k_out = bucket_size(max_ops)
    if k_out >= k:
        return None
    out = np.zeros((n, k_out), dtype=np.int32)
    for row in range(n):
        words = compacted[row]
        if words is None:
            count = int(counts[row])
            out[row, :count] = cigar_words[row, :count]
        elif words:
            out[row, :len(words)] = words
    return out


def pack_alignments(records: Sequence, pad_to: Optional[int] = None,
                    min_sv_size: int = 0) -> PackedAlignments:
    """Pack AlignmentRecord objects into a PackedAlignments batch.

    Records without a CIGAR are packed with zero ops (they produce nothing in
    the kernels).  min_sv_size > 0 compacts each CIGAR (compact_cigar_row)
    before padding."""
    n = len(records)
    max_ops = 1
    cigars: List = []
    for record in records:
        cigar = record.cigartuples
        if cigar and min_sv_size > 0:
            arr = np.asarray(cigar, dtype=np.int64)
            compacted = compact_cigar_row((arr[:, 1] << 4) | arr[:, 0],
                                          min_sv_size)
            if compacted is not None:
                cigar = [(int(word) & 0xF, int(word) >> 4)
                         for word in compacted]
        cigars.append(cigar)
        if cigar is not None and len(cigar) > max_ops:
            max_ops = len(cigar)
    k = bucket_size(max_ops) if pad_to is None else pad_to

    cigar_words = np.zeros((n, k), dtype=np.int32)
    ref_id = np.empty(n, dtype=np.int32)
    ref_start = np.empty(n, dtype=np.int32)
    mapq = np.empty(n, dtype=np.int32)
    flag = np.empty(n, dtype=np.int32)
    names: List[str] = []
    sequences: List[Optional[str]] = []

    for row, record in enumerate(records):
        ref_id[row] = record.reference_id
        ref_start[row] = record.reference_start
        mapq[row] = record.mapping_quality
        flag[row] = record.flag
        names.append(record.query_name)
        sequences.append(record.query_sequence)
        cigar = cigars[row]
        if cigar:
            count = len(cigar)
            arr = np.asarray(cigar, dtype=np.int64)
            cigar_words[row, :count] = (arr[:, 1] << 4) | arr[:, 0]

    from svim_tpu.io.bamscan import build_packed
    packed = build_packed(ref_id, ref_start, mapq, flag, cigar_words,
                          names, sequences)
    packed.records = list(records)
    return packed
