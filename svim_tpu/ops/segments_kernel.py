"""Vectorized split-read (inter-alignment) pair classification.

Array-path replacement for the nested decision tree over adjacent read
segments (reference: SVIM_inter.py:58-240, HOT LOOP inside #1).  Segments of
each read are padded to (R, S) struct-of-arrays sorted along the read; the
kernel classifies every adjacent pair into INS / DEL / INV / tandem-dup /
BND evidence as branchless masked selects.  Per-read sequential postprocessing
(tandem run merging, translocation pairing) stays on the host — it touches
only reads that produced events.

Event encoding (all (R, S-1) int32):
  code: 0 none, 1 INS, 2 DEL, 3 INV, 4 DUP_TAN, 5 BND
  p1, p2: primary coordinates (see assemble_events)
  aux: INV direction 0-3 | TAN (bit0 fully_covered, bit1 forward) | BND
       (bit0 dir1_rev, bit1 dir2_rev)
  contig2: ref_id of the second breakend (BND), else ref_id of the pair
  qpos: query position for INS sequence extraction
  twin_p1/twin_p2/twin_aux: --all_bnds BND twin coordinates (valid where
       twin_mask)
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

LEFT_FWD, LEFT_REV, RIGHT_FWD, RIGHT_REV = 0, 1, 2, 3


@partial(jax.jit, static_argnames=())
def classify_segment_pairs(q_start, q_end, ref_id, ref_start, ref_end,
                           is_reverse, valid,
                           min_sv_size, max_sv_size,
                           segment_gap_tolerance, segment_overlap_tolerance):
    """Classify adjacent segment pairs.  All inputs (R, S) int32/bool."""
    return _classify_core(q_start, q_end, ref_id, ref_start, ref_end,
                          is_reverse, valid, min_sv_size, max_sv_size,
                          segment_gap_tolerance, segment_overlap_tolerance)


@partial(jax.jit, static_argnames=("max_segments",))
def classify_groups_fused(slot_row, q_start_h, q_end_h, ref_id_h, ref_start_h,
                          ref_end_h, is_reverse_h, valid, hard_gate_row,
                          ref_id_all, ref_start_all, is_reverse_all,
                          ref_end_dev, read_len_dev, qa_start_dev, qa_end_dev,
                          has_hard_dev,
                          min_sv_size, max_sv_size,
                          segment_gap_tolerance, segment_overlap_tolerance,
                          max_segments=64):
    """Sort per-group segments ON DEVICE and classify adjacent pairs.

    Fusing the strand-corrected query-bound computation and the
    (q_start, q_end) sort into the same program as the COLLECT geometry lets
    the caller fetch COLLECT events and split-read classifications in ONE
    device sync.

    slot_row: (G, S) packed row index per slot, -1 for slots whose geometry
    is host-provided (SA-tag segments; the *_h arrays supply those).  Rows'
    query bounds come from the still-on-device qa/read_len outputs of
    ops.cigar_kernel.collect_scan.  hard_gate_row: (G,) packed row whose
    hard-clip flag disables the whole group (reference skips SA
    reconstruction for hard-clipped primaries, SVIM_COLLECT.py:47), or -1.

    Returns the classify_segment_pairs outputs plus the sorted per-pair
    current-segment strand and ref id (the consumer's emission inputs).
    """
    rows = jnp.maximum(slot_row, 0)
    from_row = slot_row >= 0
    rev_row = is_reverse_all[rows]
    read_len = read_len_dev[rows]
    q0_row = jnp.where(rev_row, read_len - qa_end_dev[rows], qa_start_dev[rows])
    q1_row = jnp.where(rev_row, read_len - qa_start_dev[rows], qa_end_dev[rows])
    q_start = jnp.where(from_row, q0_row, q_start_h)
    q_end = jnp.where(from_row, q1_row, q_end_h)
    ref_id = jnp.where(from_row, ref_id_all[rows], ref_id_h)
    ref_start = jnp.where(from_row, ref_start_all[rows], ref_start_h)
    ref_end = jnp.where(from_row, ref_end_dev[rows], ref_end_h)
    is_reverse = jnp.where(from_row, rev_row, is_reverse_h)

    # stable sort by (q_start, q_end): two stable passes, least key first —
    # ties keep slot order (primary first, then SA/supplementary order),
    # matching the host's list.sort
    big = jnp.int32(2**31 - 1)
    key_end = jnp.where(valid, q_end, big)
    perm1 = jnp.argsort(key_end, axis=1, stable=True)
    key_start = jnp.take_along_axis(jnp.where(valid, q_start, big), perm1,
                                    axis=1)
    perm2 = jnp.argsort(key_start, axis=1, stable=True)
    perm = jnp.take_along_axis(perm1, perm2, axis=1)

    def sort_field(field):
        return jnp.take_along_axis(field, perm, axis=1)

    q_start = sort_field(q_start)
    q_end = sort_field(q_end)
    ref_id = sort_field(ref_id)
    ref_start = sort_field(ref_start)
    ref_end = sort_field(ref_end)
    is_reverse = sort_field(is_reverse)
    valid_sorted = sort_field(valid)
    # truncate to the first max_segments sorted segments (host behavior)
    slot_index = jnp.arange(q_start.shape[1], dtype=jnp.int32)[None, :]
    valid_sorted = valid_sorted & (slot_index < max_segments)
    gate_rows = jnp.maximum(hard_gate_row, 0)
    enabled = jnp.where(hard_gate_row >= 0, ~has_hard_dev[gate_rows], True)
    valid_sorted = valid_sorted & enabled[:, None]

    outputs = _classify_core(q_start, q_end, ref_id, ref_start, ref_end,
                             is_reverse, valid_sorted, min_sv_size,
                             max_sv_size, segment_gap_tolerance,
                             segment_overlap_tolerance)
    return outputs + (is_reverse[:, :-1], ref_id[:, :-1])


def _classify_core(q_start, q_end, ref_id, ref_start, ref_end,
                   is_reverse, valid,
                   min_sv_size, max_sv_size,
                   segment_gap_tolerance, segment_overlap_tolerance):
    cur = slice(None, -1)
    nxt = slice(1, None)

    pair_valid = valid[:, cur] & valid[:, nxt]
    d_read = q_start[:, nxt] - q_end[:, cur]
    same_ref = ref_id[:, cur] == ref_id[:, nxt]
    rev_cur = is_reverse[:, cur]
    rev_nxt = is_reverse[:, nxt]
    same_orient = rev_cur == rev_nxt

    rs_cur, re_cur = ref_start[:, cur], ref_end[:, cur]
    rs_nxt, re_nxt = ref_start[:, nxt], ref_end[:, nxt]

    d_ref = jnp.where(rev_cur, rs_cur - re_nxt, rs_nxt - re_cur)
    deviation = d_read - d_ref

    read_no_overlap = d_read >= -segment_overlap_tolerance
    read_no_gap = d_read <= segment_gap_tolerance
    read_window = read_no_overlap & read_no_gap

    code = jnp.zeros_like(d_read)
    p1 = jnp.zeros_like(d_read)
    p2 = jnp.zeros_like(d_read)
    aux = jnp.zeros_like(d_read)
    contig2 = ref_id[:, cur]
    qpos = jnp.where(rev_cur, q_start[:, nxt], q_end[:, cur])
    twin_mask = jnp.zeros_like(pair_valid)
    twin_p1 = jnp.zeros_like(d_read)
    twin_p2 = jnp.zeros_like(d_read)
    twin_aux = jnp.zeros_like(d_read)

    def setwhere(mask, new_code, new_p1, new_p2, new_aux):
        nonlocal code, p1, p2, aux
        mask = mask & (code == 0) & pair_valid
        code = jnp.where(mask, new_code, code)
        p1 = jnp.where(mask, new_p1, p1)
        p2 = jnp.where(mask, new_p2, p2)
        aux = jnp.where(mask, new_aux, aux)
        return mask

    def set_twin(mask, tp1, tp2, taux):
        nonlocal twin_mask, twin_p1, twin_p2, twin_aux
        twin_mask = twin_mask | mask
        twin_p1 = jnp.where(mask, tp1, twin_p1)
        twin_p2 = jnp.where(mask, tp2, twin_p2)
        twin_aux = jnp.where(mask, taux, twin_aux)

    # ---- same contig, same orientation (SVIM_inter.py:68-150) -------------------
    colinear = same_ref & same_orient
    no_ref_overlap = d_ref >= -segment_overlap_tolerance

    ins_mask = (colinear & read_no_overlap & no_ref_overlap
                & (deviation >= min_sv_size) & (d_ref <= segment_gap_tolerance))
    setwhere(ins_mask, 1, jnp.where(rev_cur, rs_cur, re_cur), deviation, 0)

    del_anchor = jnp.where(rev_cur, re_nxt, re_cur)
    del_mask = (colinear & read_no_overlap & no_ref_overlap
                & (deviation <= -min_sv_size) & (deviation >= -max_sv_size)
                & read_no_gap)
    del_mask = setwhere(del_mask, 2, del_anchor, -deviation, 0)
    set_twin(del_mask, del_anchor - 1, del_anchor - deviation, 0)  # fwd/fwd

    huge_del = (colinear & read_no_overlap & no_ref_overlap
                & (deviation < -max_sv_size) & read_no_gap)
    setwhere(huge_del, 5,
             jnp.where(rev_cur, rs_cur, re_cur - 1),
             jnp.where(rev_cur, re_nxt - 1, rs_nxt),
             jnp.where(rev_cur, 3, 0))

    # reference overlap -> tandem duplication evidence
    overlap_branch = colinear & read_no_overlap & ~no_ref_overlap & (d_ref <= -min_sv_size)
    tan_near = jnp.where(rev_cur, rs_nxt < re_cur, re_nxt > rs_cur)
    tan_far = ~tan_near & (d_ref >= -max_sv_size)
    tan_start = jnp.where(rev_cur, rs_cur, rs_nxt)
    tan_end = jnp.where(rev_cur, re_nxt, re_cur)
    tan_fwd_bit = jnp.where(rev_cur, 0, 2)
    tan_mask1 = setwhere(overlap_branch & tan_near, 4, tan_start, tan_end, 1 + tan_fwd_bit)
    tan_mask2 = setwhere(overlap_branch & tan_far, 4, tan_start, tan_end, 0 + tan_fwd_bit)
    tan_twin_p1 = jnp.where(rev_cur, rs_cur, re_cur - 1)
    tan_twin_p2 = jnp.where(rev_cur, re_nxt - 1, rs_nxt)
    tan_twin_aux = jnp.where(rev_cur, 3, 0)
    set_twin(tan_mask1 | tan_mask2, tan_twin_p1, tan_twin_p2, tan_twin_aux)
    huge_tan = overlap_branch & ~tan_near & ~tan_far
    setwhere(huge_tan, 5, tan_twin_p1, tan_twin_p2, tan_twin_aux)

    # ---- same contig, opposite orientations (SVIM_inter.py:152-204) -------------
    inverted = same_ref & ~same_orient & read_window
    fwd_rev = inverted & ~rev_cur
    rev_fwd = inverted & rev_cur
    case_near = rs_nxt - re_cur >= -segment_overlap_tolerance
    case_far = ~case_near & (rs_cur - re_nxt >= -segment_overlap_tolerance)

    # spans per case
    span_1 = re_nxt - re_cur   # case 1 (left_fwd)
    span_3 = re_cur - re_nxt   # case 3 (left_rev)
    span_2 = rs_nxt - rs_cur   # case 2 (right_fwd)
    span_4 = rs_cur - rs_nxt   # case 4 (right_rev)
    span = jnp.where(fwd_rev, jnp.where(case_near, span_1, span_3),
                     jnp.where(case_near, span_2, span_4))
    inv_case = fwd_rev & case_near | fwd_rev & case_far | rev_fwd & case_near | rev_fwd & case_far
    inv_dir = jnp.where(fwd_rev, jnp.where(case_near, LEFT_FWD, LEFT_REV),
                        jnp.where(case_near, RIGHT_FWD, RIGHT_REV))
    inv_start = jnp.where(fwd_rev,
                          jnp.where(case_near, re_cur, re_nxt),
                          jnp.where(case_near, rs_cur, rs_nxt))
    inv_end = inv_start + span
    inv_twin_p1 = jnp.where(fwd_rev, re_cur - 1, rs_cur)
    inv_twin_p2 = jnp.where(fwd_rev, re_nxt - 1, rs_nxt)
    inv_twin_aux = jnp.where(fwd_rev, 2, 1)  # fwd/rev vs rev/fwd
    inv_mask = setwhere(inv_case & (span >= min_sv_size) & (span <= max_sv_size),
                        3, inv_start, inv_end, inv_dir)
    set_twin(inv_mask, inv_twin_p1, inv_twin_p2, inv_twin_aux)
    setwhere(inv_case & (span > max_sv_size), 5, inv_twin_p1, inv_twin_p2, inv_twin_aux)

    # ---- different contigs (SVIM_inter.py:206-240) -------------------------------
    cross = ~same_ref & read_window
    cross_p1 = jnp.where(rev_cur, rs_cur, re_cur - 1)
    cross_p2 = jnp.where(same_orient,
                         jnp.where(rev_cur, re_nxt - 1, rs_nxt),
                         jnp.where(rev_cur, rs_nxt, re_nxt - 1))
    cross_aux = jnp.where(same_orient, jnp.where(rev_cur, 3, 0),
                          jnp.where(rev_cur, 1, 2))
    cross_mask = setwhere(cross, 5, cross_p1, cross_p2, cross_aux)
    contig2 = jnp.where(cross_mask | (code == 5), ref_id[:, nxt], contig2)

    return code, p1, p2, aux, contig2, qpos, twin_mask, twin_p1, twin_p2, twin_aux
