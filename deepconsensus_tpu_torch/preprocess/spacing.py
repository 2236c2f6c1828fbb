"""Vectorized multi-read spacing ("gap-aware" pileup alignment).

Inserts gap columns so that every insertion in any subread gets its own
column, keeping all reads aligned to the draft CCS. Semantics are
bit-identical to the reference's per-base state machine
(reference: deepconsensus/preprocess/pre_lib.py:176-276,1242-1276) but
re-derived as a closed-form column model that runs in O(columns) numpy
instead of a Python loop over every base of every read:

* For non-label reads, all reads share a "boundary" space: boundary b
  sits before the b-th non-insertion position (non-insertion positions
  of every read align 1:1 with CCS coordinate space because expansion
  indents all reads to coordinate 0). At boundary b the pileup allocates
  max-over-reads(insertion-run length at b) insertion columns; each
  read's insertions are left-aligned into that block, and everything
  else gets gaps there.

* Label reads (truth aligned to CCS) follow the reference's special
  rule: a label consumes its pending insertions eagerly whenever polled
  and never creates columns of its own. Their column assignment has the
  closed form col(p) = iteration_consumed(p) + #insertions-before-p,
  including the reference's trailing "zombie gap" behavior where an
  exhausted label keeps acquiring gaps through insertion columns until
  the next non-insertion iteration.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from deepconsensus_tpu_torch import constants
from deepconsensus_tpu_torch.preprocess.alignment import AlignedRead

Cigar = constants.Cigar


def _ins_col_mask(
    maxins: np.ndarray, block_start: np.ndarray, total_cols: int
) -> np.ndarray:
  """Boolean mask of insertion columns from the per-boundary widths."""
  is_ins_col = np.zeros(total_cols, dtype=bool)
  nz = np.flatnonzero(maxins)
  if nz.size:
    starts = block_start[nz]
    widths = maxins[nz]
    offsets = np.arange(int(widths.sum()))
    group_starts = np.repeat(np.cumsum(widths) - widths, widths)
    ins_cols = np.repeat(starts, widths) + (offsets - group_starts)
    is_ins_col[ins_cols[ins_cols < total_cols]] = True
  return is_ins_col


def _column_layout_batched(
    nonlabel: List[AlignedRead],
) -> Tuple[List[np.ndarray], np.ndarray, int]:
  """_column_layout with every per-read loop flattened into segment
  ops over the reads' concatenated positions (per-read cumsums become
  global cumsums minus per-read offsets; per-read insertion-run
  bincounts become run-length detection on (read, boundary) change
  points + np.maximum.at). Same return contract, ~5x fewer numpy
  dispatches on typical 10-subread ZMWs."""
  n_reads = len(nonlabel)
  lens = np.array([len(r) for r in nonlabel], dtype=np.int64)
  total = int(lens.sum())
  if total == 0:
    return [np.empty(0, np.int64) for _ in nonlabel], np.zeros(0, bool), 0
  ends = np.cumsum(lens)
  read_idx = np.repeat(np.arange(n_reads), lens)

  cigar = np.concatenate([r.cigar for r in nonlabel])
  is_ins = cigar == Cigar.INS
  nonins = ~is_ins

  # boundary of each position = #non-insertions before it IN ITS READ.
  cs = np.cumsum(nonins)
  # Exclusive-prefix indexing so zero-length reads (ends[i] == start[i])
  # don't wrap: cs[ends - 1] would read cs[-1] for a leading empty read.
  cs_pad = np.concatenate([[0], cs])
  cs_end = cs_pad[ends]
  cs_before = np.concatenate([[0], cs_end[:-1]])
  boundary = cs - cs_before[read_idx] - nonins
  nonins_per_read = cs_end - cs_before
  b_max = int(nonins_per_read.max())

  # maxins[b]: widest insertion run at boundary b across reads.
  # Insertion runs are maximal stretches of ins positions sharing one
  # (read, boundary); positions are ordered, so change points find them.
  maxins = np.zeros(b_max + 1, dtype=np.int64)
  ins_pos = np.flatnonzero(is_ins)
  if ins_pos.size:
    key = read_idx[ins_pos] * np.int64(b_max + 2) + boundary[ins_pos]
    change = np.empty(len(ins_pos), dtype=bool)
    change[0] = True
    change[1:] = key[1:] != key[:-1]
    run_start_idx = np.flatnonzero(change)
    run_len = np.diff(np.append(run_start_idx, len(ins_pos)))
    run_boundary = boundary[ins_pos[run_start_idx]]
    np.maximum.at(maxins, run_boundary, run_len)
    # rank of each insertion within its run (left-aligned placement).
    run_starts_bcast = np.maximum.accumulate(
        np.where(change, np.arange(len(ins_pos)), 0)
    )
    rank = np.arange(len(ins_pos)) - run_starts_bcast

  cum = np.cumsum(maxins)  # inclusive prefix sum
  # Non-insertion position b sits at column b + cum[b]; the insertion
  # block of boundary b starts at C(b) = b + cum[b] - maxins[b].
  block_start = np.arange(b_max + 1) + cum - maxins

  cols = np.empty(total, dtype=np.int64)
  b_idx = boundary[nonins]
  cols[nonins] = b_idx + cum[b_idx]
  if ins_pos.size:
    cols[ins_pos] = block_start[boundary[ins_pos]] + rank

  nonempty = lens > 0
  last_cols = np.zeros(n_reads, dtype=np.int64)
  last_cols[nonempty] = cols[ends[nonempty] - 1] + 1
  total_cols = int(last_cols.max())

  cols_per_read = [
      cols[ends[i] - lens[i] : ends[i]] for i in range(n_reads)
  ]
  return cols_per_read, _ins_col_mask(maxins, block_start,
                                      total_cols), total_cols


def _column_layout(
    nonlabel: List[AlignedRead],
) -> Tuple[List[np.ndarray], np.ndarray, int]:
  """Computes column indices for each non-label read.

  Returns (cols_per_read, is_ins_col, total_cols).
  """
  n_reads = len(nonlabel)
  per_read = []
  b_max = 0
  for r in nonlabel:
    is_ins = r.cigar == Cigar.INS
    nonins_count = int((~is_ins).sum())
    per_read.append((is_ins, nonins_count))
    b_max = max(b_max, nonins_count)

  # maxins[b]: widest insertion run at boundary b across reads.
  maxins = np.zeros(b_max + 1, dtype=np.int64)
  boundaries_per_read = []
  for (is_ins, nonins_count), r in zip(per_read, nonlabel):
    # boundary of each position = number of non-insertions before it.
    cum_nonins = np.cumsum(~is_ins)
    boundary = cum_nonins - (~is_ins)
    ins_boundaries = boundary[is_ins]
    boundaries_per_read.append((is_ins, boundary, ins_boundaries))
    if ins_boundaries.size:
      counts = np.bincount(ins_boundaries, minlength=b_max + 1)
      np.maximum(maxins, counts, out=maxins)

  cum = np.cumsum(maxins)  # inclusive prefix sum
  # Non-insertion position b sits at column b + cum[b]; the insertion
  # block of boundary b starts at C(b) = b + cum[b] - maxins[b].
  block_start = np.arange(b_max + 1) + cum - maxins

  cols_per_read: List[np.ndarray] = []
  total_cols = 0
  for (is_ins, boundary, ins_boundaries), r in zip(
      boundaries_per_read, nonlabel
  ):
    n = len(r)
    cols = np.empty(n, dtype=np.int64)
    nonins_mask = ~is_ins
    b_idx = boundary[nonins_mask]
    cols[nonins_mask] = b_idx + cum[b_idx]
    if ins_boundaries.size:
      # rank of each insertion within its boundary's run (left-aligned).
      change = np.empty(len(ins_boundaries), dtype=bool)
      change[0] = True
      change[1:] = ins_boundaries[1:] != ins_boundaries[:-1]
      run_starts = np.maximum.accumulate(
          np.where(change, np.arange(len(ins_boundaries)), 0)
      )
      rank = np.arange(len(ins_boundaries)) - run_starts
      cols[is_ins] = block_start[ins_boundaries] + rank
    cols_per_read.append(cols)
    if n:
      total_cols = max(total_cols, int(cols[-1]) + 1)

  return cols_per_read, _ins_col_mask(maxins, block_start,
                                      total_cols), total_cols


def _label_layout(
    label: AlignedRead, is_ins_col: np.ndarray, total_cols: int
) -> Tuple[np.ndarray, int]:
  """Column assignment + final width for a label read (closed form)."""
  is_ins = label.cigar == Cigar.INS
  n = len(label)
  n_ins_total = int(is_ins.sum())
  n_nonins = n - n_ins_total

  # Iterations at which non-insertion moves happen: non-insertion
  # columns of the pileup, extended past total_cols (all-quiet tail).
  ni = np.flatnonzero(~is_ins_col)
  if len(ni) < n_nonins:
    deficit = n_nonins - len(ni)
    ni = np.concatenate([ni, np.arange(total_cols, total_cols + deficit)])

  cols = np.empty(n, dtype=np.int64)
  ins_before = np.cumsum(is_ins) - is_ins  # exclusive prefix count
  nonins_rank = np.cumsum(~is_ins) - (~is_ins)  # j(p) for every position

  nonins_mask = ~is_ins
  cols[nonins_mask] = ni[nonins_rank[nonins_mask]] + ins_before[nonins_mask]
  if n_ins_total:
    j = nonins_rank[is_ins]
    # Run preceding non-ins rank j is consumed at iteration NI[j-1]+1
    # (iteration 0 for the leading run).
    prev_iter = np.where(j > 0, ni[np.maximum(j - 1, 0)] + 1, 0)
    cols[is_ins] = prev_iter + ins_before[is_ins]

  # Final spaced width, including the reference's zombie-gap behavior.
  if n == 0:
    t_star = 0
  elif not is_ins[-1]:
    return cols, int(ni[n_nonins - 1]) + n_ins_total + 1
  else:
    t_star = int(ni[n_nonins - 1]) + 1 if n_nonins > 0 else 0
  # Count consecutive insertion iterations starting at t_star.
  zombie = 0
  t = t_star
  while t < total_cols and is_ins_col[t]:
    zombie += 1
    t += 1
  return cols, t_star + n_ins_total + zombie


def _apply_spacing(
    read: AlignedRead, cols: np.ndarray, width: int
) -> AlignedRead:
  """Scatters a read's per-position data into spaced column arrays
  (reference put_spacing: pre_lib.py:218-250)."""
  bases = np.zeros(width, dtype=np.uint8)
  pw = np.zeros(width, dtype=np.int32)
  ip = np.zeros(width, dtype=np.int32)
  ccs_idx = np.full(width, -1, dtype=np.int64)
  bases[cols] = read.bases
  pw[cols] = read.pw
  ip[cols] = read.ip
  ccs_idx[cols] = read.ccs_idx

  cigar = read.cigar
  truth_idx = read.truth_idx
  if read.is_label:
    spaced_cigar = np.full(width, int(Cigar.HARD_CLIP), dtype=np.uint8)
    spaced_cigar[cols] = read.cigar
    cigar = spaced_cigar
    truth_pos = np.full(width, -1, dtype=np.int64)
    rng = np.arange(
        read.truth_range['begin'], read.truth_range['end'], dtype=np.int64
    )
    aln_base = np.isin(cigar, constants.READ_ADVANCING_OPS_ARR)
    if int(aln_base.sum()) != len(rng):
      raise ValueError(
          f'label truth range mismatch for {read.name}: '
          f'{int(aln_base.sum())} aligned bases vs {len(rng)} truth positions'
      )
    truth_pos[aln_base] = rng
    truth_idx = truth_pos

  bq = read.base_quality_scores
  if bq.size and bq.any():
    spaced_bq = np.full(width, -1, dtype=np.int64)
    spaced_bq[cols] = bq
    bq = spaced_bq

  return AlignedRead(
      name=read.name,
      bases=bases,
      cigar=cigar,
      pw=pw,
      ip=ip,
      sn=read.sn,
      strand=read.strand,
      ec=read.ec,
      np_num_passes=read.np_num_passes,
      rq=read.rq,
      rg=read.rg,
      ccs_idx=ccs_idx,
      base_quality_scores=bq,
      truth_idx=truth_idx,
      truth_range=read.truth_range,
  )


def _apply_spacing_batched(
    reads: List[AlignedRead],
    cols_per_read: List[np.ndarray],
    width: int,
) -> List[AlignedRead]:
  """_apply_spacing for a batch of non-label reads: one [n_reads,
  width] allocation and one fancy-index scatter per field instead of
  per-read buffers (base qualities, present only on the CCS read,
  keep the per-read path)."""
  n_reads = len(reads)
  lens = np.array([len(c) for c in cols_per_read], dtype=np.int64)
  row_idx = np.repeat(np.arange(n_reads), lens)
  flat_cols = (
      np.concatenate(cols_per_read) if n_reads else np.empty(0, np.int64)
  )
  bases2d = np.zeros((n_reads, width), dtype=np.uint8)
  pw2d = np.zeros((n_reads, width), dtype=np.int32)
  ip2d = np.zeros((n_reads, width), dtype=np.int32)
  ccs_idx2d = np.full((n_reads, width), -1, dtype=np.int64)
  if flat_cols.size:
    bases2d[row_idx, flat_cols] = np.concatenate(
        [r.bases for r in reads]
    )
    pw2d[row_idx, flat_cols] = np.concatenate([r.pw for r in reads])
    ip2d[row_idx, flat_cols] = np.concatenate([r.ip for r in reads])
    ccs_idx2d[row_idx, flat_cols] = np.concatenate(
        [r.ccs_idx for r in reads]
    )
  out = []
  for i, (read, cols) in enumerate(zip(reads, cols_per_read)):
    bq = read.base_quality_scores
    if bq.size and bq.any():
      spaced_bq = np.full(width, -1, dtype=np.int64)
      spaced_bq[cols] = bq
      bq = spaced_bq
    out.append(
        AlignedRead(
            name=read.name,
            bases=bases2d[i],
            cigar=read.cigar,
            pw=pw2d[i],
            ip=ip2d[i],
            sn=read.sn,
            strand=read.strand,
            ec=read.ec,
            np_num_passes=read.np_num_passes,
            rq=read.rq,
            rg=read.rg,
            ccs_idx=ccs_idx2d[i],
            base_quality_scores=bq,
            truth_idx=read.truth_idx,
            truth_range=read.truth_range,
        )
    )
  return out


def space_out_reads(reads: List[AlignedRead]) -> List[AlignedRead]:
  """Spaces out a ZMW's reads (subreads + ccs [+ label]) into a pileup.

  Returns new AlignedReads, all of equal spaced width.
  """
  has_label = bool(reads) and reads[-1].is_label
  nonlabel = reads[:-1] if has_label else reads
  label: Optional[AlignedRead] = reads[-1] if has_label else None

  cols_per_read, is_ins_col, total_cols = _column_layout_batched(nonlabel)
  widths = [
      int(c[-1]) + 1 if len(c) else 0 for c in cols_per_read
  ]
  label_cols = None
  if label is not None:
    label_cols, label_width = _label_layout(label, is_ins_col, total_cols)
    widths.append(label_width)
  max_len = max(widths) if widths else 0

  spaced = _apply_spacing_batched(nonlabel, cols_per_read, max_len)
  if label is not None:
    spaced.append(_apply_spacing(label, label_cols, max_len))
  return spaced
