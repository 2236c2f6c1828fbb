"""Aligned-read container and alignment expansion.

Converts BAM alignment records into gap-expanded, CCS-indexed read
arrays. Behavior mirrors the reference's Read dataclass and
expand_clip_indent/trim_insertions (reference:
deepconsensus/preprocess/pre_lib.py:110-421,1061-1239) but everything is
vectorized numpy over the expanded-cigar column space, and bases are
kept vocab-encoded (uint8, gap=0) end to end instead of char arrays.

One deliberate divergence: bases outside the vocab (e.g. 'N') encode to
gap (0); the reference leaves uninitialized memory for them
(pre_lib.py:253-260 writes only vocab matches into an np.ndarray).
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Any, Dict, Optional

import numpy as np

from deepconsensus_tpu_torch import constants
from deepconsensus_tpu_torch.io.bam import BamRecord
from deepconsensus_tpu_torch.utils import phred

Cigar = constants.Cigar

_EMPTY_I32 = np.empty(0, dtype=np.int32)
_EMPTY_U8 = np.empty(0, dtype=np.uint8)


@dataclasses.dataclass
class AlignedRead:
  """A gap-expanded sequence aligned to CCS coordinates.

  bases are vocab-encoded uint8 (0=gap). ccs_idx maps each column to a
  CCS coordinate or -1. For labels, truth_range/truth_idx track the
  genome interval the truth sequence came from.
  """

  name: str
  bases: np.ndarray          # uint8 vocab codes
  cigar: np.ndarray          # uint8 op codes
  pw: np.ndarray             # int32
  ip: np.ndarray             # int32
  sn: np.ndarray             # float32[4] (empty for labels)
  strand: constants.Strand
  ec: Optional[float] = None
  np_num_passes: Optional[int] = None
  rq: Optional[float] = None
  rg: Optional[str] = None
  ccs_idx: np.ndarray = dataclasses.field(
      default_factory=lambda: np.empty(0, dtype=np.int64))
  base_quality_scores: np.ndarray = dataclasses.field(
      default_factory=lambda: _EMPTY_I32.copy())
  truth_idx: np.ndarray = dataclasses.field(
      default_factory=lambda: np.empty(0, dtype=np.int64))
  truth_range: Optional[Dict[str, Any]] = None

  # ------------------------------------------------------------------
  @property
  def is_label(self) -> bool:
    return self.truth_range is not None

  @property
  def zmw(self) -> int:
    return int(self.name.split('/')[1])

  @property
  def avg_base_quality_score(self) -> float:
    return phred.avg_phred(self.base_quality_scores)

  def __len__(self) -> int:
    return len(self.bases)

  def __str__(self) -> str:
    return phred.encoded_sequence_to_string(self.bases)

  @property
  def ccs_bounds(self) -> slice:
    """Min/max covered CCS coordinate (inclusive max), or empty slice."""
    covered = self.ccs_idx[self.ccs_idx != -1]
    if covered.size == 0:
      return slice(0, 0)
    return slice(int(covered.min()), int(covered.max()))

  @property
  def label_bounds(self) -> slice:
    covered = self.truth_idx[self.truth_idx != -1]
    if covered.size == 0:
      return slice(0, 0)
    return slice(int(covered.min()), int(covered.max()))

  @property
  def label_coords(self) -> str:
    if self.is_label:
      bounds = self.label_bounds
      return f'{self.truth_range["contig"]}:{bounds.start}-{bounds.stop}'
    return ''

  # ------------------------------------------------------------------
  def slice_columns(self, r_slice: slice) -> 'AlignedRead':
    """Slice all per-column attributes (reference: pre_lib.py:392-409)."""
    return AlignedRead(
        name=self.name,
        bases=self.bases[r_slice],
        cigar=self.cigar[r_slice],
        pw=self.pw[r_slice],
        ip=self.ip[r_slice],
        sn=self.sn,
        strand=self.strand,
        ec=self.ec,
        np_num_passes=self.np_num_passes,
        rq=self.rq,
        rg=self.rg,
        ccs_idx=self.ccs_idx[r_slice],
        base_quality_scores=self.base_quality_scores[r_slice]
        if self.base_quality_scores.size
        else self.base_quality_scores,
        truth_idx=self.truth_idx[r_slice]
        if self.truth_idx.size
        else self.truth_idx,
        truth_range=self.truth_range,
    )

  def ccs_slice(self, start: int, end: int) -> 'AlignedRead':
    """Slice by CCS coordinates; bounds inclusive (pre_lib.py:308-334)."""
    locs = np.where((self.ccs_idx >= start) & (self.ccs_idx <= end))[0]
    if locs.size:
      sl = slice(int(locs.min()), int(locs.max()) + 1)
    else:
      sl = slice(0, 0)
    out = self.slice_columns(sl)
    return out

  def pad(self, pad_width: int) -> 'AlignedRead':
    """Right-pad all per-column attributes to pad_width."""
    n = len(self)
    if n >= pad_width:
      return self
    extra = pad_width - n

    def _pad(arr, value, dtype=None):
      if dtype is None:
        dtype = arr.dtype
      fill = np.full(extra, value, dtype=dtype)
      return np.concatenate([arr.astype(dtype), fill])

    return AlignedRead(
        name=self.name,
        bases=_pad(self.bases, constants.GAP_INT),
        cigar=_pad(self.cigar, int(Cigar.HARD_CLIP)),
        pw=_pad(self.pw, 0),
        ip=_pad(self.ip, 0),
        sn=self.sn,
        strand=self.strand,
        ec=self.ec,
        np_num_passes=self.np_num_passes,
        rq=self.rq,
        rg=self.rg,
        ccs_idx=_pad(self.ccs_idx, -1),
        base_quality_scores=_pad(self.base_quality_scores, -1, np.int64),
        truth_idx=_pad(self.truth_idx, -1, np.int64),
        truth_range=self.truth_range,
    )

  def remove_gaps_and_pad(self, pad_width: int) -> Optional['AlignedRead']:
    """Drop gap columns; None if still longer than pad_width.

    Used to fit long labels into the window (pre_lib.py:358-384).
    """
    keep = self.bases != constants.GAP_INT
    if int(keep.sum()) > pad_width:
      return None
    kept = AlignedRead(
        name=self.name,
        bases=self.bases[keep],
        cigar=self.cigar[keep],
        pw=self.pw[keep],
        ip=self.ip[keep],
        sn=self.sn,
        strand=self.strand,
        ec=self.ec,
        np_num_passes=self.np_num_passes,
        rq=self.rq,
        rg=self.rg,
        ccs_idx=self.ccs_idx[keep],
        base_quality_scores=self.base_quality_scores[keep]
        if self.base_quality_scores.size
        else self.base_quality_scores,
        truth_idx=self.truth_idx[keep]
        if self.truth_idx.size
        else self.truth_idx,
        truth_range=self.truth_range,
    )
    return kept.pad(pad_width)


# ---------------------------------------------------------------------------
# Expansion from BAM records
# ---------------------------------------------------------------------------


def _trim_insertions(
    record: BamRecord,
    ins_trim: int,
    counter: Optional[Counter],
):
  """Removes insertions longer than ins_trim.

  Returns (cigar_ops, cigar_lens, seq_codes, keep_mask_query) where
  keep_mask_query marks surviving query bases in *aligned* orientation
  (reference: pre_lib.py:1061-1125).
  """
  ops = record.cigar_ops
  lens = record.cigar_lens
  seq_codes = np.frombuffer(record.seq.encode('ascii'), dtype=np.uint8)
  if counter is not None:
    counter['zmw_total_bp'] += int(lens.sum())
  if ins_trim <= 0:
    return ops, lens, seq_codes, None

  big_ins = (ops == Cigar.INS) & (lens > ins_trim)
  if not big_ins.any():
    return ops, lens, seq_codes, None

  # Query-consuming ops (per SAM spec) give seq offsets per cigar op.
  q_consume = np.array(
      [op in (0, 1, 4, 7, 8) for op in range(10)], dtype=bool
  )[ops]
  q_starts = np.concatenate([[0], np.cumsum(np.where(q_consume, lens, 0))])[:-1]
  keep_mask = np.ones(len(seq_codes), dtype=bool)
  for i in np.flatnonzero(big_ins):
    keep_mask[q_starts[i] : q_starts[i] + lens[i]] = False
    if counter is not None:
      counter['zmw_trimmed_insertions'] += 1
      counter['zmw_trimmed_insertions_bp'] += int(lens[i])
  new_ops = ops[~big_ins]
  new_lens = lens[~big_ins]
  return new_ops, new_lens, seq_codes[keep_mask], keep_mask


def expand_aligned_record(
    record: BamRecord,
    truth_range: Optional[Dict[str, Any]] = None,
    ins_trim: int = 0,
    counter: Optional[Counter] = None,
) -> AlignedRead:
  """Expands a BAM alignment into CCS-column space.

  Deletions become gap columns, soft clips are removed, the read is
  indented to reference coordinate 0, and PW/IP tag values (stored in
  instrument orientation) are reversed onto reverse-strand alignments
  (reference: pre_lib.py:1128-1239).
  """
  ops, lens, seq_codes, keep_mask = _trim_insertions(record, ins_trim, counter)
  if truth_range is not None:
    truth_range = dict(truth_range)

  # Expanded per-column arrays over the (hard-clip-free) alignment.
  hard = ops == Cigar.HARD_CLIP
  exp_ops = np.repeat(ops[~hard], lens[~hard]).astype(np.uint8)
  q_mask = np.array([op in (0, 1, 4, 7, 8) for op in range(10)], bool)[exp_ops]
  r_mask = np.array([op in (0, 2, 3, 7, 8) for op in range(10)], bool)[exp_ops]
  read_idx = np.where(q_mask, np.cumsum(q_mask) - 1, -1)
  ccs_idx = np.where(r_mask, record.pos + np.cumsum(r_mask) - 1, -1).astype(
      np.int64
  )

  aln_len = len(exp_ops)
  new_bases = np.zeros(aln_len, dtype=np.uint8)
  new_bases[q_mask] = constants.VOCAB_LUT[seq_codes]
  new_pw = np.zeros(aln_len, dtype=np.int32)
  new_ip = np.zeros(aln_len, dtype=np.int32)

  strand = (
      constants.Strand.REVERSE if record.is_reverse
      else constants.Strand.FORWARD
  )

  if truth_range is None:
    pw_vals = np.asarray(record.get_tag('pw'), dtype=np.int32)
    ip_vals = np.asarray(record.get_tag('ip'), dtype=np.int32)
    if keep_mask is not None:
      if record.is_reverse:
        pw_vals = pw_vals[keep_mask[::-1]]
        ip_vals = ip_vals[keep_mask[::-1]]
      else:
        pw_vals = pw_vals[keep_mask]
        ip_vals = ip_vals[keep_mask]
    if strand == constants.Strand.REVERSE:
      pw_vals = pw_vals[::-1]
      ip_vals = ip_vals[::-1]
    new_pw[q_mask] = pw_vals
    new_ip[q_mask] = ip_vals
    sn = np.asarray(record.get_tag('sn'), dtype=np.float32)
  else:
    sn = np.empty(0, dtype=np.float32)

  # Remove soft-clipped ends (bases nulled, columns dropped). Bounds
  # must come from the *trimmed* cigar, like the reference which trims
  # the record in place before expanding (pre_lib.py:1153-1155).
  soft = exp_ops == Cigar.SOFT_CLIP
  if soft.any():
    new_bases[soft] = constants.GAP_INT
    q_start = 0
    for op, ln in zip(ops, lens):
      if op == Cigar.SOFT_CLIP:
        q_start += int(ln)
      elif op != Cigar.HARD_CLIP:
        break
    q_end = len(seq_codes)
    for op, ln in zip(ops[::-1], lens[::-1]):
      if op == Cigar.SOFT_CLIP:
        q_end -= int(ln)
      elif op != Cigar.HARD_CLIP:
        break
    col_start = int(np.flatnonzero(read_idx == q_start)[0])
    col_end = int(np.flatnonzero(read_idx == q_end - 1)[0]) + 1
    if truth_range is not None:
      if ops[0] == Cigar.SOFT_CLIP:
        truth_range['begin'] += int(lens[0])
      if ops[-1] == Cigar.SOFT_CLIP:
        truth_range['end'] -= int(lens[-1])
    sl = slice(col_start, col_end)
    new_bases = new_bases[sl]
    new_pw = new_pw[sl]
    new_ip = new_ip[sl]
    exp_ops = exp_ops[sl]
    ccs_idx = ccs_idx[sl]

  # Indent to reference coordinate zero with REF_SKIP columns.
  if record.pos:
    indent = record.pos
    new_bases = np.concatenate(
        [np.zeros(indent, dtype=np.uint8), new_bases]
    )
    exp_ops = np.concatenate(
        [np.full(indent, int(Cigar.REF_SKIP), dtype=np.uint8), exp_ops]
    )
    new_pw = np.concatenate([np.zeros(indent, np.int32), new_pw])
    new_ip = np.concatenate([np.zeros(indent, np.int32), new_ip])
    ccs_idx = np.concatenate([np.full(indent, -1, np.int64), ccs_idx])

  return AlignedRead(
      name=record.qname,
      bases=new_bases,
      cigar=exp_ops,
      pw=new_pw,
      ip=new_ip,
      sn=sn,
      strand=strand,
      ccs_idx=ccs_idx,
      truth_range=truth_range,
  )


def construct_ccs_read(record: BamRecord) -> AlignedRead:
  """Builds the CCS draft read with base qualities and aux tags
  (reference: pre_lib.py:966-998)."""
  seq_codes = np.frombuffer(record.seq.encode('ascii'), dtype=np.uint8)
  n = len(seq_codes)
  tags = record.tags
  return AlignedRead(
      name=record.qname,
      bases=constants.VOCAB_LUT[seq_codes].copy(),
      cigar=np.zeros(n, dtype=np.uint8),  # all MATCH
      pw=np.zeros(n, dtype=np.int32),
      ip=np.zeros(n, dtype=np.int32),
      sn=np.zeros(4, dtype=np.float32),
      strand=constants.Strand.UNKNOWN,
      ec=tags.get('ec'),
      np_num_passes=tags.get('np'),
      rq=tags.get('rq'),
      rg=tags.get('RG'),
      ccs_idx=np.arange(n, dtype=np.int64),
      base_quality_scores=(
          record.quals.astype(np.int64)
          if record.quals is not None
          else np.zeros(n, dtype=np.int64)
      ),
  )
