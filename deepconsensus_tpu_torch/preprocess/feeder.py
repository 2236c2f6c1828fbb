"""ZMW stream assembly: subread groups + CCS draft + optional labels.

Equivalent of the reference's create_proc_feeder/subreads_to_dc_example
(reference: deepconsensus/preprocess/pre_lib.py:1279-1384) on top of the
dependency-free BAM reader, with the JAX package's fault paths
(deepconsensus_tpu/preprocess/feeder.py): CCS drafts from a FASTA,
`shard`, the per-ZMW quarantine and the resume skip. With truth_bed,
truth_to_ccs and truth_split (training mode) each ZMW also carries its
truth alignment as the label and its contig's train/eval/test split.
"""
from __future__ import annotations

import logging
from collections import Counter
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

from deepconsensus_tpu_torch import constants
from deepconsensus_tpu_torch.io import bam
from deepconsensus_tpu_torch.preprocess.alignment import (
    AlignedRead,
    construct_ccs_read,
    expand_aligned_record,
)
from deepconsensus_tpu_torch.preprocess.pileup import FeatureLayout, Pileup
from deepconsensus_tpu_torch.preprocess.spacing import space_out_reads

Issue = constants.Issue

log = logging.getLogger(__name__)


def read_truth_bedfile(truth_bed: str) -> Dict[str, Dict[str, Any]]:
  """ccs_seqname -> {contig, begin, end} (reference: pre_lib.py:1017-1025)."""
  bed_coords = {}
  with open(truth_bed) as bedfile:
    for line in bedfile:
      contig, begin, end, ccs_seqname = line.strip().split('\t')[:4]
      bed_coords[ccs_seqname] = {
          'contig': contig,
          'begin': int(begin),
          'end': int(end),
      }
  return bed_coords


def read_truth_split(split_fname: str) -> Dict[str, str]:
  """contig -> train/eval/test, by the genome the file's path names
  (chm13/hg00/human or maize; reference: pre_lib.py:1028-1058)."""
  lower = split_fname.lower()
  if any(x in lower for x in ('chm13', 'hg00', 'human')):
    genome = 'HUMAN'
  elif 'maize' in lower:
    genome = 'MAIZE'
  else:
    raise ValueError(
        f'{split_fname} does not correspond to a known genome; expected the '
        'filename to contain one of chm13/hg00/human/maize'
    )
  split_regions = {}
  for chrom in constants.TRAIN_REGIONS[genome]:
    split_regions[chrom] = 'train'
  for chrom in constants.EVAL_REGIONS[genome]:
    split_regions[chrom] = 'eval'
  for chrom in constants.TEST_REGIONS[genome]:
    split_regions[chrom] = 'test'
  contig_split = {}
  with open(split_fname) as f:
    for line in f:
      contig, chrom = line.split()
      if chrom in split_regions:
        contig_split[contig] = split_regions[chrom]
  return contig_split


def fetch_label_alignment(
    ccs_seqname: str,
    truth_by_ref: Dict[str, List[bam.BamRecord]],
    truth_range: Dict[str, Any],
) -> Union[constants.Issue, AlignedRead]:
  """Expands the truth alignment for one CCS (pre_lib.py:1001-1014)."""
  records = truth_by_ref.get(ccs_seqname)
  if not records:
    return Issue.TRUTH_ALIGNMENT_NOT_FOUND
  truth_alignment = records[0]
  if truth_alignment.is_supplementary:
    return Issue.SUPP_TRUTH_ALIGNMENT
  return expand_aligned_record(truth_alignment, truth_range=truth_range)


ZmwInput = Tuple[List[AlignedRead], str, FeatureLayout, str,
                 Optional[np.ndarray]]


def _fasta_ccs_iter(path: str):
  """Pseudo CCS records from a FASTA (no qualities, no tags): the
  `ccs_fasta` input."""
  from deepconsensus_tpu_torch.io import fastx

  for name, seq in fastx.read_fasta(path).items():
    yield bam.BamRecord(
        qname=name, flag=4, ref_id=-1, pos=0, mapq=255,
        cigar_ops=np.empty(0, dtype=np.uint8),
        cigar_lens=np.empty(0, dtype=np.int32), seq=seq, quals=None,
        tags={})


def create_proc_feeder(
    subreads_to_ccs: str,
    ccs_bam: Optional[str],
    layout: FeatureLayout,
    ins_trim: int = 0,
    use_ccs_smart_windows: bool = False,
    truth_bed: Optional[str] = None,
    truth_to_ccs: Optional[str] = None,
    truth_split: Optional[str] = None,
    limit: int = 0,
    ccs_fasta: Optional[str] = None,
    shard: Optional[Tuple[int, int]] = None,
    quarantine=None,
    resume_skip_groups: int = 0,
    max_record_bytes: int = bam.DEFAULT_MAX_RECORD_BYTES,
):
  """Returns (generator_fn, counter) yielding per-ZMW work items: the
  expanded reads (the label last in training mode), the name, the
  layout, the split ('inference' without truth) and the window widths.
  The BAMs open (and, with the native decoder, inflate) here;
  generator_fn.bam_decoder is 'native' when every BAM decoded natively,
  else 'python'.

  use_ccs_smart_windows takes each ZMW's window widths from its CCS
  record's `wl` tag. shard=(i, n) keeps only ZMWs with zm % n == i.
  ccs_fasta reads the CCS drafts from a FASTA in place of ccs_bam.

  quarantine (inference.faults.Quarantine) applies --on_zmw_error: a
  ZMW whose decode or expansion fails is dead-lettered and skipped or
  replaced by a CcsFallback item, yielded in the stream (callers
  dispatch on type). Without it a failure raises.

  resume_skip_groups skips the first N subread groups without expanding
  them (--resume past the committed groups; the lockstep CCS scan
  catches up on its own).

  truth_bed, truth_to_ccs and truth_split together turn on training
  mode: a ZMW without a truth range, a truth alignment, with a
  supplementary one or on a contig of no split is counted and dropped."""
  main_counter: Counter = Counter()
  # Under a quarantine the grouper yields a recoverable corrupt record
  # as a CorruptInputError item (handled below) instead of raising.
  grouper = bam.SubreadGrouper(subreads_to_ccs,
                               max_record_bytes=max_record_bytes,
                               skip_corrupt_records=quarantine is not None)
  decoders = [grouper.reader.decoder]
  if ccs_bam:
    ccs_reader = bam.BamReader(ccs_bam, max_record_bytes=max_record_bytes)
    decoders.append(ccs_reader.decoder)
    ccs_iter = iter(ccs_reader)
  elif ccs_fasta:
    ccs_iter = _fasta_ccs_iter(ccs_fasta)
  else:
    raise ValueError('need ccs_bam or ccs_fasta')

  is_training = bool(truth_bed and truth_to_ccs and truth_split)
  if is_training:
    truth_by_ref = bam.read_bam_by_name(truth_to_ccs)
    truth_ref_coords = read_truth_bedfile(truth_bed)
    truth_split_dict = read_truth_split(truth_split)

  def proc_feeder() -> Iterator[ZmwInput]:
    groups = iter(grouper)
    last_name: Optional[str] = None
    while True:
      try:
        read_set = next(groups)
      except StopIteration:
        break
      except Exception as e:
        # A stream-level decode failure (truncated or corrupt BGZF or
        # BAM framing) cannot be read past: record one decode fault and
        # end the feed. What was already yielded stays valid.
        main_counter['n_zmw_decode_failed'] += 1
        if quarantine is None:
          raise
        quarantine.handle(
            f'<stream after {last_name}>' if last_name else '<stream>',
            'decode', e, fallback=None)
        break
      if isinstance(read_set, bam.CorruptInputError):
        # A recoverable corrupt record: the grouper dropped its
        # molecule and kept streaming. No trustworthy name survives to
        # find a draft by, so the action degrades to skip.
        main_counter['n_corrupt_records'] += 1
        quarantine.handle(
            read_set.zmw or (f'<record after {last_name}>'
                             if last_name else '<record>'),
            'decode', read_set, fallback=None)
        continue
      main_counter['n_zmw_processed'] += 1
      if main_counter['n_zmw_processed'] <= resume_skip_groups:
        main_counter['n_zmw_resume_skipped'] += 1
        continue
      ccs_seqname = read_set[0].reference_name
      last_name = ccs_seqname
      if shard is not None:
        # The lockstep CCS scan below skips a sharded-out ZMW's draft
        # on its own, so it costs no expansion work.
        try:
          zm = int(ccs_seqname.split('/')[1])
        except (IndexError, ValueError):
          raise ValueError(
              f'shard={shard} requires PacBio movie/zm/ccs read names '
              f'to extract the zm hole number; got {ccs_seqname!r}')
        if zm % shard[1] != shard[0]:
          main_counter['n_zmw_sharded_out'] += 1
          continue
      # The draft comes first, so an expansion failure still has it for
      # ccs-fallback. The CCS stream is ordered like the subreads; skip
      # drafts with no mapped subreads (reference: pre_lib.py:1320-1326).
      ccs_record = None
      try:
        for candidate in ccs_iter:
          if candidate.qname == ccs_seqname:
            ccs_record = candidate
            break
        else:
          raise ValueError(f'ccs bam does not contain {ccs_seqname}')
        subreads = [
            expand_aligned_record(rec, ins_trim=ins_trim,
                                  counter=main_counter)
            for rec in read_set
        ]
        subreads.append(construct_ccs_read(ccs_record))
        window_widths = None
        if use_ccs_smart_windows:
          window_widths = np.asarray(ccs_record.get_tag('wl'))
      except Exception as e:
        if quarantine is None:
          raise
        fallback = None
        if ccs_record is not None:
          def fallback(rec=ccs_record):
            from deepconsensus_tpu_torch.inference import faults

            return faults.fallback_from_record(rec)
        item = quarantine.handle(ccs_seqname, 'featurize', e,
                                 fallback=fallback)
        if item is not None:
          yield item
        continue

      if is_training:
        truth_range = truth_ref_coords.get(ccs_seqname)
        if not truth_range:
          log.info('No truth_range defined for %s.', ccs_seqname)
          main_counter['n_zmw_missing_truth_range'] += 1
          continue
        label = fetch_label_alignment(ccs_seqname, truth_by_ref, truth_range)
        if label is Issue.TRUTH_ALIGNMENT_NOT_FOUND:
          log.info('Unable to fetch label alignment for %s.', ccs_seqname)
          main_counter['n_zmw_no_label_alignment'] += 1
          continue
        if label is Issue.SUPP_TRUTH_ALIGNMENT:
          main_counter['n_zmw_truth_label_supp_alignment'] += 1
          continue
        subreads.append(label)
        split = truth_split_dict.get(truth_range['contig'])
        if not split:
          log.info('No split defined for %s.', ccs_seqname)
          main_counter['n_zmw_missing_contig_split'] += 1
          continue
      else:
        split = 'inference'
      main_counter[f'n_zmw_{split}'] += 1
      main_counter['n_zmw_pass'] += 1
      yield (subreads, ccs_seqname, layout, split, window_widths)
      if limit and main_counter['n_zmw_pass'] >= limit:
        break

  proc_feeder.bam_decoder = (
      'native' if all(d == 'native' for d in decoders) else 'python')
  return proc_feeder, main_counter


def reads_to_pileup(
    subreads: List[AlignedRead],
    ccs_seqname: str,
    layout: FeatureLayout,
    window_widths: Optional[np.ndarray] = None,
) -> Pileup:
  """Spaces a ZMW's reads into a Pileup (pre_lib.py:1370-1384)."""
  spaced = space_out_reads(subreads)
  return Pileup(
      name=ccs_seqname,
      reads=spaced,
      layout=layout,
      window_widths=window_widths,
  )
