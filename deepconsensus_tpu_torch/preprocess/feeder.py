"""ZMW stream assembly for inference: subread groups + CCS draft.

Equivalent of the reference's create_proc_feeder/subreads_to_dc_example
(reference: deepconsensus/preprocess/pre_lib.py:1279-1384) on top of the
dependency-free BAM reader.
"""
from __future__ import annotations

from collections import Counter
from typing import Iterator, List, Optional, Tuple

import numpy as np

from deepconsensus_tpu_torch.io import bam
from deepconsensus_tpu_torch.preprocess.alignment import (
    AlignedRead,
    construct_ccs_read,
    expand_aligned_record,
)
from deepconsensus_tpu_torch.preprocess.pileup import FeatureLayout, Pileup
from deepconsensus_tpu_torch.preprocess.spacing import space_out_reads


ZmwInput = Tuple[List[AlignedRead], str, FeatureLayout, str,
                 Optional[np.ndarray]]


def create_proc_feeder(
    subreads_to_ccs: str,
    ccs_bam: str,
    layout: FeatureLayout,
    ins_trim: int = 0,
    use_ccs_smart_windows: bool = False,
    limit: int = 0,
):
  """Returns (generator_fn, counter) yielding per-ZMW inference work
  items. Fail-fast: a decode or expansion failure raises.
  use_ccs_smart_windows takes each ZMW's window widths from its CCS
  record's `wl` tag (widths in unspaced CCS bases). The BAMs open (and,
  with the native decoder, inflate) here; generator_fn.bam_decoder is
  'native' when both decoded natively, else 'python'."""
  main_counter: Counter = Counter()
  grouper = bam.SubreadGrouper(subreads_to_ccs)
  ccs_reader = bam.BamReader(ccs_bam)

  def proc_feeder() -> Iterator[ZmwInput]:
    ccs_iter = iter(ccs_reader)
    for read_set in grouper:
      main_counter['n_zmw_processed'] += 1
      ccs_seqname = read_set[0].reference_name
      # The ccs bam is ordered like the subread bam; skip CCS reads with
      # no mapped subreads (reference: pre_lib.py:1320-1326).
      for ccs_record in ccs_iter:
        if ccs_record.qname == ccs_seqname:
          break
      else:
        raise ValueError(f'ccs bam does not contain {ccs_seqname}')
      subreads = [
          expand_aligned_record(rec, ins_trim=ins_trim, counter=main_counter)
          for rec in read_set
      ]
      subreads.append(construct_ccs_read(ccs_record))
      window_widths = None
      if use_ccs_smart_windows:
        window_widths = np.asarray(ccs_record.get_tag('wl'))
      main_counter['n_zmw_inference'] += 1
      main_counter['n_zmw_pass'] += 1
      yield (subreads, ccs_seqname, layout, 'inference', window_widths)
      if limit and main_counter['n_zmw_pass'] >= limit:
        break

  proc_feeder.bam_decoder = (
      'native' if grouper.reader.decoder == ccs_reader.decoder == 'native'
      else 'python')
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
