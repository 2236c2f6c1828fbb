"""`preprocess`: BAMs -> per-split TFRecord shards + a summary JSON.

A copy of the JAX package's preprocess/driver.py (the reference's
preprocess binary, deepconsensus/preprocess/preprocess.py:63-361): an
optional worker pool featurizes ZMWs while this process stays the only
writer, '@split' in the output path expands per split, and a JSON
summary combines the counters, the layout and the inputs. The pool is a
`spawn` context (the caller may hold threads and a CUDA context) and is
closed and joined on every exit path; its `imap` keeps the feeder's
order, so the shards are the same bytes with and without it.
"""
from __future__ import annotations

import collections
import json
import multiprocessing
import os
from typing import Dict, List, Optional, Tuple

from deepconsensus_tpu_torch import constants
from deepconsensus_tpu_torch.io.tfrecord import TFRecordWriter
from deepconsensus_tpu_torch.models.config import DEFAULT_MAX_LENGTH
from deepconsensus_tpu_torch.preprocess.feeder import (
    create_proc_feeder,
    reads_to_pileup,
)
from deepconsensus_tpu_torch.preprocess.pileup import FeatureLayout


def _process_zmw(args) -> Tuple[List[bytes], str, Dict[str, int]]:
  """Featurizes one ZMW into serialized examples (worker side)."""
  subreads, name, layout, split, window_widths = args
  pileup = reads_to_pileup(subreads, name, layout, window_widths)
  serialized = [w.to_example().serialize() for w in pileup.iter_windows()]
  return serialized, split, dict(pileup.counter)


def run_preprocess(
    subreads_to_ccs: str,
    ccs_bam: str,
    output: str,
    max_passes: int = 20,
    example_width: int = DEFAULT_MAX_LENGTH,
    use_ccs_bq: bool = False,
    ins_trim: int = 5,
    use_ccs_smart_windows: bool = False,
    truth_bed: Optional[str] = None,
    truth_to_ccs: Optional[str] = None,
    truth_split: Optional[str] = None,
    limit: int = 0,
    cpus: int = 0,
    shard: Optional[tuple] = None,
    compression: str = 'BGZF',
) -> Dict[str, int]:
  """Writes examples to `output` ('@split' expands to train/eval/test
  with truth, else to inference) and returns the summary.

  cpus > 1 featurizes in that many worker processes. compression: 'BGZF'
  (default) writes .gz shards as BGZF blocks, still valid gzip for any
  TFRecord reader; 'GZIP' a single-member stream like the reference's TF
  writer. Training windows wider than example_width are dropped, as in
  the reference (n_examples_overflow).
  """
  is_training = bool(truth_bed and truth_to_ccs and truth_split)
  splits = ('train', 'eval', 'test') if is_training else ('inference',)
  if '@split' not in output and is_training:
    raise ValueError('training output path must contain @split')

  layout = FeatureLayout(max_passes, example_width, use_ccs_bq)
  feeder, counter = create_proc_feeder(
      subreads_to_ccs=subreads_to_ccs,
      ccs_bam=ccs_bam,
      layout=layout,
      ins_trim=ins_trim,
      use_ccs_smart_windows=use_ccs_smart_windows,
      truth_bed=truth_bed,
      truth_to_ccs=truth_to_ccs,
      truth_split=truth_split,
      limit=limit,
      shard=shard,
  )

  writers = {}
  for split in splits:
    path = output.replace('@split', split)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    writers[split] = TFRecordWriter(
        path, compression=compression if path.endswith('.gz') else None)

  agg: collections.Counter = collections.Counter()

  def consume(result):
    serialized, split, zmw_counter = result
    agg.update(zmw_counter)
    for record in serialized:
      writers[split].write(record)
      agg[f'n_examples_{split}'] += 1
      agg['n_examples'] += 1

  try:
    if cpus and cpus > 1:
      # Leaving the block terminates and joins the workers, also when
      # the feeder or a worker raised.
      with multiprocessing.get_context('spawn').Pool(cpus) as pool:
        for result in pool.imap(_process_zmw, feeder(), chunksize=4):
          consume(result)
        pool.close()
        pool.join()
    else:
      for item in feeder():
        consume(_process_zmw(item))
  finally:
    for w in writers.values():
      w.close()

  summary = dict(counter)
  summary.update(agg)
  summary.update(layout.to_dict())
  summary.update({
      'subreads_to_ccs': subreads_to_ccs,
      'ccs_bam': ccs_bam,
      'truth_to_ccs': truth_to_ccs or '',
      'truth_bed': truth_bed or '',
      'truth_split': truth_split or '',
      'ins_trim': str(ins_trim),
      'version': constants.__version__,
  })
  mode = 'training' if is_training else 'inference'
  summary_path = (
      output.replace('@split', 'summary').rsplit('.tfrecord', 1)[0]
      + f'.summary.{mode}.json'
  )
  os.makedirs(os.path.dirname(os.path.abspath(summary_path)), exist_ok=True)
  with open(summary_path, 'w') as f:
    json.dump(summary, f, indent=1)
  return summary
