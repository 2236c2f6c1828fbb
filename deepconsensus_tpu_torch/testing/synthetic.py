"""Synthetic inputs for tests and chip runs: (subreads_to_ccs.bam,
ccs.bam) pairs and training TFRecord shards.

Copies of the reference repository's scripts/inject_faults.py
`write_synthetic_zmw_bams` and `write_synthetic_tfrecords` on top of the
port's own BAM and TFRecord writers (the originals import the reference
package). Content and block layout come from a numpy RandomState seed,
so the same arguments give the same bytes.
"""
from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from deepconsensus_tpu_torch.io.bam_writer import BamWriter
from deepconsensus_tpu_torch.io.example_proto import Example
from deepconsensus_tpu_torch.io.tfrecord import TFRecordWriter

_BASES = np.frombuffer(b'ACGT', dtype=np.uint8)
# Range of the seeded `wl` window widths (smart_windows=True): windows
# above 100 land in the 200 bucket, the rest in the 100 bucket.
SMART_WINDOW_RANGE = (60, 200)


def smart_window_widths(rng: np.random.RandomState, seq_len: int
                        ) -> np.ndarray:
  """Seeded window widths in SMART_WINDOW_RANGE that sum to seq_len
  (the last one takes the remainder)."""
  lo, hi = SMART_WINDOW_RANGE
  widths = []
  left = seq_len
  while left > hi:
    widths.append(rng.randint(lo, hi + 1))
    left -= widths[-1]
  if left:
    widths.append(left)
  return np.asarray(widths, dtype=np.int32)


def write_synthetic_zmw_bams(
    out_dir: str,
    n_zmws: int = 6,
    n_subreads: int = 3,
    seq_len: int = 120,
    movie: str = 'm00001_000000_000000',
    seed: int = 7,
    base_qual: int = 30,
    plain_names: bool = False,
    smart_windows: bool = False,
) -> Tuple[str, str]:
  """Writes (subreads_to_ccs.bam, ccs.bam) for n_zmws molecules.

  Subreads are exact copies of the draft CCS (all-match cigar) with
  deterministic pw/ip/sn tags, grouped per ZMW and flushed into their
  own BGZF block so truncate() faults mid-file. The ccs BAM carries
  quals=base_qual and ec/np/rq/RG tags. plain_names drops the PacBio
  movie/zmw/ccs structure (exercises the defensive zm-tag parse).
  smart_windows adds a `wl` tag of seeded window widths
  (`smart_window_widths`) to each CCS record; without it the bytes are
  those of the reference's writer.
  """
  rng = np.random.RandomState(seed)
  os.makedirs(out_dir, exist_ok=True)
  subreads_path = os.path.join(out_dir, 'subreads_to_ccs.bam')
  ccs_path = os.path.join(out_dir, 'ccs.bam')

  zmw_ids = [100 + i for i in range(n_zmws)]
  if plain_names:
    ccs_names = [f'read{z}' for z in zmw_ids]
  else:
    ccs_names = [f'{movie}/{z}/ccs' for z in zmw_ids]
  seqs = [
      bytes(_BASES[rng.randint(0, 4, seq_len)]).decode('ascii')
      for _ in zmw_ids
  ]

  sub_writer = BamWriter(
      subreads_path,
      header_text='@HD\tVN:1.5\tSO:unknown\n',
      references=[(name, seq_len) for name in ccs_names],
  )
  for i, (zmw, seq) in enumerate(zip(zmw_ids, seqs)):
    for k in range(n_subreads):
      if plain_names:
        qname = f'sub{zmw}_{k}'
      else:
        qname = f'{movie}/{zmw}/{k * 1000}_{k * 1000 + seq_len}'
      tags = {
          'zm': zmw,
          'pw': rng.randint(1, 6, seq_len).astype(np.int32),
          'ip': rng.randint(1, 9, seq_len).astype(np.int32),
          'sn': rng.uniform(4.0, 12.0, 4).astype(np.float32),
      }
      sub_writer.write(
          qname, seq, None, tags=tags, flag=0, ref_id=i, pos=0,
          cigar=[(0, seq_len)],
      )
    # One BGZF block per ZMW: a later truncate() then faults mid-file
    # instead of corrupting the first group.
    sub_writer.flush()
  sub_writer.close()

  ccs_writer = BamWriter(
      ccs_path,
      header_text='@HD\tVN:1.5\tSO:unknown\n'
      '@RG\tID:rg1\tPL:PACBIO\tSM:synthetic\n',
  )
  for name, seq in zip(ccs_names, seqs):
    tags = {
        'ec': float(n_subreads),
        'np': int(n_subreads),
        'rq': 0.99,
        'RG': 'rg1',
    }
    if smart_windows:
      tags['wl'] = smart_window_widths(rng, seq_len)
    ccs_writer.write(
        name, seq, np.full(seq_len, base_qual, dtype=np.uint8),
        tags=tags, flag=4,
    )
    ccs_writer.flush()
  ccs_writer.close()
  return subreads_path, ccs_path


def write_synthetic_tfrecords(
    out_dir: str,
    n_shards: int = 2,
    n_examples: int = 64,
    max_passes: int = 5,
    max_length: int = 20,
    seed: int = 3,
    compression: str = 'BGZF',
) -> List[str]:
  """Writes synthetic training shards shard-NNNNN.tfrecord.gz.

  Examples carry the fields models/data.py parses (subreads tensor of
  shape (4*max_passes+5, max_length, 1) for use_ccs_bq=False, label of
  shape (max_length,), plus name/num_passes/window_pos/quality). Bases,
  ccs and label agree per column, so training is well-posed. Examples
  are spread round-robin over n_shards. Returns the shard paths.
  """
  rng = np.random.RandomState(seed)
  os.makedirs(out_dir, exist_ok=True)
  total_rows = 4 * max_passes + 5
  paths = [
      os.path.join(out_dir, f'shard-{i:05d}.tfrecord.gz')
      for i in range(n_shards)
  ]
  writers = [TFRecordWriter(p, compression=compression) for p in paths]
  for i in range(n_examples):
    seq = rng.randint(1, 5, size=max_length)  # vocab ' ATCG' -> 1..4
    subreads = np.zeros((total_rows, max_length, 1), dtype=np.float32)
    for p in range(max_passes):
      subreads[p, :, 0] = seq                      # bases
      subreads[max_passes + p, :, 0] = rng.randint(1, 5, max_length)  # pw
      subreads[2 * max_passes + p, :, 0] = rng.randint(1, 9, max_length)
      subreads[3 * max_passes + p, :, 0] = 1 + (p % 2)  # strand
    subreads[4 * max_passes, :, 0] = seq             # ccs row
    subreads[4 * max_passes + 1:, :, 0] = rng.uniform(
        4.0, 12.0, size=(4, 1)
    )                                                # sn rows
    label = seq.astype(np.float32)
    ex = Example()
    ex.add_bytes('subreads/encoded',
                 [subreads.astype(np.float32).tobytes()])
    ex.add_int64('subreads/shape', list(subreads.shape))
    ex.add_bytes('label/encoded', [label.tobytes()])
    ex.add_int64('label/shape', [max_length])
    ex.add_bytes('name', [f'syn/{100 + i}/ccs-{i}'.encode('ascii')])
    ex.add_int64('subreads/num_passes', [max_passes])
    ex.add_int64('window_pos', [i * max_length])
    ex.add_int64('ccs_base_quality_scores', [30] * max_length)
    writers[i % n_shards].write(ex.serialize())
  for w in writers:
    w.close()
  return paths
