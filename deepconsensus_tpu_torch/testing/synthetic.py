"""Synthetic inputs for tests and chip runs: (subreads_to_ccs.bam,
ccs.bam) pairs, the truth that labels them for `preprocess`, and
training TFRecord shards.

`write_synthetic_zmw_bams` and `write_synthetic_tfrecords` are copies of
the reference repository's scripts/inject_faults.py writers on top of
the port's own BAM and TFRecord writers (the originals import the
reference package); `write_synthetic_truth` is the port's own. Content
and block layout come from a numpy RandomState seed, so the same
arguments give the same bytes.
"""
from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from deepconsensus_tpu_torch.io.bam import BamReader
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


# Chromosomes the truth split file maps the synthetic contigs to: one of
# each human split (constants.TRAIN/EVAL/TEST_REGIONS) and one of none.
TRUTH_CHROMS = {'train': '1', 'eval': '21', 'test': '19', 'none': 'chrUn'}
# What happens to the truth of ZMW i: i % 4 == 3 takes a fault in turn
# (no BED line, no alignment, a supplementary alignment, a contig of no
# split), the others a split.
TRUTH_FAULTS = ('no_bed', 'no_alignment', 'supplementary', 'no_split')


def truth_role(i: int) -> str:
  """The split ('train', 'eval', 'test') or the fault of ZMW i's truth."""
  if i % 4 == 3:
    return TRUTH_FAULTS[(i // 4) % 4]
  if i % 4 < 2:
    return 'train'
  return 'eval' if (i // 4) % 2 == 0 else 'test'


def _truth_alignment(rng: np.random.RandomState, ccs: str, sub_rate: float,
                     indel_rate: float) -> Tuple[str, List[Tuple[int, int]]]:
  """A truth sequence drawn from the CCS with seeded substitutions,
  insertions and deletions, and its CIGAR against the CCS (M, I, D; the
  first and last CCS bases always match)."""
  truth, ops = [], []
  n = len(ccs)
  for j, base in enumerate(ccs):
    r = rng.random_sample()
    edge = j in (0, n - 1)
    if not edge and r < indel_rate / 2:
      ops.append(2)  # the truth lacks this CCS base
      continue
    if not edge and r < indel_rate:
      truth.append(chr(_BASES[rng.randint(0, 4)]))
      ops.append(1)  # an extra truth base before this one
    if rng.random_sample() < sub_rate:
      others = [b for b in 'ACGT' if b != base]
      truth.append(others[rng.randint(0, 3)])
    else:
      truth.append(base)
    ops.append(0)
  cigar: List[Tuple[int, int]] = []
  for op in ops:
    if cigar and cigar[-1][0] == op:
      cigar[-1] = (op, cigar[-1][1] + 1)
    else:
      cigar.append((op, 1))
  return ''.join(truth), cigar


def write_synthetic_truth(
    ccs_bam: str,
    out_dir: str,
    seed: int = 13,
    sub_rate: float = 0.01,
    indel_rate: float = 0.01,
) -> Tuple[str, str, str]:
  """Writes the truth of `preprocess`'s training mode for the CCS reads
  of ccs_bam: (truth_to_ccs.bam, truth.bed, human_truth_split.tsv).

  Each CCS's truth is the CCS with seeded substitutions and indels,
  aligned to it (the CCS read is the reference) with its CIGAR, on a
  contig of its own at begin 1000 i; the split file maps each contig to
  a chromosome of its role (`truth_role`), and the reader infers the
  genome from the 'human' in the split file's name. A test fixture:
  every split and every label fault of the feeder occurs once 16 ZMWs
  are written.
  """
  rng = np.random.RandomState(seed)
  os.makedirs(out_dir, exist_ok=True)
  with BamReader(ccs_bam) as reader:
    ccs = [(r.qname, r.seq) for r in reader]
  bam_path = os.path.join(out_dir, 'truth_to_ccs.bam')
  bed_path = os.path.join(out_dir, 'truth.bed')
  split_path = os.path.join(out_dir, 'human_truth_split.tsv')
  writer = BamWriter(bam_path, header_text='@HD\tVN:1.5\tSO:unknown\n',
                     references=[(name, len(seq)) for name, seq in ccs])
  with open(bed_path, 'w') as bed, open(split_path, 'w') as split:
    for i, (name, seq) in enumerate(ccs):
      role = truth_role(i)
      truth, cigar = _truth_alignment(rng, seq, sub_rate, indel_rate)
      contig = f'ctg{i}'
      if role != 'no_alignment':
        writer.write(f'truth/{i}', truth, None, tags={},
                     flag=2048 if role == 'supplementary' else 0,
                     ref_id=i, pos=0, cigar=cigar)
      if role != 'no_bed':
        begin = 1000 * i
        bed.write(f'{contig}\t{begin}\t{begin + len(truth)}\t{name}\n')
      chrom = TRUTH_CHROMS['none' if role == 'no_split' else
                           role if role in TRUTH_CHROMS else 'train']
      split.write(f'{contig}\t{chrom}\n')
  writer.close()
  return bam_path, bed_path, split_path


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
