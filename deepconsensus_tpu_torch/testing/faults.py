"""Fault injection into input files, for tests and chip runs.

Copies of the reference repository's scripts/inject_faults.py
`corrupt_zmw`, `truncate_file` and `corrupt_bam_record` on the port's
BAM reader and writers (the originals import the reference package).
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from deepconsensus_tpu_torch.io import bam as bam_lib
from deepconsensus_tpu_torch.io.bam_writer import BamWriter, BgzfWriter

BAM_RECORD_MODES = ('read_name_zero', 'read_name_overrun', 'cigar_overrun',
                    'block_size_inflate')


def corrupt_zmw(in_bam: str, out_bam: str, zmw: int,
                drop_tags: Sequence[str] = ('pw',)) -> int:
  """Re-encodes in_bam with drop_tags removed from the records of one
  ZMW (its `zm` tag). Dropping 'pw' makes expand_aligned_record raise
  KeyError('pw') for exactly that molecule: the canonical per-ZMW
  featurize fault. Returns the number of records corrupted."""
  reader = bam_lib.BamReader(in_bam)
  # The reader keeps no reference lengths; 0 round-trips the header.
  writer = BamWriter(out_bam, header_text=reader.header_text,
                     references=[(name, 0) for name in reader.references])
  n_corrupted = 0
  with reader:
    for rec in reader:
      tags = dict(rec.tags)
      if int(tags.get('zm', -1)) == zmw:
        for tag in drop_tags:
          tags.pop(tag, None)
        n_corrupted += 1
      writer.write(
          rec.qname, rec.seq, rec.quals, tags=tags, flag=rec.flag,
          ref_id=rec.ref_id, pos=rec.pos,
          cigar=list(zip(rec.cigar_ops.tolist(), rec.cigar_lens.tolist())))
  writer.close()
  return n_corrupted


def truncate_file(path: str, fraction: float = 0.5,
                  keep_bytes: Optional[int] = None) -> int:
  """Truncates path mid-stream; returns the new size."""
  size = os.path.getsize(path)
  keep = keep_bytes if keep_bytes is not None else max(1, int(size * fraction))
  with open(path, 'r+b') as f:
    f.truncate(keep)
  return keep


def corrupt_bam_record(in_bam: str, out_bam: str, record_index: int,
                       mode: str = 'read_name_zero') -> int:
  """Corrupts exactly one record of a BAM at the uncompressed layer and
  re-BGZFs the stream (valid blocks and EOF marker, so the damage tests
  the record decoder, not the gzip layer). The record-body modes
  (read_name_zero, read_name_overrun, cigar_overrun) keep the
  block_size framing: the reader raises a recoverable CorruptInputError
  and can keep streaming. block_size_inflate breaks the framing itself
  (a stream-level fault). Returns the decompressed byte offset of the
  corrupted record."""
  raw = bytearray(bam_lib.bgzf_decompress_file_py(in_bam))
  if raw[:4] != b'BAM\x01':
    raise ValueError(f'{in_bam}: not a BAM file')
  (l_text,) = np.frombuffer(raw[4:8], dtype='<i4')
  pos = 8 + int(l_text)
  (n_ref,) = np.frombuffer(raw[pos:pos + 4], dtype='<i4')
  pos += 4
  for _ in range(int(n_ref)):
    (l_name,) = np.frombuffer(raw[pos:pos + 4], dtype='<i4')
    pos += 4 + int(l_name) + 4
  index = 0
  while pos < len(raw):
    (block_size,) = np.frombuffer(raw[pos:pos + 4], dtype='<i4')
    if index == record_index:
      body = pos + 4
      if mode == 'read_name_zero':
        raw[body + 8] = 0
      elif mode == 'read_name_overrun':
        raw[body + 8] = 0xFF
      elif mode == 'cigar_overrun':
        raw[body + 12:body + 14] = (0xFFFF).to_bytes(2, 'little')
      elif mode == 'block_size_inflate':
        raw[pos:pos + 4] = (1 << 30).to_bytes(4, 'little')
      else:
        raise ValueError(f'unknown corrupt_bam_record mode {mode!r}')
      writer = BgzfWriter(out_bam)
      writer.write(bytes(raw))
      writer.close()
      return pos
    pos += 4 + int(block_size)
    index += 1
  raise IndexError(
      f'{in_bam}: record_index {record_index} out of range ({index} records)')
