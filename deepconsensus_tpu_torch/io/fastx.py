"""FASTA and FASTQ reading (gzip-aware), hardened against untrusted input.

Port of deepconsensus_tpu/io/fastx.py's readers: a FASTQ record whose
separator line is not '+', mismatched sequence and quality lengths, EOF
mid-record, a line beyond the per-line cap, undecodable bytes or a
corrupt gzip stream raise CorruptInputError naming file and line.
`run` reads `ccs_fasta` with read_fasta.
"""
from __future__ import annotations

import gzip
import zlib
from typing import Dict, Iterator, Tuple

from deepconsensus_tpu_torch.faults import CorruptInputError

# Longest single line accepted (a CCS read is a few hundred KiB);
# readline() is capped at this so a stream without newlines cannot
# buffer unbounded bytes.
MAX_LINE_BYTES = 64 << 20

_DECOMPRESS_ERRORS = (EOFError, gzip.BadGzipFile, zlib.error)


def _open(path: str, mode: str = 'rt'):
  if path.endswith('.gz'):
    return gzip.open(path, mode)
  return open(path, mode)


def _readline(f, path: str, lineno: int) -> str:
  """Bounded readline: decompression and codec failures and over-long
  lines raise CorruptInputError naming file and line."""
  try:
    line = f.readline(MAX_LINE_BYTES)
  except _DECOMPRESS_ERRORS as e:
    raise CorruptInputError(
        f'compressed stream corrupt or truncated at line {lineno} '
        f'({type(e).__name__}: {e})', path=path, offset=lineno) from e
  except (UnicodeDecodeError, ValueError) as e:
    raise CorruptInputError(f'undecodable text at line {lineno} ({e})',
                            path=path, offset=lineno) from e
  if len(line) >= MAX_LINE_BYTES and not line.endswith('\n'):
    raise CorruptInputError(f'line {lineno} exceeds {MAX_LINE_BYTES} bytes',
                            path=path, offset=lineno)
  return line


def read_fasta(path: str) -> Dict[str, str]:
  """Loads a FASTA file into {name: sequence}."""
  seqs: Dict[str, str] = {}
  name = None
  parts = []
  lineno = 0
  with _open(path) as f:
    while True:
      lineno += 1
      line = _readline(f, path, lineno)
      if not line:
        break
      line = line.rstrip('\n')
      if line.startswith('>'):
        if name is not None:
          seqs[name] = ''.join(parts)
        fields = line[1:].split()
        if not fields:
          raise CorruptInputError(
              f'FASTA header with no name at line {lineno}',
              path=path, offset=lineno)
        name = fields[0]
        parts = []
      else:
        if name is None and line:
          raise CorruptInputError(
              f'FASTA sequence data before any header at line {lineno}',
              path=path, offset=lineno)
        parts.append(line)
  if name is not None:
    seqs[name] = ''.join(parts)
  return seqs


def read_fastq(path: str) -> Iterator[Tuple[str, str, str]]:
  """Yields (name, sequence, quality_string)."""
  with _open(path) as f:
    lineno = 0
    while True:
      header = _readline(f, path, lineno + 1)
      if not header:
        return
      seq = _readline(f, path, lineno + 2)
      plus = _readline(f, path, lineno + 3)
      qual = _readline(f, path, lineno + 4)
      if not header.startswith('@'):
        raise CorruptInputError(
            f'FASTQ record header at line {lineno + 1} does not start '
            f'with "@"', path=path, offset=lineno + 1)
      if not qual:
        raise CorruptInputError(
            f'truncated FASTQ record starting at line {lineno + 1} '
            f'(stream ended mid-record)', path=path, offset=lineno + 1)
      if not plus.startswith('+'):
        raise CorruptInputError(
            f'FASTQ separator at line {lineno + 3} is not "+"',
            path=path, offset=lineno + 3)
      seq = seq.rstrip('\n')
      qual = qual.rstrip('\n')
      if len(seq) != len(qual):
        raise CorruptInputError(
            f'FASTQ record at line {lineno + 1} has sequence length '
            f'{len(seq)} but quality length {len(qual)}',
            path=path, offset=lineno + 1)
      lineno += 4
      yield header.rstrip('\n')[1:], seq, qual
