"""Pure-Python TFRecord reader/writer with optional gzip compression.

Copy of the reference package's io/tfrecord.py, trimmed to the
pure-Python path: the native whole-shard decoder and the native crc32c
are not carried over, so the reader always streams.

TFRecord framing per record: little-endian uint64 length, masked crc32c of
the length bytes, payload, masked crc32c of the payload. The reference
pipeline writes gzip-compressed TFRecord shards
(reference: deepconsensus/preprocess/preprocess.py:183-196,
models/data_providers.py:346).
"""
from __future__ import annotations

import glob as globlib
import gzip
import os
import struct
import zlib
from typing import Iterable, Iterator, List, Optional, Union

from deepconsensus_tpu_torch.faults import CorruptInputError

# Per-record allocation cap: the length field of a TFRecord frame is
# untrusted until its CRC verifies, and even a CRC-valid length must
# stay under this bound before the payload is allocated. A window
# example in this pipeline is ~100 KiB; 64 MiB is two-plus orders of
# magnitude of headroom.
DEFAULT_MAX_RECORD_BYTES = 64 << 20

# Exceptions the gzip/zlib machinery can raise mid-stream on corrupt or
# truncated compressed input.
_DECOMPRESS_ERRORS = (EOFError, gzip.BadGzipFile, zlib.error)

# ---------------------------------------------------------------------------
# crc32c (Castagnoli), table-driven.
# ---------------------------------------------------------------------------
_CRC_TABLE = []


def _build_table() -> None:
  poly = 0x82F63B78
  for i in range(256):
    crc = i
    for _ in range(8):
      crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
    _CRC_TABLE.append(crc)


_build_table()


def crc32c(data: bytes, value: int = 0) -> int:
  crc = value ^ 0xFFFFFFFF
  table = _CRC_TABLE
  for b in data:
    crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
  return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
  crc = crc32c(data)
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


class TFRecordWriter:
  """Writes TFRecord files; gzip-compressed when path ends with .gz.

  compression='BGZF' writes the gzip stream as BGZF blocks (64 KiB
  independent gzip members). BGZF is valid multi-member gzip, so the
  shard stays readable by any gzip TFRecord reader (including TF's).
  """

  def __init__(self, path: str, compression: Optional[str] = None):
    if compression is None and path.endswith('.gz'):
      compression = 'GZIP'
    if compression == 'BGZF':
      from deepconsensus_tpu_torch.io.bam_writer import BgzfWriter

      self._f = BgzfWriter(path)
    elif compression == 'GZIP':
      self._f = gzip.open(path, 'wb')
    else:
      self._f = open(path, 'wb')

  def write(self, record: bytes) -> None:
    header = struct.pack('<Q', len(record))
    self._f.write(header)
    self._f.write(struct.pack('<I', _masked_crc(header)))
    self._f.write(record)
    self._f.write(struct.pack('<I', _masked_crc(record)))

  def close(self) -> None:
    self._f.close()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()


class TFRecordReader:
  """Iterates serialized records from a TFRecord file, streaming.

  Single-pass: a second iteration yields nothing. The length CRC is
  always verified before the payload is allocated; the payload CRC
  only with check_crc.
  """

  def __init__(self, path: str, compression: Optional[str] = None,
               check_crc: bool = False,
               max_record_bytes: int = DEFAULT_MAX_RECORD_BYTES):
    if compression is None and path.endswith('.gz'):
      compression = 'GZIP'
    os.stat(path)  # fail fast on missing/unreadable paths (open is lazy)
    self._path = path
    self._compressed = compression in ('GZIP', 'BGZF')
    self._f = None  # opened lazily on first use
    self._consumed = False
    self._check_crc = check_crc
    self._max_record_bytes = int(max_record_bytes)

  def __iter__(self) -> Iterator[bytes]:
    if self._consumed:
      return
    self._consumed = True
    if self._f is None:
      self._f = (gzip.open(self._path, 'rb') if self._compressed
                 else open(self._path, 'rb'))

    def checked_read(n: int, what: str, offset: int) -> bytes:
      try:
        return self._f.read(n)
      except _DECOMPRESS_ERRORS as e:
        raise CorruptInputError(
            f'compressed TFRecord stream corrupt or truncated reading '
            f'{what} ({type(e).__name__}: {e})',
            path=self._path, offset=offset) from e

    offset = 0  # decompressed-stream offset of the current frame
    while True:
      header = checked_read(8, 'length header', offset)
      if not header:
        return
      if len(header) != 8:
        raise CorruptInputError(
            'truncated TFRecord length header',
            path=self._path, offset=offset)
      (length,) = struct.unpack('<Q', header)
      len_crc = checked_read(4, 'length crc', offset)
      if len(len_crc) != 4:
        raise CorruptInputError(
            'truncated TFRecord length crc', path=self._path, offset=offset)
      # The length field is untrusted until its CRC verifies; check it
      # unconditionally (not just under check_crc) BEFORE allocating
      # `length` bytes — a corrupt header must not OOM the host.
      if struct.unpack('<I', len_crc)[0] != _masked_crc(header):
        raise CorruptInputError(
            'TFRecord length crc mismatch', path=self._path, offset=offset)
      if length > self._max_record_bytes:
        raise CorruptInputError(
            f'TFRecord length {length} exceeds max_record_bytes '
            f'{self._max_record_bytes}', path=self._path, offset=offset)
      data = checked_read(length, 'payload', offset)
      data_crc = checked_read(4, 'payload crc', offset)
      if len(data) != length or len(data_crc) != 4:
        raise CorruptInputError(
            'truncated TFRecord payload', path=self._path, offset=offset)
      if self._check_crc:
        if struct.unpack('<I', data_crc)[0] != _masked_crc(data):
          raise CorruptInputError(
              'TFRecord data crc mismatch', path=self._path, offset=offset)
      offset += 8 + 4 + length + 4
      yield data

  def close(self) -> None:
    if self._f is not None:
      self._f.close()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()


def glob_paths(patterns: Union[str, Iterable[str]]) -> List[str]:
  if isinstance(patterns, str):
    patterns = [patterns]
  out: List[str] = []
  for p in patterns:
    matches = sorted(globlib.glob(p))
    out.extend(matches if matches else ([p] if '*' not in p else []))
  return out


def read_tfrecords(patterns: Union[str, Iterable[str]],
                   check_crc: bool = False) -> Iterator[bytes]:
  """Yields all serialized records matching the glob pattern(s), one
  shard after another."""
  for path in glob_paths(patterns):
    with TFRecordReader(path, check_crc=check_crc) as reader:
      yield from reader
