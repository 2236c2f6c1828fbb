"""TFRecord reader/writer with optional gzip compression.

Copy of the reference package's io/tfrecord.py: whole shards decode in
the native library (deepconsensus_tpu_torch/native) when asked and it
builds, crc32c runs there too, and the pure-Python streaming reader
and table-driven CRC stay as the fallback.

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


def _crc32c_py(data: bytes, value: int = 0) -> int:
  crc = value ^ 0xFFFFFFFF
  table = _CRC_TABLE
  for b in data:
    crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
  return crc ^ 0xFFFFFFFF


def crc32c(data: bytes, value: int = 0) -> int:
  try:
    from deepconsensus_tpu_torch import native

    result = native.crc32c(data, value)
    if result is not None:
      return result
  # The native CRC is an accelerator: any failure of it falls back to
  # the pure-Python CRC.
  except Exception:  # pragma: no cover
    pass
  return _crc32c_py(data, value)


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


# Whole-shard native decode reads the full decompressed shard into
# memory (transiently about twice: the C output buffer plus the Python
# record list); skip it for shards that would be unreasonable on the
# host (streaming handles any size). The compressed cap is a cheap
# pre-check; the decompressed cap is the real bound, probed from BGZF
# per-block ISIZE fields without inflating anything.
_NATIVE_MAX_COMPRESSED_BYTES = 512 * 1024 * 1024
_NATIVE_MAX_DECOMPRESSED_BYTES = 1024 * 1024 * 1024


def bgzf_decompressed_size(path: str) -> Optional[int]:
  """Total decompressed size of a BGZF file by summing block ISIZEs.

  Seeks block to block using the BSIZE extra subfield: two small reads
  per 64 KiB block, no inflation. Returns None unless every member is
  a standard BGZF block (a partial sum, or a gzip footer ISIZE taken
  mod 2^32, would under-report), so non-conforming files report
  unknown and the native decoder's in-C output cap enforces the
  bound."""
  try:
    with open(path, 'rb') as f:
      total = 0
      while True:
        start = f.tell()
        hdr = f.read(12)
        if not hdr:
          return total
        # gzip magic, deflate, FEXTRA set.
        if len(hdr) < 12 or hdr[:4] != b'\x1f\x8b\x08\x04':
          return None
        xlen = int.from_bytes(hdr[10:12], 'little')
        extra = f.read(xlen)
        if len(extra) < xlen:
          return None
        # Walk the FEXTRA subfields (SI1, SI2, u16 SLEN, data) for the
        # BGZF 'BC' field; other subfields may come in any order.
        bsize = None
        off = 0
        while off + 4 <= xlen:
          si, slen = extra[off:off + 2], int.from_bytes(
              extra[off + 2:off + 4], 'little')
          off += 4
          if off + slen > xlen:
            return None  # subfield overruns XLEN: malformed
          if si == b'BC' and slen == 2:
            bsize = int.from_bytes(extra[off:off + 2], 'little') + 1
          off += slen
        if bsize is None or off != xlen:
          return None
        f.seek(start + bsize - 4)
        isize = f.read(4)
        if len(isize) < 4:
          return None  # truncated final block
        total += int.from_bytes(isize, 'little')
  except OSError:
    return None


class TFRecordReader:
  """Iterates serialized records from a TFRecord file.

  Single-pass on every path: a second iteration yields nothing. The
  length CRC is always verified before the payload is allocated; the
  payload CRC only with check_crc.

  native_decode=True decodes the whole shard in one native call
  (parallel BGZF inflate + C record framing, which checks both CRCs of
  every frame's length). It holds the shard's records in memory, so
  callers consume shards one at a time; the streaming path holds only
  small buffers. check_crc or any native failure falls back to
  streaming, which raises typed errors on corrupt input.
  """

  def __init__(self, path: str, compression: Optional[str] = None,
               check_crc: bool = False, native_decode: bool = False,
               native_threads: int = 4,
               max_record_bytes: int = DEFAULT_MAX_RECORD_BYTES):
    if compression is None and path.endswith('.gz'):
      compression = 'GZIP'
    os.stat(path)  # fail fast on missing/unreadable paths (open is lazy)
    self._path = path
    self._compressed = compression in ('GZIP', 'BGZF')
    self._native = native_decode and not check_crc
    self._native_threads = native_threads
    self._f = None  # streaming handle, opened lazily on first use
    self._consumed = False
    self._check_crc = check_crc
    self._max_record_bytes = int(max_record_bytes)
    self.decoder: Optional[str] = None  # 'native' | 'python' once read

  def _native_records(self) -> Optional[List[bytes]]:
    try:
      if os.path.getsize(self._path) > _NATIVE_MAX_COMPRESSED_BYTES:
        return None
      if self._compressed:
        # Cheap pre-gate, exact for conforming BGZF; for other gzip the
        # in-C max_out cap below is the enforcement point.
        dsize = bgzf_decompressed_size(self._path)
        if dsize is not None and dsize > _NATIVE_MAX_DECOMPRESSED_BYTES:
          return None
      from deepconsensus_tpu_torch import native

      return native.read_tfrecord_records(
          self._path, n_threads=self._native_threads,
          compressed=self._compressed,
          max_out=_NATIVE_MAX_DECOMPRESSED_BYTES)
    # The native reader is an accelerator: None routes to the Python
    # decode path, which raises real corruption as CorruptInputError.
    except Exception:  # pragma: no cover - any native failure -> fallback
      return None

  def __iter__(self) -> Iterator[bytes]:
    if self._consumed:
      return
    if self._native:
      records = self._native_records()
      if records is not None:
        self._consumed = True
        self.decoder = 'native'
        yield from records
        return
    # Marked consumed as soon as streaming begins, as the native path
    # does, so a partly consumed reader yields nothing on re-iteration
    # whichever path ran.
    self._consumed = True
    self.decoder = 'python'
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
      # `length` bytes: a corrupt header must not OOM the host.
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
  """Yields all serialized records matching the glob pattern(s).

  Shards are consumed one at a time, so the native whole-shard decode
  is safe here (bounded by the largest single shard); the reader gates
  it off when check_crc is set."""
  for path in glob_paths(patterns):
    with TFRecordReader(path, check_crc=check_crc,
                        native_decode=True) as reader:
      yield from reader
