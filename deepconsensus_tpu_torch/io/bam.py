"""Dependency-free BAM reading (BGZF + BAM record + aux tag parsing).

The reference relies on pysam/htslib for all BAM I/O
(reference: deepconsensus/preprocess/pre_lib.py:50-91,966-998). This
module implements the BAM spec (SAMv1, section 4) directly so the
framework needs no native htslib: BGZF files are concatenated gzip
members, which Python's gzip module decompresses transparently; records
are fixed-layout structs parsed with struct/numpy.

This copy keeps only the pure-Python gzip path (the reference package's
native BGZF decoder is not carried over).

Untrusted-input hardening: every length/count field read from the file
(block_size, l_text, n_ref, l_name, l_read_name, n_cigar_op, l_seq, tag
counts) is validated against the remaining buffer and a configurable
``max_record_bytes`` cap *before* any allocation, and every short read
is detected. Violations raise the typed
``deepconsensus_tpu_torch.faults.CorruptInputError`` (or its stream-level
subclass ``TruncatedBamError``) carrying file, byte offset, and read
context — never a bare ``struct.error``/``ValueError``/``MemoryError``.
Record-body damage inside intact framing is *recoverable*: the reader
is positioned at the next record when it raises, so callers (or
``skip_corrupt_records=True``) can keep streaming.
"""
from __future__ import annotations

import gzip
import struct
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from deepconsensus_tpu_torch import constants
from deepconsensus_tpu_torch.faults import CorruptInputError

# 4-bit encoded base alphabet from the SAM spec.
SEQ_NIBBLE = '=ACMGRSVTWYHKDBN'
_NIBBLE_LUT = np.frombuffer(SEQ_NIBBLE.encode('ascii'), dtype=np.uint8)

# flag bits
FUNMAP = 0x4
FREVERSE = 0x10
FSECONDARY = 0x100
FSUPPLEMENTARY = 0x800

_TAG_FMT = {
    ord('A'): ('c', 1),
    ord('c'): ('b', 1),
    ord('C'): ('B', 1),
    ord('s'): ('h', 2),
    ord('S'): ('H', 2),
    ord('i'): ('i', 4),
    ord('I'): ('I', 4),
    ord('f'): ('f', 4),
}

_B_DTYPES = {
    ord('c'): np.int8,
    ord('C'): np.uint8,
    ord('s'): np.int16,
    ord('S'): np.uint16,
    ord('i'): np.int32,
    ord('I'): np.uint32,
    ord('f'): np.float32,
}

# Ops consuming query bases / reference bases (SAMv1 table).
_QUERY_OPS = np.array([1, 1, 0, 0, 1, 0, 0, 1, 1, 0], dtype=bool)
_REF_OPS = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1, 0], dtype=bool)

# Default per-record allocation cap (--max_record_bytes). A real PacBio
# subread record is a few hundred KiB at most; 64 MiB leaves two orders
# of magnitude of headroom while keeping a flipped length byte from
# allocating gigabytes.
DEFAULT_MAX_RECORD_BYTES = 64 << 20

# Reference names are capped well above any real assembly's (a PacBio
# ccs reference name is ~40 chars); a corrupt l_name must not allocate.
_MAX_REF_NAME_BYTES = 65536
# n_ref guard: each reference entry needs >= 9 bytes of stream, so this
# cap can never reject a legitimate header that the stream can back.
_MAX_N_REF = 500_000_000

# Exceptions the gzip module (and the zlib machinery underneath it) can
# raise mid-stream on corrupt/truncated BGZF members.
_DECOMPRESS_ERRORS = (EOFError, gzip.BadGzipFile, zlib.error)


class TruncatedBamError(CorruptInputError):
  """The BAM stream ended mid-record (or mid-BGZF-block).

  Raised as a distinct type so the inference quarantine layer
  (inference/faults.py) can classify it as a decode-stage fault: a
  truncated stream cannot be advanced past, unlike a single malformed
  record (``recoverable`` is always False)."""


@dataclass
class BamRecord:
  """One BAM alignment record."""

  qname: str
  flag: int
  ref_id: int
  pos: int  # 0-based leftmost coordinate
  mapq: int
  cigar_ops: np.ndarray  # uint8 op codes
  cigar_lens: np.ndarray  # int32 lengths
  seq: str
  quals: Optional[np.ndarray]  # int32 phred values, None if absent (0xff)
  tags: Dict[str, Any] = field(default_factory=dict)
  reference_name: Optional[str] = None

  @property
  def is_unmapped(self) -> bool:
    return bool(self.flag & FUNMAP)

  @property
  def is_reverse(self) -> bool:
    return bool(self.flag & FREVERSE)

  @property
  def is_supplementary(self) -> bool:
    return bool(self.flag & FSUPPLEMENTARY)

  @property
  def is_secondary(self) -> bool:
    return bool(self.flag & FSECONDARY)

  @property
  def cigartuples(self) -> List[Tuple[int, int]]:
    return list(zip(self.cigar_ops.tolist(), self.cigar_lens.tolist()))

  def get_tag(self, name: str):
    return self.tags[name]

  def has_tag(self, name: str) -> bool:
    return name in self.tags

  @property
  def query_alignment_start(self) -> int:
    """Index of the first non-soft-clipped base of seq."""
    start = 0
    for op, ln in zip(self.cigar_ops, self.cigar_lens):
      if op == constants.Cigar.SOFT_CLIP:
        start += int(ln)
      elif op != constants.Cigar.HARD_CLIP:
        break
    return start

  @property
  def query_alignment_end(self) -> int:
    """One past the last non-soft-clipped base of seq."""
    end = len(self.seq)
    for op, ln in zip(self.cigar_ops[::-1], self.cigar_lens[::-1]):
      if op == constants.Cigar.SOFT_CLIP:
        end -= int(ln)
      elif op != constants.Cigar.HARD_CLIP:
        break
    return end

  def expanded_cigar(self) -> np.ndarray:
    """Per-position cigar ops (uint8), hard clips excluded."""
    keep = self.cigar_ops != constants.Cigar.HARD_CLIP
    return np.repeat(self.cigar_ops[keep], self.cigar_lens[keep])

  def aligned_index_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized equivalent of pysam get_aligned_pairs().

    Returns (read_idx, ref_idx): for every alignment column (expanded
    cigar without hard clips), the query index or -1, and the reference
    index or -1 (reference: pre_lib.py:1157-1161).
    """
    ops = self.expanded_cigar()
    q_mask = _QUERY_OPS[ops]
    r_mask = _REF_OPS[ops]
    read_idx = np.where(q_mask, np.cumsum(q_mask) - 1, -1).astype(np.int64)
    ref_idx = np.where(r_mask, self.pos + np.cumsum(r_mask) - 1, -1).astype(
        np.int64
    )
    return read_idx, ref_idx


def _parse_tags(buf: memoryview, path: Optional[str] = None,
                qname: Optional[str] = None) -> Dict[str, Any]:
  """Parses the aux-tag region of one record with full bounds checks.

  Every count/size field and string scan is validated against the
  buffer before use; violations raise CorruptInputError carrying the
  read name + file so one bad tag is attributable (recoverable: the
  caller's record framing is intact)."""
  tags: Dict[str, Any] = {}
  pos = 0
  n = len(buf)
  raw = bytes(buf)

  def corrupt(msg: str) -> CorruptInputError:
    return CorruptInputError(msg, path=path, zmw=qname, recoverable=True)

  while pos < n:
    if n - pos < 3:
      raise corrupt(
          f'{n - pos} trailing byte(s) after the last BAM tag')
    try:
      tag = raw[pos : pos + 2].decode('ascii')
    except UnicodeDecodeError:
      raise corrupt(f'non-ASCII BAM tag name {raw[pos:pos + 2]!r}')
    val_type = raw[pos + 2]
    pos += 3
    if val_type in _TAG_FMT:
      fmt, size = _TAG_FMT[val_type]
      if pos + size > n:
        raise corrupt(
            f'BAM tag {tag}:{chr(val_type)} overruns the record '
            f'(needs {size} byte(s), {n - pos} left)')
      (value,) = struct.unpack_from('<' + fmt, raw, pos)
      if val_type == ord('A'):
        try:
          value = value.decode('ascii')
        except UnicodeDecodeError:
          raise corrupt(f'non-ASCII value for BAM tag {tag}:A')
      pos += size
    elif val_type in (ord('Z'), ord('H')):
      end = raw.find(b'\x00', pos)
      if end < 0:
        raise corrupt(f'unterminated string for BAM tag {tag}')
      try:
        value = raw[pos:end].decode('ascii')
      except UnicodeDecodeError:
        raise corrupt(f'non-ASCII string for BAM tag {tag}')
      pos = end + 1
    elif val_type == ord('B'):
      if pos + 5 > n:
        raise corrupt(f'truncated B-array header for BAM tag {tag}')
      subtype = raw[pos]
      dtype = _B_DTYPES.get(subtype)
      if dtype is None:
        raise corrupt(
            f'unknown BAM B-array subtype {chr(subtype)!r} for tag {tag}')
      (count,) = struct.unpack_from('<I', raw, pos + 1)
      itemsize = np.dtype(dtype).itemsize
      if count * itemsize > n - pos - 5:
        raise corrupt(
            f'B-array count {count} for BAM tag {tag} overruns the '
            f'record ({count * itemsize} > {n - pos - 5} bytes)')
      value = np.frombuffer(
          raw, dtype=dtype, count=count, offset=pos + 5
      ).copy()
      pos += 5 + count * itemsize
    else:
      raise corrupt(
          f'unknown BAM tag type {chr(val_type)!r} (0x{val_type:02x}) '
          f'for tag {tag}')
    tags[tag] = value
  return tags


def parse_record(data: bytes, references: List[str],
                 path: Optional[str] = None,
                 offset: Optional[int] = None) -> BamRecord:
  """Parses one BAM alignment block (excluding the block_size prefix).

  All variable-length sections are bounds-checked against len(data)
  before any allocation; since the caller already capped len(data) at
  max_record_bytes, no parse can allocate beyond that. Violations raise
  a recoverable CorruptInputError (the record's framing was intact, so
  the stream can continue at the next record)."""
  n = len(data)

  def corrupt(msg: str, zmw: Optional[str] = None) -> CorruptInputError:
    return CorruptInputError(
        msg, path=path, offset=offset, zmw=zmw, recoverable=True)

  if n < 32:
    raise corrupt(f'BAM record body too short ({n} < 32 bytes)')
  (
      ref_id,
      pos,
      l_read_name,
      mapq,
      _bin,
      n_cigar_op,
      flag,
      l_seq,
      _next_ref,
      _next_pos,
      _tlen,
  ) = struct.unpack_from('<iiBBHHHiiii', data, 0)
  if l_read_name < 1:
    raise corrupt('BAM record with l_read_name == 0')
  if l_seq < 0:
    raise corrupt(f'negative BAM record l_seq {l_seq}')
  if pos < -1:
    raise corrupt(f'implausible BAM record pos {pos}')
  off = 32
  if off + l_read_name > n:
    raise corrupt(
        f'read name (l_read_name={l_read_name}) overruns the record')
  try:
    qname = data[off : off + l_read_name - 1].decode('ascii')
  except UnicodeDecodeError:
    raise corrupt('non-ASCII BAM read name')
  off += l_read_name
  if off + 4 * n_cigar_op > n:
    raise corrupt(
        f'cigar ({n_cigar_op} ops) overruns the record', zmw=qname)
  cigar_raw = np.frombuffer(data, dtype=np.uint32, count=n_cigar_op, offset=off)
  cigar_ops = (cigar_raw & 0xF).astype(np.uint8)
  cigar_lens = (cigar_raw >> 4).astype(np.int32)
  off += 4 * n_cigar_op
  n_seq_bytes = (l_seq + 1) // 2
  if off + n_seq_bytes + l_seq > n:
    raise corrupt(
        f'sequence/qualities (l_seq={l_seq}) overrun the record',
        zmw=qname)
  packed = np.frombuffer(data, dtype=np.uint8, count=n_seq_bytes, offset=off)
  nibbles = np.empty(n_seq_bytes * 2, dtype=np.uint8)
  nibbles[0::2] = packed >> 4
  nibbles[1::2] = packed & 0xF
  seq = _NIBBLE_LUT[nibbles[:l_seq]].tobytes().decode('ascii')
  off += n_seq_bytes
  quals_raw = np.frombuffer(data, dtype=np.uint8, count=l_seq, offset=off)
  # htslib marks absent qualities with 0xFF in EVERY byte; a legitimate
  # first qual of 0xFF alone must not be treated as missing.
  if l_seq and quals_raw[0] == 0xFF and np.all(quals_raw == 0xFF):
    quals = None
  else:
    quals = quals_raw.astype(np.int32)
  off += l_seq
  tags = _parse_tags(memoryview(data)[off:], path=path, qname=qname)
  ref_name = references[ref_id] if 0 <= ref_id < len(references) else None
  return BamRecord(
      qname=qname,
      flag=flag,
      ref_id=ref_id,
      pos=pos,
      mapq=mapq,
      cigar_ops=cigar_ops,
      cigar_lens=cigar_lens,
      seq=seq,
      quals=quals,
      tags=tags,
      reference_name=ref_name,
  )


class BamReader:
  """Streams records from a BAM file in file order.

  BGZF members stream through the gzip module.

  BamReader is its own iterator (``__iter__`` returns self): a
  recoverable CorruptInputError raised by ``next()`` leaves the stream
  positioned at the following record, so callers may catch it and keep
  iterating. ``skip_corrupt_records=True`` does that internally,
  counting skips in ``n_corrupt_records``. Stream-level damage
  (truncation, BGZF corruption, bad framing) raises TruncatedBamError /
  a non-recoverable CorruptInputError and ends the stream.
  """

  def __init__(self, path: str,
               max_record_bytes: int = DEFAULT_MAX_RECORD_BYTES,
               skip_corrupt_records: bool = False):
    self.path = path
    self.max_record_bytes = int(max_record_bytes)
    self.skip_corrupt_records = skip_corrupt_records
    self.n_corrupt_records = 0
    self._f = gzip.open(path, 'rb')
    magic = self._read(4, 'BAM magic')
    if magic != b'BAM\x01':
      raise CorruptInputError(
          f'not a BAM file (magic={magic!r})', path=path, offset=0)
    (l_text,) = struct.unpack('<i', self._read(4, 'header l_text', exact=True))
    if l_text < 0 or l_text > self.max_record_bytes:
      raise CorruptInputError(
          f'implausible BAM header text length {l_text} '
          f'(cap {self.max_record_bytes})', path=path, offset=4)
    self.header_text = self._read(
        l_text, 'header text', exact=True).decode('utf-8', errors='replace')
    (n_ref,) = struct.unpack('<i', self._read(4, 'n_ref', exact=True))
    if n_ref < 0 or n_ref > _MAX_N_REF:
      raise CorruptInputError(
          f'implausible BAM reference count {n_ref}', path=path)
    self.references: List[str] = []
    self.reference_lengths: List[int] = []
    for i in range(n_ref):
      (l_name,) = struct.unpack(
          '<i', self._read(4, f'reference {i} l_name', exact=True))
      if l_name < 1 or l_name > _MAX_REF_NAME_BYTES:
        raise CorruptInputError(
            f'implausible BAM reference name length {l_name} '
            f'for reference {i}', path=path)
      name_bytes = self._read(l_name, f'reference {i} name', exact=True)
      try:
        name = name_bytes[:-1].decode('ascii')
      except UnicodeDecodeError:
        raise CorruptInputError(
            f'non-ASCII name for BAM reference {i}', path=path)
      (l_ref,) = struct.unpack(
          '<i', self._read(4, f'reference {i} l_ref', exact=True))
      if l_ref < 0:
        raise CorruptInputError(
            f'negative length {l_ref} for BAM reference {name!r}',
            path=path)
      self.references.append(name)
      self.reference_lengths.append(l_ref)

  def _read(self, n: int, what: str, exact: bool = False) -> bytes:
    """Checked read: decompression errors become TruncatedBamError, and
    with exact=True a short read does too (naming path + offset)."""
    try:
      offset = self._f.tell()
      data = self._f.read(n)
    except _DECOMPRESS_ERRORS as e:
      raise TruncatedBamError(
          f'BGZF stream corrupt or truncated reading {what} '
          f'({type(e).__name__}: {e})', path=self.path) from e
    if exact and len(data) != n:
      raise TruncatedBamError(
          f'truncated BAM: short read of {what} '
          f'(wanted {n} bytes, got {len(data)})',
          path=self.path, offset=offset)
    return data

  def _skip_bytes(self, n: int, offset: int) -> None:
    """Consumes n stream bytes in bounded chunks (skipping an oversized
    record without allocating it)."""
    remaining = n
    while remaining > 0:
      chunk = self._read(min(remaining, 1 << 20), 'oversized record body')
      if not chunk:
        raise TruncatedBamError(
            f'truncated BAM: stream ended inside an oversized record '
            f'({remaining} of {n} bytes missing)',
            path=self.path, offset=offset)
      remaining -= len(chunk)

  def __iter__(self) -> Iterator[BamRecord]:
    return self

  def __next__(self) -> BamRecord:
    while True:
      offset = self._f.tell()
      size_bytes = self._read(4, 'record block_size')
      if not size_bytes:
        raise StopIteration
      if len(size_bytes) != 4:
        raise TruncatedBamError(
            'truncated BAM record header', path=self.path, offset=offset)
      (block_size,) = struct.unpack('<i', size_bytes)
      if block_size < 0:
        raise CorruptInputError(
            f'negative BAM record block_size {block_size}',
            path=self.path, offset=offset)
      if block_size > self.max_record_bytes:
        # The framing may still be intact (one inflated length field);
        # skip past the claimed extent in bounded chunks so the stream
        # survives without ever allocating block_size bytes.
        self._skip_bytes(block_size, offset)
        error: CorruptInputError = CorruptInputError(
            f'BAM record block_size {block_size} exceeds '
            f'max_record_bytes {self.max_record_bytes}',
            path=self.path, offset=offset, recoverable=True)
      elif block_size < 32:
        self._skip_bytes(block_size, offset)
        error = CorruptInputError(
            f'implausible BAM record block_size {block_size} (< 32)',
            path=self.path, offset=offset, recoverable=True)
      else:
        data = self._read(block_size, 'record body')
        if len(data) != block_size:
          raise TruncatedBamError(
              'truncated BAM record', path=self.path, offset=offset)
        try:
          return parse_record(
              data, self.references, path=self.path, offset=offset)
        except CorruptInputError as e:
          error = e
      self.n_corrupt_records += 1
      if self.skip_corrupt_records and error.recoverable:
        continue
      raise error

  def close(self) -> None:
    self._f.close()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()


class SubreadGrouper:
  """Yields the mapped subreads of one ZMW at a time.

  Relies on the input being grouped by the `zm` tag, as written by actc
  (reference: pre_lib.py:50-91).

  skip_corrupt_records=True turns a recoverable corrupt record into an
  in-stream CorruptInputError *event item* (callers dispatch on type):
  the in-progress molecule is dropped — its membership can no longer be
  trusted — and grouping resumes at the next parseable record, with any
  stragglers of the poisoned ZMW discarded. The event's ``zmw``
  attribute names the poisoned molecule when known. Without the flag,
  corrupt records propagate (historical fail-fast).
  """

  def __init__(self, subreads_to_ccs: str,
               max_record_bytes: int = DEFAULT_MAX_RECORD_BYTES,
               skip_corrupt_records: bool = False):
    self.reader = BamReader(subreads_to_ccs,
                            max_record_bytes=max_record_bytes)
    self._skip_corrupt = skip_corrupt_records
    self._iter = iter(self.reader)
    self._pending: List[BamRecord] = []
    self._zmw: Optional[int] = None

  def __iter__(self) -> Iterator[Any]:
    poisoned: Optional[int] = None
    while True:
      try:
        read = next(self._iter)
      except StopIteration:
        break
      except CorruptInputError as e:
        if not (self._skip_corrupt and e.recoverable):
          raise
        if e.zmw is None and self._pending:
          e.zmw = self._pending[0].reference_name
        # Drop the in-progress molecule: the corrupt record most likely
        # belonged to it, and a group with an unknown hole must not be
        # polished as if complete.
        poisoned = self._zmw
        self._pending = []
        self._zmw = None
        yield e
        continue
      if read.is_unmapped:
        continue
      try:
        zmw = int(read.get_tag('zm'))
      except (KeyError, TypeError, ValueError) as tag_err:
        error = CorruptInputError(
            f'subread {read.qname!r} lacks a usable zm tag '
            f'({type(tag_err).__name__}: {tag_err})',
            path=self.reader.path, zmw=read.reference_name,
            recoverable=True)
        if not self._skip_corrupt:
          raise error
        yield error
        continue
      if poisoned is not None:
        if zmw == poisoned:
          continue  # straggler of a dropped molecule
        poisoned = None
      if self._zmw is None:
        self._zmw = zmw
      if zmw == self._zmw:
        self._pending.append(read)
      else:
        group = self._pending
        self._pending = [read]
        self._zmw = zmw
        if group:
          yield group
    if self._pending:
      yield self._pending


def read_bam_by_name(path: str) -> Dict[str, List[BamRecord]]:
  """Loads a (small) BAM keyed by reference name, e.g. truth_to_ccs.

  Replaces pysam's indexed fetch(ccs_seqname) used for label lookup
  (reference: pre_lib.py:1001-1014) with a single in-memory pass.
  """
  by_ref: Dict[str, List[BamRecord]] = {}
  with BamReader(path) as reader:
    for record in reader:
      if record.is_unmapped or record.reference_name is None:
        continue
      by_ref.setdefault(record.reference_name, []).append(record)
  return by_ref
