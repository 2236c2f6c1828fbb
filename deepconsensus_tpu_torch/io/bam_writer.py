"""BAM writing: BGZF blocks + BAM record encoding + aux tags.

Counterpart of io/bam.py for the inference driver's .bam output mode
(reference: deepconsensus/inference/quick_inference.py:738-760 writes
pysam records with ec/np/rq/RG/zm tags). Unaligned records (flag 4,
ref -1) like the reference's output BAM.
"""
from __future__ import annotations

import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

BGZF_EOF = bytes.fromhex(
    '1f8b08040000000000ff0600424302001b0003000000000000000000'
)

_NIBBLE = {c: i for i, c in enumerate('=ACMGRSVTWYHKDBN')}


class BgzfWriter:
  """Writes BGZF-framed gzip blocks (max 64 KiB payload each).

  append=True continues an existing file (resume support): the caller
  must have truncated it to a block boundary (the progress manifest
  records flushed sizes, which flush() guarantees are boundaries).
  """

  MAX_BLOCK = 0xFF00

  def __init__(self, path: str, append: bool = False):
    self._f = open(path, 'ab' if append else 'wb')
    self._buf = bytearray()

  def write(self, data: bytes) -> None:
    self._buf += data
    while len(self._buf) >= self.MAX_BLOCK:
      self._flush_block(self._buf[: self.MAX_BLOCK])
      del self._buf[: self.MAX_BLOCK]

  def flush(self) -> None:
    """Flushes buffered payload as a (possibly short) block to the OS.
    BGZF permits arbitrary block boundaries, so the file is a valid
    prefix afterwards — the durability point for the progress
    manifest."""
    if self._buf:
      self._flush_block(bytes(self._buf))
      self._buf.clear()
    self._f.flush()

  def tell(self) -> int:
    """Byte size of the durable file prefix (call flush() first)."""
    return self._f.tell()

  def _flush_block(self, payload: bytes) -> None:
    compressor = zlib.compressobj(6, zlib.DEFLATED, -15)
    comp = compressor.compress(payload) + compressor.flush()
    # BSIZE field = total block size - 1; total = 18 header + comp + 8.
    bsize = len(comp) + 25
    block = (
        b'\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff'
        + struct.pack('<HHHH', 6, 0x4342, 2, bsize)
        + comp
        + struct.pack('<II', zlib.crc32(payload) & 0xFFFFFFFF, len(payload))
    )
    self._f.write(block)

  def close(self) -> None:
    if self._buf:
      self._flush_block(bytes(self._buf))
      self._buf.clear()
    self._f.write(BGZF_EOF)
    self._f.close()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()


def _encode_tag(name: str, value: Any) -> bytes:
  out = bytearray(name.encode('ascii'))
  if isinstance(value, float) or isinstance(value, np.floating):
    out += b'f' + struct.pack('<f', float(value))
  elif isinstance(value, (int, np.integer)):
    out += b'i' + struct.pack('<i', int(value))
  elif isinstance(value, str):
    out += b'Z' + value.encode('ascii') + b'\x00'
  elif isinstance(value, (list, tuple, np.ndarray)):
    arr = np.asarray(value)
    if arr.dtype.kind == 'f':
      out += b'B' + b'f' + struct.pack('<I', arr.size)
      out += arr.astype('<f4').tobytes()
    else:
      out += b'B' + b'i' + struct.pack('<I', arr.size)
      out += arr.astype('<i4').tobytes()
  else:
    # dclint: allow=typed-faults (output plane: the tag values are
    # produced by our own emit code, so this is a programmer error)
    raise ValueError(f'unsupported tag type for {name}: {type(value)}')
  return bytes(out)


def encode_record(
    qname: str,
    seq: str,
    quals: Optional[np.ndarray],
    flag: int = 4,
    tags: Optional[Dict[str, Any]] = None,
    ref_id: int = -1,
    pos: int = -1,
    mapq: Optional[int] = None,
    cigar: Optional[List[Tuple[int, int]]] = None,
) -> bytes:
  """Encodes one BAM record (unmapped by default; pass ref_id/pos/cigar
  for mapped records, e.g. the fault-injection harness's synthetic
  subreads-to-CCS alignments)."""
  name_b = qname.encode('ascii') + b'\x00'
  l_seq = len(seq)
  packed = bytearray((l_seq + 1) // 2)
  for i, c in enumerate(seq):
    nib = _NIBBLE.get(c.upper(), 15)
    if i % 2 == 0:
      packed[i // 2] |= nib << 4
    else:
      packed[i // 2] |= nib
  if quals is None:
    qual_b = b'\xff' * l_seq
  else:
    qual_b = np.asarray(quals, dtype=np.uint8).tobytes()
  tag_b = b''
  for tag_name, value in (tags or {}).items():
    tag_b += _encode_tag(tag_name, value)
  cigar = cigar or []
  cigar_b = b''.join(
      struct.pack('<I', (int(ln) << 4) | int(op)) for op, ln in cigar
  )
  if mapq is None:
    mapq = 255 if flag & 4 else 0
  body = (
      struct.pack(
          '<iiBBHHHiiii',
          ref_id,
          pos,
          len(name_b),
          mapq,
          4680,  # bin (unused by our reader)
          len(cigar),
          flag,
          l_seq,
          -1,
          -1,
          0,
      )
      + name_b
      + cigar_b
      + bytes(packed)
      + qual_b
      + tag_b
  )
  return struct.pack('<i', len(body)) + body


class BamWriter:
  """Writes a BAM with the given header text (unaligned by default).

  append=True continues an existing (header-bearing) file without
  re-emitting the header — the resume path for atomic <output>.tmp
  BAMs after the caller truncated to the manifest's committed size.
  """

  def __init__(self, path: str, header_text: str = '',
               references: Optional[List[Tuple[str, int]]] = None,
               append: bool = False):
    self._bgzf = BgzfWriter(path, append=append)
    if append:
      return
    references = references or []
    head = b'BAM\x01'
    text = header_text.encode('ascii')
    head += struct.pack('<i', len(text)) + text
    head += struct.pack('<i', len(references))
    for name, length in references:
      name_b = name.encode('ascii') + b'\x00'
      head += struct.pack('<i', len(name_b)) + name_b
      head += struct.pack('<i', length)
    self._bgzf.write(head)

  def write(self, qname: str, seq: str, quals: Optional[np.ndarray],
            tags: Optional[Dict[str, Any]] = None, flag: int = 4,
            ref_id: int = -1, pos: int = -1,
            cigar: Optional[List[Tuple[int, int]]] = None) -> None:
    self._bgzf.write(
        encode_record(qname, seq, quals, flag=flag, tags=tags,
                      ref_id=ref_id, pos=pos, cigar=cigar)
    )

  def flush(self) -> None:
    self._bgzf.flush()

  def tell(self) -> int:
    return self._bgzf.tell()

  def close(self) -> None:
    self._bgzf.close()

  def __enter__(self):
    return self

  def __exit__(self, *exc):
    self.close()
