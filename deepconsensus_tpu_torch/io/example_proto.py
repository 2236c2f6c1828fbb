"""Minimal, dependency-free tf.train.Example protobuf codec.

Copy of the reference package's io/example_proto.py (imports rewritten).

The training examples written by the reference pipeline are serialized
`tf.train.Example` protos inside gzipped TFRecord files
(reference: deepconsensus/preprocess/pre_lib.py:764-787 and
models/data_providers.py:41-58). To stay free of a TensorFlow dependency
in the core framework we speak the wire format directly; the schema is a
flat map<string, Feature> where Feature is a oneof{BytesList, FloatList,
Int64List}. This file implements exactly that subset of proto2.
"""
from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple, Union

from deepconsensus_tpu_torch.faults import CorruptInputError

FeatureValue = Union[List[bytes], List[float], List[int]]

_BYTES_KIND = 1
_FLOAT_KIND = 2
_INT64_KIND = 3

_KIND_NAMES = {_BYTES_KIND: 'bytes', _FLOAT_KIND: 'float', _INT64_KIND: 'int64'}


def _write_varint(out: bytearray, value: int) -> None:
  while True:
    bits = value & 0x7F
    value >>= 7
    if value:
      out.append(bits | 0x80)
    else:
      out.append(bits)
      return


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
  result = 0
  shift = 0
  while True:
    b = buf[pos]
    pos += 1
    result |= (b & 0x7F) << shift
    if not b & 0x80:
      return result, pos
    shift += 7


def _zigzag_decode_int64(value: int) -> int:
  # int64 fields are encoded as plain (non-zigzag) varints; negative values
  # occupy 10 bytes in two's complement. Normalize to signed.
  if value >= 1 << 63:
    value -= 1 << 64
  return value


def _encode_int64(value: int) -> int:
  if value < 0:
    value += 1 << 64
  return value


class Example:
  """A flat feature map with the same API shape as tf.train.Example usage.

  features: dict name -> (kind, list) where kind in {'bytes','float','int64'}.
  """

  def __init__(self):
    self.features: Dict[str, Tuple[str, FeatureValue]] = {}

  # ---- building --------------------------------------------------------
  def add_bytes(self, name: str, values: List[bytes]) -> 'Example':
    self.features[name] = ('bytes', list(values))
    return self

  def add_float(self, name: str, values) -> 'Example':
    self.features[name] = ('float', [float(v) for v in values])
    return self

  def add_int64(self, name: str, values) -> 'Example':
    self.features[name] = ('int64', [int(v) for v in values])
    return self

  # ---- accessors -------------------------------------------------------
  def __contains__(self, name: str) -> bool:
    return name in self.features

  def kind(self, name: str) -> str:
    return self.features[name][0]

  def __getitem__(self, name: str) -> FeatureValue:
    return self.features[name][1]

  def get(self, name: str, default=None):
    entry = self.features.get(name)
    return entry[1] if entry is not None else default

  # ---- serialization ---------------------------------------------------
  def _serialize_feature(self, kind: str, values: FeatureValue) -> bytes:
    inner = bytearray()
    if kind == 'bytes':
      for v in values:
        inner.append((1 << 3) | 2)  # field 1, length-delimited
        _write_varint(inner, len(v))
        inner += v
      field_num = _BYTES_KIND
    elif kind == 'float':
      packed = struct.pack(f'<{len(values)}f', *values)
      inner.append((1 << 3) | 2)
      _write_varint(inner, len(packed))
      inner += packed
      field_num = _FLOAT_KIND
    elif kind == 'int64':
      packed = bytearray()
      for v in values:
        _write_varint(packed, _encode_int64(v))
      inner.append((1 << 3) | 2)
      _write_varint(inner, len(packed))
      inner += packed
      field_num = _INT64_KIND
    else:
      # dclint: allow=typed-faults (serialisation path: the kind comes
      # from our own feature tables, so this is a programmer error)
      raise ValueError(f'unknown feature kind {kind!r}')
    out = bytearray()
    out.append((field_num << 3) | 2)
    _write_varint(out, len(inner))
    out += inner
    return bytes(out)

  def serialize(self) -> bytes:
    features_msg = bytearray()
    # Deterministic ordering for reproducible bytes.
    for name in sorted(self.features):
      kind, values = self.features[name]
      entry = bytearray()
      key_bytes = name.encode('utf-8')
      entry.append((1 << 3) | 2)
      _write_varint(entry, len(key_bytes))
      entry += key_bytes
      feat = self._serialize_feature(kind, values)
      entry.append((2 << 3) | 2)
      _write_varint(entry, len(feat))
      entry += feat
      features_msg.append((1 << 3) | 2)  # Features.feature map entry
      _write_varint(features_msg, len(entry))
      features_msg += entry
    out = bytearray()
    out.append((1 << 3) | 2)  # Example.features
    _write_varint(out, len(features_msg))
    out += features_msg
    return bytes(out)

  # ---- parsing ---------------------------------------------------------
  @staticmethod
  def _iter_fields(buf: bytes, start: int, end: int) -> Iterator[Tuple[int, int, bytes]]:
    """Yields (field_number, wire_type, payload) for length/varint fields."""
    pos = start
    while pos < end:
      tag, pos = _read_varint(buf, pos)
      field_num, wire_type = tag >> 3, tag & 7
      if wire_type == 2:
        length, pos = _read_varint(buf, pos)
        yield field_num, wire_type, buf[pos : pos + length]
        pos += length
      elif wire_type == 0:
        value, pos = _read_varint(buf, pos)
        yield field_num, wire_type, value
      elif wire_type == 5:
        yield field_num, wire_type, buf[pos : pos + 4]
        pos += 4
      elif wire_type == 1:
        yield field_num, wire_type, buf[pos : pos + 8]
        pos += 8
      else:
        raise CorruptInputError(
            f'unsupported wire type {wire_type}', offset=pos,
            recoverable=False)

  @classmethod
  def _parse_feature(cls, buf: bytes) -> Tuple[str, FeatureValue]:
    for field_num, wire_type, payload in cls._iter_fields(buf, 0, len(buf)):
      kind = _KIND_NAMES.get(field_num)
      if kind is None:
        continue
      values: FeatureValue = []
      for f2, w2, inner in cls._iter_fields(payload, 0, len(payload)):
        if f2 != 1:
          continue
        if kind == 'bytes':
          values.append(inner)
        elif kind == 'float':
          if w2 == 2:
            values.extend(struct.unpack(f'<{len(inner) // 4}f', inner))
          else:  # unpacked fixed32
            values.append(struct.unpack('<f', inner)[0])
        else:  # int64
          if w2 == 2:
            pos = 0
            while pos < len(inner):
              v, pos = _read_varint(inner, pos)
              values.append(_zigzag_decode_int64(v))
          else:
            values.append(_zigzag_decode_int64(inner))
      return kind, values
    return 'bytes', []

  @classmethod
  def parse(cls, data: bytes, fields=None) -> 'Example':
    """Parses a serialized Example.

    fields: optional collection of feature names; payloads of other
    features are skipped without decoding (the per-varint walk of
    unneeded int64 lists is the measured hot spot of the training
    input pipeline).
    """
    ex = cls()
    for field_num, _, features_buf in cls._iter_fields(data, 0, len(data)):
      if field_num != 1:
        continue
      for f2, _, entry in cls._iter_fields(features_buf, 0, len(features_buf)):
        if f2 != 1:
          continue
        key = None
        feat_buf = None
        for f3, _, payload in cls._iter_fields(entry, 0, len(entry)):
          if f3 == 1:
            key = payload.decode('utf-8')
          elif f3 == 2:
            feat_buf = payload
        if key is not None and feat_buf is not None:
          if fields is not None and key not in fields:
            continue
          kind, values = cls._parse_feature(feat_buf)
          ex.features[key] = (kind, values)
    return ex
