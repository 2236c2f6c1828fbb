"""Phred-quality and sequence helpers (numpy domain).

Behavior parity with reference deepconsensus/utils/utils.py:36-118; jax
variants of left-shift live in models/losses (they operate on device).
"""
from __future__ import annotations

from typing import List, Union

import numpy as np

from deepconsensus_tpu_torch import constants


def encoded_sequence_to_string(encoded_sequence: np.ndarray) -> str:
  """Vocab-int array -> string, e.g. [1,2,0] -> 'AT '."""
  idx = np.asarray(encoded_sequence).astype(np.int64)
  return constants.VOCAB_BYTES[idx].tobytes().decode('ascii')


def encoded_sequence_to_bytes(encoded_sequence: np.ndarray) -> bytes:
  """Vocab-int array -> ASCII bytes in one LUT gather + tobytes(); the
  array-native emit path's counterpart of encoded_sequence_to_string
  (no str round-trip)."""
  idx = np.asarray(encoded_sequence)
  if idx.dtype != np.uint8:
    idx = idx.astype(np.int64)
  return constants.VOCAB_BYTES[idx].tobytes()


def quality_scores_to_bytes(scores: np.ndarray) -> bytes:
  """Phred int array -> FASTQ quality bytes (offset 33), single pass."""
  arr = np.asarray(scores)
  if arr.dtype == np.uint8:
    return (arr + np.uint8(33)).tobytes()
  return (arr.astype(np.int64) + 33).astype(np.uint8).tobytes()


def quality_score_to_string(score: int) -> str:
  """Phred int -> FASTQ char (offset 33)."""
  return chr(score + 33)


def quality_scores_to_string(scores: Union[np.ndarray, List[int]]) -> str:
  """Phred int array -> FASTQ quality string."""
  arr = np.asarray(scores)
  if arr.dtype == np.uint8:
    # Device-epilogue drain path: already the FASTQ byte domain minus
    # the offset — no int64 intermediate.
    return (arr + np.uint8(33)).tobytes().decode('ascii')
  arr = (arr.astype(np.int64) + 33).astype(np.uint8)
  return arr.tobytes().decode('ascii')


def quality_string_to_array(quality_string: str) -> List[int]:
  """FASTQ quality string -> list of phred ints."""
  return [ord(char) - 33 for char in quality_string]


def avg_phred(base_qualities: Union[np.ndarray, List[int]]) -> float:
  """Average quality of a read, computed in probability domain.

  Negative entries encode spacing and are excluded
  (reference: utils.py:88-106).
  """
  base_qualities = np.asarray(base_qualities)
  base_qualities = base_qualities[base_qualities >= 0]
  if not base_qualities.any():
    return 0.0
  probs = 10 ** (base_qualities / -10.0)
  avg_prob = probs.sum() / len(probs)
  return float(-10 * np.log10(avg_prob))


def left_shift_seq(seq: np.ndarray) -> np.ndarray:
  """Moves all gap tokens to the end, preserving base order."""
  return np.concatenate(
      [seq[seq != constants.GAP_INT], seq[seq == constants.GAP_INT]]
  )


def left_shift(batch_seq: np.ndarray, axis: int = 1) -> np.ndarray:
  """Batched left_shift_seq via the two-stage sort trick (vectorized;
  same semantics as the per-row concatenate, and the numpy twin of
  losses.left_shift_sequence)."""
  if axis != 1 or batch_seq.ndim != 2:
    return np.apply_along_axis(left_shift_seq, axis, batch_seq)
  length = batch_seq.shape[1]
  ixs = np.broadcast_to(np.arange(length), batch_seq.shape)
  order = np.sort(
      np.where(batch_seq != constants.GAP_INT, ixs, length + ixs), axis=1
  )
  order = np.where(order < length, order, order - length)
  return np.take_along_axis(batch_seq, order, axis=1)
