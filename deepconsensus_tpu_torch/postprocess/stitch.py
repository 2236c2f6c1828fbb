"""Stitching model-output windows back into full reads.

Equivalent of the reference's postprocess stage (reference:
deepconsensus/postprocess/stitch_utils.py:39-189): concatenate sorted
windows, fail (or N-fill) on missing windows, strip gap columns, apply
quality/length filters, and emit FASTQ text.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Iterable, Optional, Tuple

import numpy as np

from deepconsensus_tpu_torch import constants
from deepconsensus_tpu_torch.utils import phred

log = logging.getLogger(__name__)


@dataclasses.dataclass
class DCModelOutput:
  molecule_name: str
  window_pos: int
  ec: Optional[float] = None
  np_num_passes: Optional[int] = None
  rq: Optional[float] = None
  rg: Optional[str] = None
  sequence: Optional[str] = None
  quality_string: Optional[str] = None


@dataclasses.dataclass
class OutcomeCounter:
  empty_sequence: int = 0
  only_gaps: int = 0
  failed_quality_filter: int = 0
  failed_length_filter: int = 0
  success: int = 0


def get_full_sequence(
    outputs: Iterable[DCModelOutput],
    max_length: int,
    fill_n: bool = False,
) -> Tuple[Optional[str], str]:
  """Concatenates sorted windows; missing windows fail the read unless
  fill_n pads them with Ns (reference: stitch_utils.py:51-81)."""
  sequence_parts = []
  quality_parts = []
  start = 0
  for out in outputs:
    while out.window_pos > start:
      if not fill_n:
        return None, ''
      sequence_parts.append('N' * max_length)
      quality_parts.append(
          phred.quality_scores_to_string([constants.EMPTY_QUAL] * max_length)
      )
      start += max_length
    sequence_parts.append(out.sequence)
    quality_parts.append(out.quality_string)
    start += max_length
  return ''.join(sequence_parts), ''.join(quality_parts)


def remove_gaps(sequence: str, quality_string: str) -> Tuple[str, str]:
  """Drops gap columns and their quality values."""
  seq = np.frombuffer(sequence.encode('ascii'), dtype=np.uint8)
  qual = np.frombuffer(quality_string.encode('ascii'), dtype=np.uint8)
  keep = seq != ord(constants.GAP)
  return (
      seq[keep].tobytes().decode('ascii'),
      qual[keep].tobytes().decode('ascii'),
  )


def is_quality_above_threshold(quality_string: str, min_quality: int) -> bool:
  scores = phred.quality_string_to_array(quality_string)
  # Round to dodge float noise right at the threshold
  # (reference: stitch_utils.py:101-109).
  return round(phred.avg_phred(scores), 5) >= min_quality


def format_as_fastq(name: str, sequence: str, quality_string: str) -> str:
  return f'@{name}\n{sequence}\n+\n{quality_string}\n'


def fallback_to_arrays(
    molecule_name: str,
    sequence: str,
    quality_scores,
    min_quality: int,
    min_length: int,
    max_base_quality: int,
    counter,
) -> Optional[Tuple[bytes, np.ndarray]]:
  """Array-native core of fallback_to_fastq: gates a quarantined ZMW's
  draft CCS read and returns (sequence bytes, phred uint8 array), or
  None when filtered. Counted under n_fallback_* keys — deliberately
  not OutcomeCounter, so `success` keeps meaning "model-polished reads"
  and fallback yield stays separately accountable."""
  del molecule_name  # kept for call-site symmetry with stitch_arrays
  if not sequence:
    counter['n_fallback_empty'] += 1
    return None
  quals = np.clip(
      np.asarray(quality_scores, dtype=np.int64), 0, max_base_quality
  )
  if round(phred.avg_phred(quals), 5) < min_quality:
    counter['n_fallback_failed_quality_filter'] += 1
    return None
  if len(sequence) < min_length:
    counter['n_fallback_failed_length_filter'] += 1
    return None
  counter['n_fallback_emitted'] += 1
  return sequence.encode('ascii'), quals.astype(np.uint8)


def fallback_to_fastq(
    molecule_name: str,
    sequence: str,
    quality_scores,
    min_quality: int,
    min_length: int,
    max_base_quality: int,
    counter,
) -> Optional[str]:
  """String-plane wrapper over fallback_to_arrays (legacy API)."""
  result = fallback_to_arrays(
      molecule_name, sequence, quality_scores, min_quality, min_length,
      max_base_quality, counter,
  )
  if result is None:
    return None
  seq_bytes, quals = result
  return format_as_fastq(
      molecule_name, seq_bytes.decode('ascii'),
      phred.quality_scores_to_string(quals),
  )


def stitch_to_fastq(
    molecule_name: str,
    predictions: Iterable[DCModelOutput],
    max_length: int,
    min_quality: int,
    min_length: int,
    outcome_counter: OutcomeCounter,
) -> Optional[str]:
  """Stitch + filter + format one molecule
  (reference: stitch_utils.py:131-189)."""
  full_seq, full_qual = get_full_sequence(predictions, max_length)
  if not full_seq:
    outcome_counter.empty_sequence += 1
    return None
  final_seq, final_qual = remove_gaps(full_seq, full_qual)
  if not final_seq:
    outcome_counter.only_gaps += 1
    return None
  if not is_quality_above_threshold(final_qual, min_quality):
    outcome_counter.failed_quality_filter += 1
    return None
  if len(final_seq) < min_length:
    outcome_counter.failed_length_filter += 1
    return None
  outcome_counter.success += 1
  return format_as_fastq(molecule_name, final_seq, final_qual)


def stitch_arrays(
    molecule_name: str,
    window_pos: np.ndarray,
    ids: np.ndarray,
    quals: np.ndarray,
    max_length: int,
    min_quality: int,
    min_length: int,
    outcome_counter: OutcomeCounter,
) -> Optional[Tuple[bytes, np.ndarray]]:
  """Array-native stitch_to_fastq: one molecule's windows as contiguous
  arrays in, (sequence ASCII bytes, phred uint8 array) out.

  window_pos: [n] window start offsets; ids: [n, L] vocab-id uint8 —
  or, for bucketed variable-length windows, a sequence of n 1-D uint8
  arrays with per-window lengths; quals likewise. The gap strip,
  quality gate, and ASCII conversion are each a single vectorized pass
  — no per-window Python objects or intermediate strings. Filter
  semantics (and counter attribution) match stitch_to_fastq exactly,
  including the legacy missing-window rule generalized to ragged rows:
  sorted window k must not start past the cumulative capacity of the
  windows before it (for uniform L=max_length rows that is exactly the
  legacy k * max_length bound, so fixed-shape output is byte-identical).
  """
  del molecule_name  # name formatting happens at the emit sink
  n = len(window_pos)
  order = np.argsort(window_pos, kind='stable')
  pos = np.asarray(window_pos)[order]
  if isinstance(ids, np.ndarray) and ids.dtype != object:
    lengths = np.full(n, ids.shape[1] if ids.ndim > 1 else 0,
                      dtype=np.int64)
  else:
    ids = [np.asarray(w) for w in ids]
    quals = [np.asarray(w) for w in quals]
    lengths = np.array([len(ids[i]) for i in order], dtype=np.int64)
  capacity = np.zeros(n, dtype=np.int64)
  if n:
    np.cumsum(lengths[:-1], out=capacity[1:])
  if n == 0 or np.any(pos > capacity):
    outcome_counter.empty_sequence += 1
    return None
  if isinstance(ids, np.ndarray):
    flat_ids = np.ascontiguousarray(ids[order]).reshape(-1)
    flat_quals = np.ascontiguousarray(quals[order]).reshape(-1)
  else:
    flat_ids = np.concatenate([ids[i] for i in order])
    flat_quals = np.concatenate([quals[i] for i in order])
  keep = flat_ids != constants.GAP_INT
  flat_ids = flat_ids[keep]
  if flat_ids.size == 0:
    outcome_counter.only_gaps += 1
    return None
  flat_quals = flat_quals[keep]
  if round(phred.avg_phred(flat_quals), 5) < min_quality:
    outcome_counter.failed_quality_filter += 1
    return None
  if flat_ids.size < min_length:
    outcome_counter.failed_length_filter += 1
    return None
  outcome_counter.success += 1
  return phred.encoded_sequence_to_bytes(flat_ids), flat_quals


def format_fastq_bytes(name: str, seq: bytes, quals: np.ndarray) -> bytes:
  """(name, sequence bytes, phred uint8) -> one FASTQ record's bytes."""
  return b'@%s\n%s\n+\n%s\n' % (
      name.encode('ascii'), seq, phred.quality_scores_to_bytes(quals)
  )
