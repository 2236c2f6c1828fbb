"""Row formatting for model input (reference data_providers.py:128-184)
and the training loader: TFRecord examples -> shuffled (rows, label)
batches, copied from the reference package's models/data.py
(parse_example_minimal, _pad_minimal, _batch_from_minimal and the
single-bucket DatasetIterator, with its seeded shuffle, so the batches
are the same)."""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Sequence, Union

import numpy as np

from deepconsensus_tpu_torch import constants
from deepconsensus_tpu_torch.faults import WindowBucketError
from deepconsensus_tpu_torch.io.example_proto import Example
from deepconsensus_tpu_torch.io.tfrecord import read_tfrecords
from deepconsensus_tpu_torch.models import config
from deepconsensus_tpu_torch.preprocess.pileup import (
    layout_from_shape,
    row_indices,
)
from deepconsensus_tpu_torch.utils import phred


def format_rows_batch(subreads: np.ndarray, params,
                      window_buckets: Sequence[int] = ()) -> np.ndarray:
  """Clips PW/IP/SN rows and crops passes to the model's max_passes for
  a whole window batch [N, H, L, 1]. The width must be one of the
  window buckets: window_buckets when given, else the params' buckets
  (max_length alone when params.window_buckets is unset)."""
  example_layout = layout_from_shape(subreads.shape[1:], params.use_ccs_bq)
  (base_r, pw_r, ip_r, strand_r, ccs_r, ccs_bq_r, sn_r) = row_indices(
      example_layout.max_passes, params.use_ccs_bq
  )
  keep = params.max_passes

  def rows_of(r, cap=None):
    block = subreads[:, r[0]:r[1]]
    return block[:, :cap] if cap else block

  features = [
      rows_of(base_r, keep),
      np.clip(rows_of(pw_r, keep), 0, params.PW_MAX),
      np.clip(rows_of(ip_r, keep), 0, params.IP_MAX),
      rows_of(strand_r, keep),
      rows_of(ccs_r),
  ]
  if params.use_ccs_bq:
    features.append(rows_of(ccs_bq_r))
  features.append(np.clip(rows_of(sn_r), 0, params.SN_MAX))
  rows = np.concatenate(features, axis=1)
  buckets = (tuple(window_buckets) if window_buckets
             else config.resolve_window_buckets(params))
  width = rows.shape[2]
  if width not in buckets:
    raise WindowBucketError(
        f'window width {width} not in window buckets {buckets}; triage '
        'the window into a bucket (pad) first')
  expected = (len(subreads), params.total_rows, width, 1)
  assert rows.shape == expected, rows.shape
  return rows


# The only proto fields the training batch path needs.
_MINIMAL_FIELDS = frozenset({
    'subreads/encoded', 'subreads/shape', 'label/encoded', 'label/shape',
})


def parse_example_minimal(raw: bytes) -> Dict[str, np.ndarray]:
  """Decodes only the subreads tensor (raw, unformatted) and the label;
  row formatting and label gap-shifting happen per batch."""
  ex = Example.parse(raw, fields=_MINIMAL_FIELDS)
  return {
      name: np.frombuffer(ex[f'{name}/encoded'][0],
                          dtype=constants.NP_DATA_TYPE).reshape(
                              ex[f'{name}/shape'])
      for name in ('subreads', 'label')
  }


def _window_width(parsed: Dict[str, np.ndarray]) -> int:
  """Window width of one minimal parse ([H, L, 1] subreads)."""
  return int(parsed['subreads'].shape[1])


def _pad_minimal(parsed: Dict[str, np.ndarray], pad_to: int
                 ) -> Dict[str, np.ndarray]:
  """Pads one minimal parse's window axis up to pad_to. Zero is the
  absent value of every row family and the gap label, so the pad is
  semantically a no-op."""
  w = _window_width(parsed)
  if w == pad_to:
    return parsed
  return {
      'subreads': np.pad(parsed['subreads'], ((0, 0), (0, pad_to - w),
                                              (0, 0))),
      'label': np.pad(parsed['label'], (0, pad_to - w)),
  }


def _batch_from_minimal(chosen: List[Dict[str, np.ndarray]], params,
                        pad_to: int) -> Dict[str, np.ndarray]:
  """Stacks minimal parses into a formatted (rows, label) batch."""
  chosen = [_pad_minimal(c, pad_to) for c in chosen]
  label = np.stack([c['label'] for c in chosen])
  if params.get('remove_label_gaps', False):
    label = phred.left_shift(label)
  return {
      'rows': format_rows_batch(
          np.stack([c['subreads'] for c in chosen]), params),
      'label': label,
  }


@dataclasses.dataclass
class DatasetIterator:
  """Shuffled, fixed-batch iterator over TFRecord shards, one window
  width (params.max_length; narrower windows are padded to it).

  Loads the shards once, then yields {'rows', 'label'} batches, the
  last partial batch of an epoch dropped, as in the reference. The
  shuffle is the reference's np.random.default_rng(seed) permutation
  per epoch. Several window buckets (bucketed training) are not ported
  (ROADMAP: training features).
  """

  patterns: Union[str, Sequence[str]]
  params: object
  batch_size: int
  seed: int = 1
  shuffle: bool = True

  def __post_init__(self):
    buckets = config.resolve_window_buckets(self.params)
    if len(buckets) > 1:
      raise NotImplementedError(
          f'window_buckets {buckets}: bucketed training is not ported yet '
          '(ROADMAP: training features)')
    width = buckets[0]
    parsed = []
    for raw in read_tfrecords(self.patterns):
      example = parse_example_minimal(raw)
      if _window_width(example) > width:
        raise WindowBucketError(
            f'window width {_window_width(example)} overflows max_length '
            f'{width}')
      parsed.append(example)
    if not parsed:
      raise ValueError(f'no examples matched {self.patterns!r}')
    batch = _batch_from_minimal(parsed, self.params, pad_to=width)
    self.rows = batch['rows']
    self.labels = batch['label']
    self._rng = np.random.default_rng(self.seed)

  def __len__(self) -> int:
    return len(self.rows)

  @property
  def steps_per_epoch(self) -> int:
    return len(self.rows) // self.batch_size

  def epoch(self) -> Iterator[Dict[str, np.ndarray]]:
    order = np.arange(len(self.rows))
    if self.shuffle:
      self._rng.shuffle(order)
    for start in range(0, self.steps_per_epoch * self.batch_size,
                       self.batch_size):
      idx = order[start:start + self.batch_size]
      yield {'rows': self.rows[idx], 'label': self.labels[idx]}
