"""Feature layout and windowed pileup examples.

FeatureLayout mirrors the reference's DcConfig row bookkeeping
(reference: deepconsensus/preprocess/pre_lib.py:424-528); Pileup mirrors
DcExample windowing/feature assembly (pre_lib.py:531-819). The stacked
2-D tensor layout is identical: [bases x max_passes, pw x max_passes,
ip x max_passes, strand x max_passes, ccs, (ccs_bq), sn x 4] rows by
max_length columns.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from deepconsensus_tpu_torch import constants
from deepconsensus_tpu_torch.io.example_proto import Example
from deepconsensus_tpu_torch.preprocess.alignment import AlignedRead
from deepconsensus_tpu_torch.utils import phred


class FeatureLayout:
  """Row layout of the stacked example tensor."""

  N_SUBREAD_FEATURES = ('bases', 'pw', 'ip', 'strand')

  def __init__(self, max_passes: int, max_length: int,
               use_ccs_bq: bool = False,
               window_buckets: Optional[Tuple[int, ...]] = None):
    self.max_passes = max_passes
    self.max_length = max_length
    self.use_ccs_bq = use_ccs_bq
    # Window length buckets for the variable-width (smart windows)
    # path: a spaced window pads to the smallest bucket that fits
    # instead of pad-to-max_length, and only windows wider than the
    # largest bucket overflow. None/empty keeps the single-shape rule.
    # Rides on the layout so bucketing reaches featurize workers
    # without widening the feeder plumbing.
    self.window_buckets = tuple(window_buckets) if window_buckets else (
        (max_length,))
    self.feature_rows = {
        'bases': max_passes,
        'pw': max_passes,
        'ip': max_passes,
        'strand': max_passes,
        'ccs': 1,
        'ccs_bq': 1 if use_ccs_bq else 0,
        'sn': 4,
    }
    self.feature_start: Dict[str, int] = {}
    i = 0
    for name, rows in self.feature_rows.items():
      self.feature_start[name] = i
      i += rows

  def indices(self, feature: str, n_subreads: int = 0) -> slice:
    start = self.feature_start[feature]
    if n_subreads:
      assert feature in self.N_SUBREAD_FEATURES
      return slice(start, start + min(n_subreads, self.max_passes))
    assert feature not in self.N_SUBREAD_FEATURES
    return slice(start, start + self.feature_rows[feature])

  @property
  def tensor_height(self) -> int:
    return sum(self.feature_rows.values())

  def to_dict(self) -> Dict[str, str]:
    return {
        'max_passes': str(self.max_passes),
        'max_length': str(self.max_length),
        'tensor_height': str(self.tensor_height),
        'tensor_width': str(self.max_length),
    }


def layout_from_shape(shape: Tuple[int, int, int],
                      use_ccs_bq: bool = False) -> FeatureLayout:
  """Recovers a FeatureLayout from a subreads tensor shape."""
  height, width, _ = shape
  fixed = 6 if use_ccs_bq else 5
  max_passes, rem = divmod(height - fixed, len(FeatureLayout.N_SUBREAD_FEATURES))
  if rem != 0:
    raise ValueError(f'invalid subreads shape {shape!r}')
  return FeatureLayout(max_passes, width, use_ccs_bq)


def bucket_window_width(window_width: int,
                        layout: FeatureLayout) -> Tuple[int, bool]:
  """(padded_width, overflow) for a spaced window under the layout's
  bucket set: the smallest bucket that fits, or (window_width, True)
  past the largest bucket — overflow windows keep their natural width
  and are triaged to the CCS-fallback path downstream, exactly as the
  single-shape rule did for window_width > max_length."""
  for b in layout.window_buckets:
    if window_width <= b:
      return int(b), False
  return int(window_width), True


def total_rows(max_passes: int, use_ccs_bq: bool) -> int:
  """Number of rows in the stacked tensor
  (reference: models/data_providers.py:61-78)."""
  return max_passes * 4 + (6 if use_ccs_bq else 5)


def row_indices(
    max_passes: int, use_ccs_bq: bool
) -> Tuple[Tuple[int, int], ...]:
  """(start, end) row ranges: bases, pw, ip, strand, ccs, ccs_bq, sn
  (reference: models/data_providers.py:81-113)."""
  base = (0, max_passes)
  pw = (max_passes, max_passes * 2)
  ip = (max_passes * 2, max_passes * 3)
  strand = (max_passes * 3, max_passes * 4)
  ccs = (max_passes * 4, max_passes * 4 + 1)
  if use_ccs_bq:
    ccs_bq = (max_passes * 4 + 1, max_passes * 4 + 2)
    sn = (max_passes * 4 + 2, max_passes * 4 + 6)
  else:
    ccs_bq = (0, 0)
    sn = (max_passes * 4 + 1, max_passes * 4 + 5)
  return base, pw, ip, strand, ccs, ccs_bq, sn


@dataclasses.dataclass
class Pileup:
  """A ZMW's spaced reads plus windowing and feature assembly."""

  name: str
  reads: List[AlignedRead]
  layout: FeatureLayout
  window_widths: Optional[np.ndarray] = None
  counter: Counter = dataclasses.field(default_factory=Counter)
  overflow: bool = False

  _width: Optional[int] = None
  _ccs_width: Optional[int] = None
  # Window pileups yielded by iter_windows carry their feature tensor
  # pre-sliced from the parent ZMW matrix (label rows are not part of
  # the matrix, so training label adjustments don't invalidate it).
  _cached_features: Optional[np.ndarray] = None

  @property
  def is_training(self) -> bool:
    return self.reads[-1].is_label

  @property
  def ccs(self) -> AlignedRead:
    return self.reads[-2] if self.is_training else self.reads[-1]

  @property
  def label(self) -> Optional[AlignedRead]:
    return self.reads[-1] if self.is_training else None

  @property
  def label_coords(self) -> str:
    return self.label.label_coords if self.is_training else ''

  @property
  def contig(self) -> Optional[str]:
    return self.label.truth_range['contig'] if self.is_training else None

  @property
  def subreads(self) -> List[AlignedRead]:
    return self.reads[:-2] if self.is_training else self.reads[:-1]

  @property
  def n_subreads(self) -> int:
    return len(self.subreads)

  @property
  def keep_subreads(self) -> int:
    return min(self.layout.max_passes, self.n_subreads)

  @property
  def width(self) -> int:
    if self._width is None:
      self._width = len(self.ccs.bases)
    return self._width

  @property
  def ccs_width(self) -> int:
    """Spaced width excluding trailing gap columns."""
    if self._ccs_width is None:
      nz = np.flatnonzero(self.ccs.bases != constants.GAP_INT)
      self._ccs_width = int(nz[-1]) + 1 if nz.size else 0
    return self._ccs_width

  @property
  def is_empty(self) -> bool:
    return not (self.ccs.ccs_idx >= 0).any()

  @property
  def ccs_matches_label(self) -> bool:
    ccs = phred.left_shift_seq(self.ccs.bases)
    label = phred.left_shift_seq(self.label.bases)
    n = max(len(ccs), len(label))
    ccs = np.pad(ccs, (0, n - len(ccs)))
    label = np.pad(label, (0, n - len(label)))
    return bool(np.array_equal(ccs, label))

  # ------------------------------------------------------------------
  def window_slice(self, r_slice: slice) -> 'Pileup':
    """Column-slices subreads+ccs; ccs-coordinate-slices the label
    (reference: pre_lib.py:789-798)."""
    reads = [x.slice_columns(r_slice) for x in self.subreads + [self.ccs]]
    if self.is_training:
      bounds = reads[-1].ccs_bounds
      reads.append(self.label.ccs_slice(bounds.start, bounds.stop))
    return Pileup(self.name, reads, self.layout)

  def calculate_windows(self, example_width: int) -> List[int]:
    """Window widths in spaced-column units (pre_lib.py:625-650)."""
    if self.window_widths is not None:
      # "Smart windows": the wl tag gives widths in unspaced CCS bases;
      # translate to spaced columns by walking non-gap positions.
      ccs_bases = self.ccs.bases
      nongap_positions = np.flatnonzero(ccs_bases != constants.GAP_INT)
      widths = []
      last_pos = 0
      consumed = 0
      for w in self.window_widths:
        consumed += int(w)
        # Column just past the consumed-th non-gap base.
        end_col = int(nongap_positions[consumed - 1]) + 1
        widths.append(end_col - last_pos)
        last_pos = end_col
      if sum(widths) != self.ccs_width:
        raise ValueError(
            f'smart windows cover {sum(widths)} columns, '
            f'expected {self.ccs_width}'
        )
      return widths
    n_windows = self.ccs_width // example_width
    if self.ccs_width % example_width > 0:
      n_windows += 1
    return [example_width] * n_windows

  def iter_windows(self) -> Iterator['Pileup']:
    """Yields fixed-width window Pileups (reference iter_examples:
    pre_lib.py:652-697). Each yielded window carries its feature
    tensor pre-sliced from the ZMW matrix (built once), so
    to_example/extract_features skip the per-window re-stacking."""
    self.counter = Counter()
    layout = self.layout
    max_length = layout.max_length
    matrix = self.full_matrix()
    keep = self.subreads[: layout.max_passes]
    strand_rows = layout.indices('strand', self.n_subreads)
    sn_rows = layout.indices('sn')
    strand_col = np.array(
        [float(int(r.strand)) for r in keep], dtype=constants.NP_DATA_TYPE
    )
    sn_col = (
        np.asarray(self.subreads[0].sn, dtype=constants.NP_DATA_TYPE)
        if self.subreads else np.zeros(4, dtype=constants.NP_DATA_TYPE)
    )

    start = 0
    for window_width in self.calculate_windows(max_length):
      self.counter[f'example_width_bucket_{window_width}'] += 1
      window = self.window_slice(slice(start, start + window_width))
      if start > self.ccs_width:
        break
      win_start, start = start, start + window_width
      if window.is_empty:
        self.counter['n_examples_no_ccs_idx'] += 1
        continue

      if self.is_training and len(window.label.bases) > max_length:
        adjusted = window.label.remove_gaps_and_pad(max_length)
        if adjusted is None:
          self.counter['n_examples_label_overflow'] += 1
          continue
        self.counter['n_examples_adjusted_label'] += 1
        window.reads[-1] = adjusted

      if self.is_training:
        # Training keeps the reference single-shape rule; buckets are
        # an inference-side geometry.
        width = max(window_width, max_length)
        overflow = window_width > max_length
      else:
        width, overflow = bucket_window_width(window_width, layout)
      if overflow:
        self.counter['n_examples_overflow'] += 1
        if self.is_training:
          continue
      else:
        self.counter['n_examples_skip_large_windows_keep'] += 1

      reads = [x.pad(width) for x in window.reads]
      out = Pileup(self.name, reads, self.layout, overflow=overflow)
      # Same tail padding rules as AlignedRead.pad: strand/sn repeat,
      # ccs_bq pads with -1, everything else pads with zeros.
      chunk = matrix[:, win_start : win_start + window_width]
      if chunk.shape[1] < width:
        data = np.zeros(
            (layout.tensor_height, width), dtype=constants.NP_DATA_TYPE
        )
        data[:, : chunk.shape[1]] = chunk
        data[strand_rows, chunk.shape[1]:] = strand_col[:, None]
        data[sn_rows, chunk.shape[1]:] = sn_col[:, None]
        if layout.use_ccs_bq:
          data[layout.indices('ccs_bq'), chunk.shape[1]:] = -1
      else:
        data = chunk
      out._cached_features = data[:, :, None]
      yield out

  # ------------------------------------------------------------------
  def extract_features(self, min_width: int = 0) -> np.ndarray:
    """Stacks the window into the [rows, width, 1] tensor
    (reference: pre_lib.py:704-744). min_width over-allocates columns
    (zero-filled past the pileup) so the batched window path can
    reshape in place instead of re-copying into a padded buffer."""
    if self._cached_features is not None and not min_width:
      return self._cached_features
    layout = self.layout
    n_subreads = self.n_subreads
    data = np.zeros(
        (layout.tensor_height, max(self.width, min_width)),
        dtype=constants.NP_DATA_TYPE,
    )
    body = data[:, : self.width]
    keep = self.subreads[: layout.max_passes]
    if keep:
      body[layout.indices('bases', n_subreads)] = np.stack(
          [r.bases for r in keep]
      )
      body[layout.indices('pw', n_subreads)] = np.stack([r.pw for r in keep])
      body[layout.indices('ip', n_subreads)] = np.stack([r.ip for r in keep])
      strand_col = np.array([float(int(r.strand)) for r in keep],
                            dtype=constants.NP_DATA_TYPE)
      body[layout.indices('strand', n_subreads)] = strand_col[:, None]
    body[layout.indices('ccs')] = self.ccs.bases
    if layout.use_ccs_bq:
      body[layout.indices('ccs_bq')] = self.ccs.base_quality_scores
    if self.subreads:
      body[layout.indices('sn')] = np.asarray(
          self.subreads[0].sn, dtype=constants.NP_DATA_TYPE
      )[:, None]
    return data[:, :, None]

  def full_matrix(self, min_width: int = 0) -> np.ndarray:
    """Whole-ZMW stacked feature matrix [tensor_height, width].

    Windows are column slices of this matrix (plus padding rules), so
    building it once replaces per-window re-stacking.
    """
    return self.extract_features(min_width)[:, :, 0]

  def iter_window_features(self) -> Iterator[Dict[str, Any]]:
    """Fast inference path: window feature dicts via slices of the
    whole-ZMW matrix. Produces dicts identical to
    iter_windows()+to_features_dict() for inference pileups.
    """
    assert not self.is_training, 'fast path is inference-only'
    self.counter = Counter()
    layout = self.layout
    max_length = layout.max_length
    if self.window_widths is None:
      # Over-allocate to the padded window total up front so the
      # batched branch below reshapes the matrix in place.
      n_batched = (self.ccs_width + max_length - 1) // max_length
      matrix = self.full_matrix(min_width=n_batched * max_length)
    else:
      matrix = self.full_matrix()
    ccs = self.ccs
    ccs_idx = ccs.ccs_idx
    bq = ccs.base_quality_scores
    has_bq = bq.size == len(ccs.bases)  # spaced alongside the pileup

    n_subreads = self.n_subreads
    keep = self.subreads[: layout.max_passes]
    strand_rows = layout.indices('strand', n_subreads)
    sn_rows = layout.indices('sn')
    strand_col = np.array(
        [float(int(r.strand)) for r in keep], dtype=constants.NP_DATA_TYPE
    )
    sn_col = (
        np.asarray(self.subreads[0].sn, dtype=constants.NP_DATA_TYPE)
        if self.subreads else np.zeros(4, dtype=constants.NP_DATA_TYPE)
    )

    if self.window_widths is None:
      # Regular windows are contiguous stride-max_length column slices
      # of the whole-ZMW matrix: build every window with ONE
      # pad+reshape and vectorized per-window metadata instead of
      # ~(ccs_width/100) small-array slice/copy/min calls (the
      # measured host featurization hot spot). Yielded tensors are
      # views into the batched array.
      w = max_length
      n = n_batched
      if n == 0:
        return
      total = n * w
      cols = min(self.width, total)
      # matrix was over-allocated to >= total columns (zero-filled
      # past the pileup); apply the padding rules to the tail in
      # place: strand/sn rows repeat, ccs_bq pads with -1 (see
      # extract_features + AlignedRead.pad).
      padded = matrix[:, :total]
      if cols < total:
        padded[strand_rows, cols:] = strand_col[:, None]
        padded[sn_rows, cols:] = sn_col[:, None]
        if layout.use_ccs_bq:
          padded[layout.indices('ccs_bq'), cols:] = -1
      windows3d = padded.reshape(layout.tensor_height, n, w)

      idx_pad = np.full(total, -1, dtype=np.int64)
      m = min(len(ccs_idx), total)
      idx_pad[:m] = ccs_idx[:m]
      idx_w = idx_pad.reshape(n, w)
      big = np.iinfo(np.int64).max
      window_pos = np.where(idx_w >= 0, idx_w, big).min(axis=1)
      has_cov = window_pos != big

      bq_pad = np.full(total, -1, dtype=np.int64)
      if has_bq:
        m = min(len(bq), total)
        bq_pad[:m] = bq[:m]
      bq_w = bq_pad.reshape(n, w)

      self.counter[f'example_width_bucket_{w}'] += n
      n_cov = int(has_cov.sum())
      if n - n_cov:  # += 0 would still materialize the Counter key
        self.counter['n_examples_no_ccs_idx'] += n - n_cov
      if n_cov:
        self.counter['n_examples_skip_large_windows_keep'] += n_cov
      invariant = {
          'subreads/num_passes': self.keep_subreads,
          'name': self.name,
          'overflow': False,
          'ec': ccs.ec,
          'np_num_passes': ccs.np_num_passes,
          'rq': ccs.rq,
          'rg': ccs.rg,
      }
      for i in range(n):
        if not has_cov[i]:
          continue
        fd = dict(invariant)
        fd['subreads'] = windows3d[:, i, :, None]
        fd['window_pos'] = int(window_pos[i])
        fd['ccs_base_quality_scores'] = bq_w[i]
        yield fd
      return

    start = 0
    for window_width in self.calculate_windows(max_length):
      self.counter[f'example_width_bucket_{window_width}'] += 1
      if start > self.ccs_width:
        break
      sl = slice(start, start + window_width)
      start += window_width
      idx_slice = ccs_idx[sl]
      covered = idx_slice[idx_slice >= 0]
      if covered.size == 0:
        self.counter['n_examples_no_ccs_idx'] += 1
        continue
      width, overflow = bucket_window_width(window_width, layout)
      if overflow:
        self.counter['n_examples_overflow'] += 1
      else:
        self.counter['n_examples_skip_large_windows_keep'] += 1

      chunk = matrix[:, sl]
      if chunk.shape[1] < width:
        data = np.zeros(
            (layout.tensor_height, width), dtype=constants.NP_DATA_TYPE
        )
        data[:, : chunk.shape[1]] = chunk
        # Padding rules: strand/sn rows repeat across the pad; ccs_bq
        # pads with -1 (see extract_features + AlignedRead.pad).
        data[strand_rows, chunk.shape[1] :] = strand_col[:, None]
        data[sn_rows, chunk.shape[1] :] = sn_col[:, None]
        if layout.use_ccs_bq:
          data[layout.indices('ccs_bq'), chunk.shape[1] :] = -1
      else:
        data = np.ascontiguousarray(chunk)

      window_bq = np.full(width, -1, dtype=np.int64)
      if has_bq:
        window_bq[: min(len(bq[sl]), width)] = bq[sl][:width]
      yield {
          'subreads': data[:, :, None],
          'subreads/num_passes': self.keep_subreads,
          'name': self.name,
          'window_pos': int(covered.min()),
          'ccs_base_quality_scores': window_bq,
          'overflow': overflow,
          'ec': ccs.ec,
          'np_num_passes': ccs.np_num_passes,
          'rq': ccs.rq,
          'rg': ccs.rg,
      }

  def to_features_dict(self) -> Dict[str, Any]:
    """Feature dict for the in-memory inference path
    (reference: pre_lib.py:746-762)."""
    return {
        'subreads': self.extract_features(),
        'subreads/num_passes': self.keep_subreads,
        'name': self.name,
        'window_pos': self.ccs.ccs_bounds.start,
        'ccs_base_quality_scores': self.ccs.base_quality_scores,
        'overflow': self.overflow,
        'ec': self.ccs.ec,
        'np_num_passes': self.ccs.np_num_passes,
        'rq': self.ccs.rq,
        'rg': self.ccs.rg,
    }

  def to_example(self) -> Example:
    """Serializable example, wire-compatible with the reference's
    tf.Example schema (reference: pre_lib.py:764-787); in training mode
    it carries the label row."""
    data = self.extract_features()
    ex = Example()
    ex.add_bytes('subreads/encoded', [data.tobytes()])
    ex.add_int64('subreads/shape', list(data.shape))
    ex.add_int64('subreads/num_passes', [self.keep_subreads])
    ex.add_bytes('name', [self.name.encode()])
    ex.add_int64('window_pos', [self.ccs.ccs_bounds.start])
    ex.add_int64(
        'ccs_base_quality_scores', self.ccs.base_quality_scores.tolist()
    )
    if self.is_training:
      label = self.label.bases.astype(constants.NP_DATA_TYPE)
      ex.add_bytes('label/encoded', [label.tobytes()])
      ex.add_int64('label/shape', [label.shape[0]])
    return ex
