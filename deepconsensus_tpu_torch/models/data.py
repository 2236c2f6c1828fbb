"""Row formatting for model input (reference data_providers.py:128-184)."""
from __future__ import annotations

from typing import Sequence

import numpy as np

from deepconsensus_tpu_torch.faults import WindowBucketError
from deepconsensus_tpu_torch.models import config
from deepconsensus_tpu_torch.preprocess.pileup import (
    layout_from_shape,
    row_indices,
)


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
