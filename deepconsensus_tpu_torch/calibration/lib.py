"""Base-quality calibration: thresholded linear phred transform
(reference: deepconsensus/quality_calibration/calibration_lib.py:35-99).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class QualityCalibrationValues:
  enabled: bool
  threshold: float
  w: float
  b: float


def parse_calibration_string(calibration: str) -> QualityCalibrationValues:
  """Parses 'threshold,w,b' or 'skip'."""
  if calibration == 'skip':
    return QualityCalibrationValues(enabled=False, threshold=0.0, w=1.0, b=0.0)
  parts = calibration.split(',')
  if len(parts) != 3:
    raise ValueError(
        'Malformed calibration string; expected "threshold,w,b" or "skip": '
        f'{calibration!r}'
    )
  return QualityCalibrationValues(
      enabled=True,
      threshold=float(parts[0]),
      w=float(parts[1]),
      b=float(parts[2]),
  )


def calibration_string(values: QualityCalibrationValues) -> str:
  """Inverse of parse_calibration_string: a CLI-pasteable string, used
  by error messages that tell the operator the exact flag to re-run
  (e.g. exported-artifact epilogue mismatches)."""
  if not values.enabled:
    return 'skip'
  return f'{values.threshold:g},{values.w:g},{values.b:g}'


def calibrate_quality_scores(
    quality_scores: np.ndarray,
    calibration_values: QualityCalibrationValues,
) -> np.ndarray:
  """Applies q*w + b to scores above the threshold (all scores when the
  threshold is zero)."""
  q = np.asarray(quality_scores)
  cv = calibration_values
  if cv.threshold == 0:
    return q * cv.w + cv.b
  w = np.where(q > cv.threshold, cv.w, 1.0)
  b = np.where(q > cv.threshold, cv.b, 0.0)
  return q * w + b
