"""Device output plane: softmax preds -> uint8 (base ids, Phred quals).

Port of deepconsensus_tpu/ops/output_plane.py. The device never
evaluates a logarithm: the host bisects, against the numpy quality
pipeline, the smallest float32 probability at which each integer
quality becomes reachable (`quality_thresholds`, copied byte for byte
with its helpers, since byte identity depends on them), and the device
counts the thresholds each position's max probability clears. K3
(`phred_epilogue`) fuses that count with the argmax in one pass:
`csrc/phred_epilogue.cu` on a CUDA tensor, `phred_epilogue_plain` on a
CPU tensor.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from deepconsensus_tpu_torch.calibration import lib as calibration_lib
from deepconsensus_tpu_torch.ops import _build

# The host epilogue's error-probability floor (runner._finalize_sync).
MIN_ERROR_PROB = 1e-12

# uint8 output plane: the largest quality the device contract can emit.
MAX_DEVICE_QUALITY = 255

# Verification probes per threshold build (vectorized, ~milliseconds):
# a uniform f32 sweep of [0, 1] plus a log-spaced cluster hugging
# p -> 1 where the quality curve is steepest.
_VERIFY_LINEAR = 1 << 16
_VERIFY_LOG = 1 << 14


def host_quality_reference(
    max_prob: np.ndarray,
    calibration_values: calibration_lib.QualityCalibrationValues,
    max_base_quality: int,
) -> np.ndarray:
  """The host epilogue, verbatim (runner._finalize_sync's tail).

  This is the oracle the threshold table is bisected against; it must
  stay operation-for-operation identical to the host fallback path —
  including dtype promotion inside calibrate_quality_scores — or the
  byte-identity contract silently breaks.
  """
  max_prob = np.asarray(max_prob)
  error_prob = np.maximum(1.0 - max_prob, MIN_ERROR_PROB)
  quality = -10.0 * np.log10(error_prob)
  if calibration_values.enabled:
    quality = calibration_lib.calibrate_quality_scores(
        quality, calibration_values)
  quality = np.minimum(quality, max_base_quality)
  quality = np.round(quality, decimals=0).astype(np.int32)
  return np.maximum(quality, 0)


def calibration_is_monotone(
    calibration_values: calibration_lib.QualityCalibrationValues) -> bool:
  """True when the calibrated quality is non-decreasing in the raw
  quality — the precondition for representing the prob->quality map as
  a threshold table. q*w+b applies above the threshold (everywhere
  when the threshold is 0), so monotonicity needs w >= 0 and no
  downward jump where the transform kicks in."""
  cv = calibration_values
  if not cv.enabled:
    return True
  if cv.w < 0:
    return False
  if cv.threshold > 0 and cv.threshold * cv.w + cv.b < cv.threshold:
    return False
  return True


def _bits(p: np.ndarray) -> np.ndarray:
  return np.asarray(p, np.float32).view(np.uint32).astype(np.int64)


def _from_bits(bits: np.ndarray) -> np.ndarray:
  return bits.astype(np.uint32).view(np.float32)


def quality_thresholds(
    calibration_values: calibration_lib.QualityCalibrationValues,
    max_base_quality: int,
) -> Optional[np.ndarray]:
  """Exact f32 probability thresholds for the device quality plane.

  thresholds[k-1] is the smallest float32 p in [0, 1] with
  host_quality_reference(p) >= k, found by bisection over the f32 bit
  lattice (non-negative floats are monotone in their bit patterns), so
  `sum(p >= thresholds)` reproduces the host integer exactly for every
  representable probability. Returns None when the map is not
  device-representable — non-monotone calibration, a top quality past
  the uint8 plane, or (defensively) a failed verification sweep — and
  the caller falls back to the host epilogue.
  """
  if not calibration_is_monotone(calibration_values):
    return None
  oracle = functools.partial(
      host_quality_reference,
      calibration_values=calibration_values,
      max_base_quality=max_base_quality)
  q_top = int(oracle(np.float32([1.0]))[0])
  if q_top > MAX_DEVICE_QUALITY:
    return None
  if q_top == 0:
    thresholds = np.zeros((0,), np.float32)
  else:
    ks = np.arange(1, q_top + 1, dtype=np.int64)
    # Invariant: oracle(lo) < k <= oracle(hi), over bit patterns.
    lo = np.full(q_top, -1, np.int64)  # one below bits(0.0) == 0
    hi = np.full(q_top, int(_bits(np.float32([1.0]))[0]), np.int64)
    while int((hi - lo).max()) > 1:
      active = (hi - lo) > 1
      mid = np.where(active, (lo + hi) // 2, hi)
      ge = oracle(_from_bits(mid)) >= ks
      hi = np.where(active & ge, mid, hi)
      lo = np.where(active & ~ge, mid, lo)
    thresholds = _from_bits(hi)
  if not _verify_thresholds(thresholds, oracle):
    return None  # pragma: no cover - defensive; bisection is exact
  return thresholds


def _verify_thresholds(thresholds: np.ndarray, oracle) -> bool:
  """Belt-and-braces sweep: the threshold count must match the oracle
  on a dense probe set evaluated at realistic (vectorized) array sizes,
  including every threshold's bit neighbourhood."""
  probes = [
      np.linspace(0.0, 1.0, _VERIFY_LINEAR, dtype=np.float32),
      (1.0 - np.logspace(-12, 0, _VERIFY_LOG)).astype(np.float32),
  ]
  if thresholds.size:
    bits = _bits(thresholds)[:, None] + np.arange(-2, 3)[None, :]
    bits = np.clip(bits, 0, int(_bits(np.float32([1.0]))[0]))
    probes.append(_from_bits(bits.ravel()))
  p = np.unique(np.concatenate(probes))
  p = p[(p >= 0.0) & (p <= 1.0)]
  counted = (p[:, None] >= thresholds[None, :]).sum(axis=1).astype(np.int32)
  return bool(np.array_equal(counted, oracle(p)))



# ---------------------------------------------------------------------------
# K3: argmax + threshold count.
# ---------------------------------------------------------------------------

# Launches of the CUDA kernel (one per call on a CUDA tensor).
n_launches = 0


def phred_epilogue_plain(
    preds: torch.Tensor, thresholds: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
  """Plain PyTorch K3: preds [B, L, V] f32, thresholds [K] f32 ->
  (ids uint8 [B, L], quals uint8 [B, L]). argmax takes the first of
  tied maxima, like jnp.argmax."""
  ids = torch.argmax(preds, dim=-1).to(torch.uint8)
  max_prob = preds.max(dim=-1).values
  quals = (max_prob[..., None] >= thresholds).sum(dim=-1).to(torch.uint8)
  return ids, quals


def phred_epilogue(
    preds: torch.Tensor, thresholds
) -> Tuple[torch.Tensor, torch.Tensor]:
  """K3. preds [B, L, V] float32 softmax output; thresholds from
  quality_thresholds (numpy or tensor, at most 255 values), which must
  be non-decreasing: the kernel counts them by binary search. A numpy
  table that is not is refused; a tensor's order is the caller's
  promise (checking it on the card would wait for the card). A CPU
  tensor runs the plain version; a CUDA tensor launches the kernel."""
  global n_launches
  if not isinstance(thresholds, torch.Tensor):
    thr_np = np.asarray(thresholds, np.float32)
    if np.isnan(thr_np).any() or (np.diff(thr_np) < 0).any():
      raise ValueError('thresholds must be non-decreasing (and not NaN)')
    thresholds = torch.from_numpy(thr_np)
  if preds.dim() != 3 or preds.dtype != torch.float32:
    raise ValueError(
        f'preds must be [B, L, V] float32, got {tuple(preds.shape)} '
        f'{preds.dtype}')
  if thresholds.numel() > MAX_DEVICE_QUALITY:
    raise ValueError(
        f'{thresholds.numel()} thresholds exceed the uint8 plane')
  dev = preds.device
  if dev.type == 'cpu':
    return phred_epilogue_plain(
        preds, thresholds.to(device=dev, dtype=torch.float32))
  if dev.type != 'cuda':
    raise ValueError(f'unsupported device {dev}')
  thr = thresholds
  if (thr.device != dev or thr.dtype != torch.float32
      or not thr.is_contiguous()):
    thr = thr.to(device=dev, dtype=torch.float32).contiguous()
  if not preds.is_contiguous():
    preds = preds.contiguous()
  b, length, vocab = preds.shape
  n = b * length
  out = torch.empty((2, b, length), dtype=torch.uint8, device=dev)
  planes = out.data_ptr()
  _build.launch(_build.load('phred_epilogue').dc_phred_epilogue,
                'phred_epilogue', dev, preds.data_ptr(), n, vocab,
                thr.data_ptr(), thr.numel(), planes, planes + n)
  n_launches += 1
  return out.unbind(0)
