"""K11-K14: the alignment loss's wavefront DP on the card.

Counterpart of deepconsensus_tpu/ops/wavefront_pallas.py. The scorer
`alignment_scores` is K11 without rows; `alignment_scores_vjp` is the
differentiable twin: on a CUDA tensor its forward is K11 writing every
DP row V[k] as the residual, and its backward K12, the reverse adjoint
sweep over those rows (csrc/wavefront.cu). `banded_alignment_scores`
and `banded_alignment_scores_vjp` are the same pair for the band of
width W (AlignmentLoss's band_width): K13 forward, K14 backward. On a
CPU tensor they all run the plain DPs (ops/wavefront.py::alignment_scan
and ::banded_alignment_scan, differentiated by torch autograd), which
is what the kernels are held against. Costs are float32, as the
reference's kernels take them; gradients come back in the costs' dtype.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from deepconsensus_tpu_torch.ops import _build
from deepconsensus_tpu_torch.ops import wavefront

# Launches of the CUDA kernels: K11 (forward, with or without rows) and
# K12 (backward), K13 and K14 their banded twins, one per call on CUDA
# tensors.
n_fwd_launches = 0
n_bwd_launches = 0
n_band_fwd_launches = 0
n_band_bwd_launches = 0

# One block per batch row: warps of 32 lanes holding 1, 2 or 4 DP row
# indices i <= m each (K11/K12, at most 8 warps), or one warp holding the
# band slots d <= 2W, up to 32 a lane (K13/K14).
MAX_M = 1023
MAX_WIDTH = 511


def _check_inputs(subs_costs: torch.Tensor, ins_costs: torch.Tensor,
                  seq_lens: torch.Tensor) -> Tuple[int, int, int]:
  batch, m, n = _check_shapes(subs_costs, ins_costs, seq_lens)
  if m > MAX_M:
    raise ValueError(f'm = {m}: the kernels hold a batch row\'s DP row '
                     f'indices in one block and take m + 1 <= {MAX_M + 1}')
  return batch, m, n


def _check_band_inputs(subs_costs: torch.Tensor, ins_costs: torch.Tensor,
                       seq_lens: torch.Tensor, width: int) -> None:
  """The banded kernels' rules (K13/K14)."""
  _, m, n = _check_shapes(subs_costs, ins_costs, seq_lens)
  if m != n:
    raise ValueError(f'banded alignment requires m == n, got {m} x {n}')
  if not 1 <= width <= MAX_WIDTH:
    raise ValueError(f'band width {width}: the kernels take 1 <= width and '
                     f'2 * width + 1 <= {2 * MAX_WIDTH + 2} (one warp holds '
                     'the band, up to 32 slots a lane)')
  for name, t in (('subs_costs', subs_costs), ('ins_costs', ins_costs)):
    if t.dtype != torch.float32:
      raise ValueError(f'{name} is {t.dtype}; the banded DP takes float32 '
                       'costs')


def _check_shapes(subs_costs: torch.Tensor, ins_costs: torch.Tensor,
                  seq_lens: torch.Tensor) -> Tuple[int, int, int]:
  if subs_costs.dim() != 3:
    raise ValueError(f'subs_costs must be [B, m, n], got '
                     f'{tuple(subs_costs.shape)}')
  batch, m, n = subs_costs.shape
  if tuple(ins_costs.shape) != (batch, n):
    raise ValueError(f'ins_costs shape {tuple(ins_costs.shape)}, want '
                     f'{(batch, n)}')
  if tuple(seq_lens.shape) != (batch,):
    raise ValueError(f'seq_lens shape {tuple(seq_lens.shape)}, want '
                     f'{(batch,)}')
  for name, t in (('subs_costs', subs_costs), ('ins_costs', ins_costs),
                  ('seq_lens', seq_lens)):
    if t.device != subs_costs.device:
      raise ValueError(f'{name} is on {t.device}, subs_costs on '
                       f'{subs_costs.device}')
  if subs_costs.device.type not in ('cpu', 'cuda'):
    raise ValueError(f'unsupported device {subs_costs.device}')
  return batch, m, n


def _operands(subs_costs, ins_costs, seq_lens):
  return (subs_costs.float().contiguous(), ins_costs.float().contiguous(),
          seq_lens.to(torch.int32).contiguous())


def _soft(loss_reg: Optional[float]) -> Tuple[float, int]:
  return (1.0, 0) if loss_reg is None else (float(loss_reg), 1)


def _launch_fwd(subs, ins, lens, del_cost, loss_reg, inf, emit_rows):
  """K11 on prepared operands; returns (scores [B], rows or None)."""
  global n_fwd_launches
  batch, m, n = subs.shape
  scores = torch.empty((batch,), dtype=torch.float32, device=subs.device)
  rows = (torch.empty((m + n + 1, batch, m + 1), dtype=torch.float32,
                      device=subs.device) if emit_rows else None)
  reg, soft = _soft(loss_reg)
  _build.launch(
      _build.load('wavefront').dc_wavefront_fwd, 'wavefront_fwd',
      subs.device, _build.ptr(subs), _build.ptr(ins), _build.ptr(lens),
      batch, m, n, float(del_cost), reg, soft, float(inf), _build.ptr(scores),
      _build.ptr(rows))
  n_fwd_launches += 1
  return scores, rows


def launch_bwd(subs, ins, lens, rows, grad, del_cost, loss_reg):
  """K12 on prepared operands (float32 costs, int32 lengths, the rows
  K11 wrote, grad [B] float32); returns (d_subs [B, m, n], d_ins
  [B, n])."""
  global n_bwd_launches
  batch, m, n = subs.shape
  if tuple(rows.shape) != (m + n + 1, batch, m + 1):
    raise ValueError(f'rows shape {tuple(rows.shape)}, want '
                     f'{(m + n + 1, batch, m + 1)}')
  d_subs = torch.empty_like(subs)
  d_ins = torch.empty_like(ins)
  reg, soft = _soft(loss_reg)
  grad = grad.float().contiguous()
  _build.launch(
      _build.load('wavefront').dc_wavefront_bwd, 'wavefront_bwd',
      subs.device, _build.ptr(subs), _build.ptr(ins), _build.ptr(lens),
      _build.ptr(rows), _build.ptr(grad), batch, m, n, float(del_cost), reg,
      soft, _build.ptr(d_subs), _build.ptr(d_ins))
  n_bwd_launches += 1
  return d_subs, d_ins


def alignment_scores_with_rows(subs_costs, ins_costs, del_cost, seq_lens,
                               loss_reg=None, inf=1e9):
  """K11 with rows on CUDA tensors: (scores [B], rows [m+n+1, B, m+1])."""
  _check_inputs(subs_costs, ins_costs, seq_lens)
  if subs_costs.device.type != 'cuda':
    raise ValueError('the rows residual is written by the CUDA kernel only')
  return _launch_fwd(*_operands(subs_costs, ins_costs, seq_lens), del_cost,
                     loss_reg, inf, emit_rows=True)


def alignment_scores(
    subs_costs: torch.Tensor,
    ins_costs: torch.Tensor,
    del_cost: float,
    seq_lens: torch.Tensor,
    loss_reg: Optional[float] = None,
    inf: float = 1e9,
) -> torch.Tensor:
  """K11 without rows (same arguments and semantics as
  wavefront.alignment_scan): [B] float32 scores."""
  _check_inputs(subs_costs, ins_costs, seq_lens)
  if subs_costs.device.type == 'cpu':
    return wavefront.alignment_scan(subs_costs.float(), ins_costs.float(),
                                    del_cost, seq_lens, loss_reg, inf)
  scores, _ = _launch_fwd(*_operands(subs_costs, ins_costs, seq_lens),
                          del_cost, loss_reg, inf, emit_rows=False)
  return scores


class AlignmentScores(torch.autograd.Function):
  """Forward K11 with rows saved; backward K12."""

  @staticmethod
  def forward(ctx, subs_costs, ins_costs, seq_lens, del_cost, loss_reg,
              inf):
    subs, ins, lens = _operands(subs_costs, ins_costs, seq_lens)
    scores, rows = _launch_fwd(subs, ins, lens, del_cost, loss_reg, inf,
                               emit_rows=True)
    ctx.save_for_backward(subs, ins, lens, rows)
    ctx.del_cost, ctx.loss_reg = del_cost, loss_reg
    ctx.dtypes = (subs_costs.dtype, ins_costs.dtype)
    return scores

  @staticmethod
  def backward(ctx, grad):
    subs, ins, lens, rows = ctx.saved_tensors
    d_subs, d_ins = launch_bwd(subs, ins, lens, rows, grad, ctx.del_cost,
                               ctx.loss_reg)
    return (d_subs.to(ctx.dtypes[0]), d_ins.to(ctx.dtypes[1]), None, None,
            None, None)


def alignment_scores_vjp(
    subs_costs: torch.Tensor,
    ins_costs: torch.Tensor,
    seq_lens: torch.Tensor,
    del_cost: float,
    loss_reg: Optional[float],
    inf: float = 1e9,
) -> torch.Tensor:
  """Differentiable scorer (argument order of the reference's
  alignment_scores_vjp): K11 with rows and K12 on CUDA tensors, the
  plain DP under autograd on CPU tensors."""
  _check_inputs(subs_costs, ins_costs, seq_lens)
  if subs_costs.device.type == 'cpu':
    return wavefront.alignment_scan(subs_costs, ins_costs, del_cost,
                                    seq_lens, loss_reg, inf)
  return AlignmentScores.apply(subs_costs, ins_costs, seq_lens,
                               float(del_cost), loss_reg, float(inf))


def _launch_band_fwd(subs, ins, lens, width, del_cost, loss_reg, inf,
                     emit_rows):
  """K13 on prepared operands; returns (scores [B], rows or None)."""
  global n_band_fwd_launches
  batch, m, _ = subs.shape
  scores = torch.empty((batch,), dtype=torch.float32, device=subs.device)
  rows = (torch.empty((2 * m - 1, batch, 2 * width + 1), dtype=torch.float32,
                      device=subs.device) if emit_rows else None)
  reg, soft = _soft(loss_reg)
  _build.launch(
      _build.load('wavefront').dc_band_fwd, 'band_fwd', subs.device,
      _build.ptr(subs), _build.ptr(ins), _build.ptr(lens), batch, m, width,
      float(del_cost), reg, soft, float(inf), _build.ptr(scores),
      _build.ptr(rows))
  n_band_fwd_launches += 1
  return scores, rows


def launch_band_bwd(subs, ins, lens, rows, grad, width, del_cost, loss_reg,
                    inf=1e9):
  """K14 on prepared operands (float32 costs, int32 lengths, the rows
  K13 wrote, grad [B] float32); returns (d_subs [B, m, m], d_ins
  [B, m])."""
  global n_band_bwd_launches
  batch, m, _ = subs.shape
  if tuple(rows.shape) != (2 * m - 1, batch, 2 * width + 1):
    raise ValueError(f'rows shape {tuple(rows.shape)}, want '
                     f'{(2 * m - 1, batch, 2 * width + 1)}')
  d_subs = torch.empty_like(subs)
  d_ins = torch.empty_like(ins)
  reg, soft = _soft(loss_reg)
  grad = grad.float().contiguous()
  _build.launch(
      _build.load('wavefront').dc_band_bwd, 'band_bwd', subs.device,
      _build.ptr(subs), _build.ptr(ins), _build.ptr(lens), _build.ptr(rows),
      _build.ptr(grad), batch, m, width, float(del_cost), reg, soft,
      float(inf), _build.ptr(d_subs), _build.ptr(d_ins))
  n_band_bwd_launches += 1
  return d_subs, d_ins


def banded_alignment_scores_with_rows(subs_costs, ins_costs, del_cost,
                                      seq_lens, width, loss_reg=None,
                                      inf=1e9):
  """K13 with rows on CUDA tensors: (scores [B], rows [2m-1, B, 2W+1],
  the band rows k = 2..2m)."""
  _check_band_inputs(subs_costs, ins_costs, seq_lens, width)
  if subs_costs.device.type != 'cuda':
    raise ValueError('the rows residual is written by the CUDA kernel only')
  return _launch_band_fwd(*_operands(subs_costs, ins_costs, seq_lens),
                          int(width), del_cost, loss_reg, inf,
                          emit_rows=True)


def banded_alignment_scores(
    subs_costs: torch.Tensor,
    ins_costs: torch.Tensor,
    del_cost: float,
    seq_lens: torch.Tensor,
    width: int,
    loss_reg: Optional[float] = None,
    inf: float = 1e9,
) -> torch.Tensor:
  """K13 without rows (same arguments and semantics as
  wavefront.banded_alignment_scan, width >= 1): [B] float32 scores."""
  _check_band_inputs(subs_costs, ins_costs, seq_lens, width)
  if subs_costs.device.type == 'cpu':
    return wavefront.banded_alignment_scan(subs_costs, ins_costs, del_cost,
                                           seq_lens, int(width), loss_reg,
                                           inf)
  scores, _ = _launch_band_fwd(*_operands(subs_costs, ins_costs, seq_lens),
                               int(width), del_cost, loss_reg, inf,
                               emit_rows=False)
  return scores


class BandedAlignmentScores(torch.autograd.Function):
  """Forward K13 with rows saved; backward K14."""

  @staticmethod
  def forward(ctx, subs_costs, ins_costs, seq_lens, del_cost, loss_reg,
              width, inf):
    subs, ins, lens = _operands(subs_costs, ins_costs, seq_lens)
    scores, rows = _launch_band_fwd(subs, ins, lens, width, del_cost,
                                    loss_reg, inf, emit_rows=True)
    ctx.save_for_backward(subs, ins, lens, rows)
    ctx.args = (width, del_cost, loss_reg, inf)
    return scores

  @staticmethod
  def backward(ctx, grad):
    subs, ins, lens, rows = ctx.saved_tensors
    width, del_cost, loss_reg, inf = ctx.args
    d_subs, d_ins = launch_band_bwd(subs, ins, lens, rows, grad, width,
                                    del_cost, loss_reg, inf)
    return d_subs, d_ins, None, None, None, None, None


def banded_alignment_scores_vjp(
    subs_costs: torch.Tensor,
    ins_costs: torch.Tensor,
    seq_lens: torch.Tensor,
    del_cost: float,
    loss_reg: Optional[float],
    width: int,
    inf: float = 1e9,
) -> torch.Tensor:
  """Differentiable banded scorer (argument order of the reference's
  banded_alignment_scores_vjp): K13 with rows and K14 on CUDA tensors,
  the plain banded DP under autograd on CPU tensors."""
  _check_band_inputs(subs_costs, ins_costs, seq_lens, width)
  if subs_costs.device.type == 'cpu':
    return wavefront.banded_alignment_scan(subs_costs, ins_costs, del_cost,
                                           seq_lens, int(width), loss_reg,
                                           inf)
  return BandedAlignmentScores.apply(subs_costs, ins_costs, seq_lens,
                                     float(del_cost), loss_reg, int(width),
                                     float(inf))
