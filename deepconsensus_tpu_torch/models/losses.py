"""Differentiable alignment loss (port of deepconsensus_tpu/models/losses.py).

AlignmentLoss is the reference's soft edit-distance training objective:
a wavefront DP over cross-entropy substitution and insertion costs with
a constant deletion cost and a logsumexp soft minimum. The costs are
plain torch, as the reference computes them outside Pallas; the DP is
K11/K12 (ops/wavefront_cuda.py) on the card and the plain DP on the
CPU. The banded DP (band_width, K13/K14) is not ported.
"""
from __future__ import annotations

from typing import Optional

import torch

from deepconsensus_tpu_torch import constants
from deepconsensus_tpu_torch.ops import wavefront
from deepconsensus_tpu_torch.ops import wavefront_cuda


def left_shift_sequence(y: torch.Tensor) -> torch.Tensor:
  """Moves internal gaps to the end of each row (the two-stage sort
  trick of the reference)."""
  seq_length = y.shape[1]
  ixs = torch.arange(seq_length, device=y.device).expand_as(y)
  sort_order = torch.sort(
      torch.where(y != constants.GAP_INT, ixs, seq_length + ixs), dim=1
  ).values
  sort_order = torch.where(sort_order < seq_length, sort_order,
                           sort_order - seq_length)
  return torch.gather(y, 1, sort_order)


def xentropy_subs_cost(y_true: torch.Tensor, y_pred: torch.Tensor,
                       eps: float = 1e-7) -> torch.Tensor:
  """[B, m, n] costs -log y_pred[b, j, y_true[b, i]] (an exact gather,
  as the reference takes it)."""
  log_p = torch.log(torch.clamp(y_pred, eps, 1 - eps))  # [B, n, V]
  b, n, _ = y_pred.shape
  index = y_true.long()[:, :, None].expand(b, y_true.shape[1], n)
  return -torch.gather(log_p.transpose(1, 2), 1, index)


def xentropy_ins_cost(y_pred: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
  """[B, n] insertion costs: -log P(gap)."""
  return -torch.log(torch.clamp(y_pred[..., constants.GAP_INT], eps, 1 - eps))


class AlignmentLoss:
  """Soft alignment loss; calling it returns the mean over the batch.

  While autograd records and y_pred requires a gradient, the DP runs
  with its rows saved (K11 with rows, then K12 in the backward);
  otherwise K11 scores alone. plain=True takes the plain DP on any
  device (the on-card reference run).
  """

  def __init__(self, del_cost: float = 1.0,
               loss_reg: Optional[float] = 1.0,
               width: Optional[int] = None, eps: float = 1e-7,
               inf: float = 1e9, plain: bool = False):
    if width is not None:
      raise NotImplementedError(
          f'band_width={width}: the banded alignment DP (K13/K14) is not '
          'ported yet (ROADMAP: training, banded loss)')
    self.del_cost = float(del_cost)
    self.loss_reg = None if loss_reg is None else float(loss_reg)
    self.eps = eps
    self.inf = inf
    self.plain = plain

  def per_example(self, y_true: torch.Tensor,
                  y_pred: torch.Tensor) -> torch.Tensor:
    """[B] loss values for y_true [B, m] labels and y_pred [B, n, V]."""
    y_true = left_shift_sequence(y_true.to(device=y_pred.device,
                                           dtype=torch.long))
    seq_lens = (y_true != constants.GAP_INT).sum(-1)
    y_pred = y_pred / y_pred.sum(-1, keepdim=True)
    subs_costs = xentropy_subs_cost(y_true, y_pred, self.eps)
    ins_costs = xentropy_ins_cost(y_pred, self.eps)
    if self.plain:
      return wavefront.alignment_scan(subs_costs, ins_costs, self.del_cost,
                                      seq_lens, self.loss_reg, self.inf)
    if torch.is_grad_enabled() and y_pred.requires_grad:
      return wavefront_cuda.alignment_scores_vjp(
          subs_costs, ins_costs, seq_lens, self.del_cost, self.loss_reg,
          self.inf)
    return wavefront_cuda.alignment_scores(
        subs_costs, ins_costs, self.del_cost, seq_lens, self.loss_reg,
        self.inf)

  def __call__(self, y_true: torch.Tensor,
               y_pred: torch.Tensor) -> torch.Tensor:
    return self.per_example(y_true, y_pred).mean()
