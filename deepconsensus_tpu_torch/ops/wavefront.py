"""Anti-diagonal (wavefront) alignment DP, plain PyTorch.

Port of deepconsensus_tpu/ops/wavefront.py (`wavefrontify`,
`wavefrontify_vec`, `alignment_scan`). It is the plain version of the
CUDA kernels in ops/wavefront_cuda.py: `alignment_scan` is K11's
forward, and torch autograd through it is K12's backward.

Conventions: y_true has length m (padded), y_pred length n; DP matrices
are [m+1, n+1]; anti-diagonal k holds cells (i, k-i).
"""
from __future__ import annotations

from typing import Optional

import torch


def wavefrontify(t: torch.Tensor) -> torch.Tensor:
  """[B, m, n] -> [m+n-1, B, m] with out[k, b, i] = t[b, i, k-i].

  Out-of-range entries are 0.
  """
  _, m, n = t.shape
  k = torch.arange(m + n - 1, device=t.device)
  i = torch.arange(m, device=t.device)
  j = k[:, None] - i[None, :]  # [K, m]
  valid = (j >= 0) & (j < n)
  gathered = t[:, i[None, :], j.clamp(0, n - 1)]  # [B, K, m]
  gathered = torch.where(valid[None], gathered,
                         torch.zeros((), dtype=t.dtype, device=t.device))
  return gathered.permute(1, 0, 2)


def wavefrontify_vec(v: torch.Tensor, len1: int) -> torch.Tensor:
  """[B, n] -> [len1+n-1, B, len1] with out[k, b, i] = v[b, k-i]."""
  _, n = v.shape
  k = torch.arange(len1 + n - 1, device=v.device)
  i = torch.arange(len1, device=v.device)
  j = k[:, None] - i[None, :]
  valid = (j >= 0) & (j < n)
  gathered = v[:, j.clamp(0, n - 1)]  # [B, K, len1]
  gathered = torch.where(valid[None], gathered,
                         torch.zeros((), dtype=v.dtype, device=v.device))
  return gathered.permute(1, 0, 2)


def soft_min(t: torch.Tensor, loss_reg: Optional[float]) -> torch.Tensor:
  """Minimum over the leading axis of a [3, ...] stack: hard (ties share
  the gradient evenly, as jnp.min's does) or -reg * logsumexp(-t / reg)
  written as jax.nn.logsumexp writes it: the max is shifted out and held
  constant, so the gradient is exp(x - max) / sum, exact where
  exp(x - logsumexp) would carry the rounding of a logsumexp of
  magnitude |t| / reg."""
  if loss_reg is None:
    return torch.amin(t, dim=0)
  x = -t / loss_reg
  mx = torch.amax(x, dim=0).detach()
  return -loss_reg * (torch.log(torch.sum(torch.exp(x - mx), dim=0)) + mx)


def alignment_scan(
    subs_costs: torch.Tensor,
    ins_costs: torch.Tensor,
    del_cost: float,
    seq_lens: torch.Tensor,
    loss_reg: Optional[float],
    inf: float = 1e9,
) -> torch.Tensor:
  """Single-state edit DP over anti-diagonals (alignment loss core).

  Args:
    subs_costs: [B, m, n] substitution costs.
    ins_costs: [B, n] insertion costs (consuming a predicted base).
    del_cost: cost of deleting a true base.
    seq_lens: [B] true sequence lengths (excluding padding).
    loss_reg: soft-min temperature, or None for the hard minimum.
    inf: large positive float.

  Returns:
    [B] alignment scores, evaluated at cell (seq_lens[b], n).
  """
  batch, m, n = subs_costs.shape
  dev, dt = subs_costs.device, subs_costs.dtype
  subs_w = wavefrontify(subs_costs)  # [m+n-1, B, m]
  ins_w = wavefrontify_vec(ins_costs, m + 1)  # [m+n, B, m+1]
  i_range = torch.arange(m + 1, device=dev)
  seq_lens = seq_lens.to(device=dev, dtype=torch.long)
  k_end = seq_lens + n
  inf_t = torch.full((), inf, dtype=dt, device=dev)

  v_p2 = torch.full((batch, m), inf, dtype=dt, device=dev)
  v_p2[:, 0] = 0.0
  v_p1 = torch.cat([
      ins_w[0][:, :1],
      torch.full((batch, 1), del_cost, dtype=dt, device=dev),
      torch.full((batch, m - 1), inf, dtype=dt, device=dev),
  ], dim=1)
  v_opt = torch.full((batch,), inf, dtype=dt, device=dev)
  for k in range(2, m + n + 1):
    j_range = k - i_range
    valid = (j_range >= 0) & (j_range <= n)  # [m+1]
    o_m = v_p2 + subs_w[k - 2]
    o_i = v_p1 + ins_w[k - 1]
    v_p2_next = v_p1[:, :-1]
    o_d = v_p2_next + del_cost
    body = soft_min(torch.stack([o_m, o_i[:, 1:], o_d]), loss_reg)
    v_new = torch.cat([o_i[:, :1], body], dim=1)
    v_new = torch.where(valid[None, :], v_new, inf_t)
    v_at_len = torch.gather(v_new, 1, seq_lens[:, None])[:, 0]
    v_opt = torch.where(k_end == k, v_at_len, v_opt)
    v_p2, v_p1 = v_p2_next, v_new
  return v_opt
