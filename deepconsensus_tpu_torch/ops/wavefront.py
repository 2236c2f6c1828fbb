"""Anti-diagonal (wavefront) alignment DP, plain PyTorch.

Port of deepconsensus_tpu/ops/wavefront.py (`wavefrontify`,
`wavefrontify_vec`, `alignment_scan`, `banded_alignment_scan`). It is
the plain version of the CUDA kernels in ops/wavefront_cuda.py:
`alignment_scan` is K11's forward and `banded_alignment_scan` K13's,
and torch autograd through them is K12's and K14's backward.

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


def banded_alignment_scan(
    subs_costs: torch.Tensor,
    ins_costs: torch.Tensor,
    del_cost: float,
    seq_lens: torch.Tensor,
    width: int,
    loss_reg: Optional[float],
    inf: float = 1e9,
) -> torch.Tensor:
  """Band-restricted edit DP in (anti-diagonal, offset) coordinates.

  Cell (x, y) (x true bases consumed, y predicted bases consumed) lives
  at band[k = x + y, d = y - x + width]. Moves into (x, y): diagonal
  subs[x-1, y-1], deletion from (x-1, y) at del_cost and insertion from
  (x, y-1) at ins[y-1], combined in the order (match, delete, insert).
  Odd-parity slots hold no cell and stay near `inf` (finite). The score
  is band[k, d] at (x, y) = (seq_lens, min(n, seq_lens + width)):
  trailing predicted positions outside the band are never charged.
  Requires square inputs (m == n); width 0 leaves the k = 1 row at inf.

  Returns [B] scores; with width >= m they equal alignment_scan's
  within rounding.
  """
  batch, m, n = subs_costs.shape
  if m != n:
    raise ValueError('banded alignment requires m == n')
  dev, dt = subs_costs.device, subs_costs.dtype
  n_diag = 2 * width + 1
  length = m + 1  # DP matrix side
  d = torch.arange(n_diag, device=dev)
  inf_t = torch.full((), inf, dtype=dt, device=dev)
  inf_col = torch.full((batch, 1), inf, dtype=dt, device=dev)

  # k = 0: only cell (0, 0) -> 0; k = 1: cells (1, 0) [d = width - 1]
  # at del_cost and (0, 1) [d = width + 1] at ins[0].
  band_p2 = torch.where((d == width)[None], torch.zeros((), dtype=dt,
                                                        device=dev),
                        inf_t).expand(batch, n_diag)
  band_p1 = torch.full((batch, n_diag), inf, dtype=dt, device=dev)
  if width >= 1:
    band_p1[:, width - 1] = del_cost
    band_p1 = torch.where((d == width + 1)[None], ins_costs[:, :1], band_p1)
  ins_pad = torch.cat([torch.zeros((batch, 1), dtype=ins_costs.dtype,
                                   device=dev), ins_costs], dim=1)

  # Cell coordinates of band slot (k, d): 2x = k - d + width,
  # 2y = k + d - width.
  def subs_at(k):
    x2 = k - d + width
    y2 = k + d - width
    valid = (x2 % 2 == 0) & (x2 >= 2) & (y2 >= 2) & (x2 <= 2 * m) & (
        y2 <= 2 * n)
    xi = torch.clamp(torch.div(x2, 2, rounding_mode='floor') - 1, 0, m - 1)
    yi = torch.clamp(torch.div(y2, 2, rounding_mode='floor') - 1, 0, n - 1)
    return torch.where(valid[None], subs_costs[:, xi, yi], inf_t)

  def ins_at(k):
    x2 = k - d + width
    y2 = k + d - width
    valid = (x2 % 2 == 0) & (x2 >= 0) & (y2 >= 0)
    y = torch.clamp(torch.div(y2, 2, rounding_mode='floor'), 0, n)
    return torch.where(valid[None], ins_pad[:, y], inf_t)

  all_rows = [band_p2, band_p1]
  for k in range(2, 2 * length - 1):
    o_m = band_p2 + subs_at(k)
    o_d = torch.cat([band_p1[:, 1:], inf_col], dim=1) + del_cost
    o_i = torch.cat([inf_col, band_p1[:, :-1]], dim=1) + ins_at(k)
    new = soft_min(torch.stack([o_m, o_d, o_i]), loss_reg)
    all_rows.append(new)
    band_p2, band_p1 = band_p1, new
  rows = torch.stack(all_rows)  # [2m+1, B, n_diag] for k = 0..2m

  seq_lens = seq_lens.to(device=dev, dtype=torch.long)
  y_end = torch.clamp(seq_lens + width, max=n)
  k_end = seq_lens + y_end
  d_end = y_end - seq_lens + width
  return rows[k_end, torch.arange(batch, device=dev), d_end]
