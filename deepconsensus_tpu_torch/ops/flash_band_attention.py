"""K8, K9 and K10: block-banded flash attention for long windows.

Counterpart of deepconsensus_tpu/ops/flash_band_attention.py, the
kernels the reference's model runs under `use_pallas_attention` at
WHOLE_L_LIMIT (128) < L < RING_ATTENTION_MIN_LEN (256) without attention
dropout:

  * K8 `flash_band_attention`: s = q k^T with -1e9 outside
    |i - j| <= win, an online softmax over key tiles, o = (p v) / sum(p),
    and with with_lse the row logsumexp m + log(sum(p)) the backward
    needs; a row with no valid key gets o = 0 and lse = 0;
  * K9 `flash_band_dq`: w = exp(s - lse) inside the band and 0 outside,
    ds = w * (do v^T - delta), dq = ds k;
  * K10 `flash_band_dkdv`: dk = ds^T q, dv = w^T do;

with delta = rowsum(do * o) in float32 (`row_delta`), formed between the
kernels from the stored o, as the reference forms it between its Pallas
calls. win=None is full attention.

Tensors keep the reference's layout, q, k, v, do [B, L, H, D] with q
already scaled by D^-1/2; lse and delta are [B, H, L] float32 (the
reference's [B*H, L]). Every sum runs in float32 and o, dq, dk, dv come
back in q's dtype (float32 or bfloat16).

On a CUDA tensor each wrapper launches its kernel in
csrc/flash_band_attention.cu (all three on the tensor cores) and counts
the launch; on a CPU tensor it runs the plain version beside it, which
writes the same arithmetic out on full [L, L] blocks.
`FlashBandAttention` is the differentiable form (K8 with lse forward, K9
and K10 backward); `flash_band_attention_vjp` takes K8 without lse when
no input needs a gradient, as the reference's custom VJP runs its
primal.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from deepconsensus_tpu_torch.ops import _build
from deepconsensus_tpu_torch.ops import banded_attention as ba

# Launches of the CUDA kernels, one per wrapper call on CUDA tensors.
n_fwd_launches = 0      # K8 without lse
n_fwd_lse_launches = 0  # K8 with lse
n_dq_launches = 0       # K9
n_dkdv_launches = 0     # K10

_NEG = -1e9
# The kernels hold at most 144 output columns a block and take D > 144
# in two column groups.
MAX_HEAD_DIM = 256


def _check_stats(q: torch.Tensor, **stats: torch.Tensor) -> None:
  """Raises unless each of lse / delta is a contiguous float32 [B, H, L]
  on q's device."""
  b, length, h, _ = q.shape
  for name, t in stats.items():
    if t.dtype != torch.float32:
      raise ValueError(f'{name} must be float32, got {t.dtype}')
    if tuple(t.shape) != (b, h, length):
      raise ValueError(f'{name} shape {tuple(t.shape)}, want '
                       f'{(b, h, length)}')
    if t.device != q.device:
      raise ValueError(f'{name} is on {t.device}, q on {q.device}')
    if not t.is_contiguous():
      raise ValueError(f'{name} must be contiguous')


# ---------------------------------------------------------------------------
# Plain versions: the TPU kernels' arithmetic on full [L, L] blocks.
# ---------------------------------------------------------------------------


def _scores(q: torch.Tensor, k: torch.Tensor, attn_win_size: Optional[int]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
  """float32 s = q k^T [B, H, L, L], -1e9 outside the band, and the band
  [L, L]."""
  s = torch.einsum('bihd,bjhd->bhij', q.float(), k.float())
  i = torch.arange(q.shape[1], device=q.device)
  valid = (i[:, None] - i[None, :]).abs() <= (
      q.shape[1] if attn_win_size is None else attn_win_size)
  return torch.where(valid, s, torch.full((), _NEG, device=q.device)), valid


def flash_band_attention_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, attn_win_size: Optional[int],
                               with_lse: bool = False):
  """K8's arithmetic: o in q's dtype, and with with_lse (o, lse)."""
  s, valid = _scores(q, k, attn_win_size)
  m = s.amax(-1, keepdim=True)
  p = torch.where(valid, torch.exp(s - m), torch.zeros((), device=q.device))
  total = p.sum(-1, keepdim=True)
  empty = total == 0.0
  denom = torch.where(empty, torch.ones((), device=q.device), total)
  o = torch.einsum('bhij,bjhd->bihd', p, v.float()) / denom.transpose(1, 2)
  o = o.to(q.dtype)
  if not with_lse:
    return o
  lse = torch.where(empty, torch.zeros((), device=q.device),
                    m + torch.log(denom))
  return o, lse.squeeze(-1)


def _weights_and_ds(q, k, v, do, lse, delta, attn_win_size):
  """float32 w = exp(s - lse) in the band (0 outside) and ds, both
  [B, H, L, L]."""
  s, valid = _scores(q, k, attn_win_size)
  w = torch.where(valid, torch.exp(s - lse[..., None]),
                  torch.zeros((), device=q.device))
  dw = torch.einsum('bihd,bjhd->bhij', do.float(), v.float())
  return w, w * (dw - delta[..., None])


def flash_band_dq_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        do: torch.Tensor, lse: torch.Tensor,
                        delta: torch.Tensor,
                        attn_win_size: Optional[int]) -> torch.Tensor:
  """K9's arithmetic: dq in q's dtype."""
  _, ds = _weights_and_ds(q, k, v, do, lse, delta, attn_win_size)
  return torch.einsum('bhij,bjhd->bihd', ds, k.float()).to(q.dtype)


def flash_band_dkdv_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          do: torch.Tensor, lse: torch.Tensor,
                          delta: torch.Tensor, attn_win_size: Optional[int]
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
  """K10's arithmetic: (dk, dv) in q's dtype."""
  w, ds = _weights_and_ds(q, k, v, do, lse, delta, attn_win_size)
  dk = torch.einsum('bhij,bihd->bjhd', ds, q.float())
  dv = torch.einsum('bhij,bihd->bjhd', w, do.float())
  return dk.to(q.dtype), dv.to(q.dtype)


def row_delta(do: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
  """delta = sum_d do * o in float32, [B, L, H, D] -> [B, H, L]."""
  return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


# ---------------------------------------------------------------------------
# The wrappers: the plain version on a CPU tensor, the kernel on a CUDA one.
# ---------------------------------------------------------------------------


def _launch_args(q: torch.Tensor, attn_win_size: Optional[int]):
  b, length, h, d = q.shape
  if d > MAX_HEAD_DIM:
    raise ValueError(f'head width {d} > {MAX_HEAD_DIM}: the kernels hold at '
                     'most two column groups of 144')
  return _build.load('flash_band_attention'), (
      int(q.dtype == torch.bfloat16), b, length, h, d,
      ba.kernel_win(length, attn_win_size))


def flash_band_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         attn_win_size: Optional[int],
                         with_lse: bool = False):
  """K8: [B, L, H, D] q (pre-scaled), k, v -> o in q's dtype, and with
  with_lse (o, lse [B, H, L] float32)."""
  global n_fwd_launches, n_fwd_lse_launches
  ba.check_inputs(q, k, v)
  if q.device.type == 'cpu':
    return flash_band_attention_plain(q, k, v, attn_win_size, with_lse)
  lib, tail = _launch_args(q, attn_win_size)
  o = torch.empty_like(q)
  b, length, h, _ = q.shape
  lse = (torch.empty((b, h, length), dtype=torch.float32, device=q.device)
         if with_lse else None)
  _build.launch(lib.dc_flash_band_fwd, 'flash_band_fwd', q.device,
                _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(o),
                _build.ptr(lse), *tail)
  if with_lse:
    n_fwd_lse_launches += 1
    return o, lse
  n_fwd_launches += 1
  return o


def flash_band_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  attn_win_size: Optional[int]) -> torch.Tensor:
  """K9: dq from K8's lse and delta = row_delta(do, o)."""
  global n_dq_launches
  ba.check_inputs(q, k, v, do=do)
  _check_stats(q, lse=lse, delta=delta)
  if q.device.type == 'cpu':
    return flash_band_dq_plain(q, k, v, do, lse, delta, attn_win_size)
  lib, tail = _launch_args(q, attn_win_size)
  dq = torch.empty_like(q)
  _build.launch(lib.dc_flash_band_dq, 'flash_band_dq', q.device,
                _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(do),
                _build.ptr(lse), _build.ptr(delta), _build.ptr(dq), *tail)
  n_dq_launches += 1
  return dq


def flash_band_dkdv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    do: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                    attn_win_size: Optional[int]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
  """K10: (dk, dv) from K8's lse and delta."""
  global n_dkdv_launches
  ba.check_inputs(q, k, v, do=do)
  _check_stats(q, lse=lse, delta=delta)
  if q.device.type == 'cpu':
    return flash_band_dkdv_plain(q, k, v, do, lse, delta, attn_win_size)
  lib, tail = _launch_args(q, attn_win_size)
  dk, dv = torch.empty_like(q), torch.empty_like(q)
  _build.launch(lib.dc_flash_band_dkdv, 'flash_band_dkdv', q.device,
                _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(do),
                _build.ptr(lse), _build.ptr(delta), _build.ptr(dk),
                _build.ptr(dv), *tail)
  n_dkdv_launches += 1
  return dk, dv


class FlashBandAttention(torch.autograd.Function):
  """K8 with lse forward; delta, then K9 and K10 backward."""

  @staticmethod
  def forward(ctx, q, k, v, attn_win_size):
    o, lse = flash_band_attention(q, k, v, attn_win_size, with_lse=True)
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.attn_win_size = attn_win_size
    return o

  @staticmethod
  def backward(ctx, do):
    q, k, v, o, lse = ctx.saved_tensors
    do = do.to(q.dtype).contiguous()
    delta = row_delta(do, o)
    dq = flash_band_dq(q, k, v, do, lse, delta, ctx.attn_win_size)
    dk, dv = flash_band_dkdv(q, k, v, do, lse, delta, ctx.attn_win_size)
    return dq, dk, dv, None


def flash_band_attention_vjp(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor,
                             attn_win_size: Optional[int]) -> torch.Tensor:
  """Differentiable K8 (the reference's flash_band_attention_vjp): the
  forward without lse when no input needs a gradient (eval, inference)."""
  if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
    return FlashBandAttention.apply(q, k, v, attn_win_size)
  return flash_band_attention(q, k, v, attn_win_size)
