"""K5, K6 and K7: whole-window banded self-attention for training.

Counterpart of deepconsensus_tpu/ops/banded_attention.py, the kernels
the reference's model runs under `use_pallas_attention` at L <=
WHOLE_L_LIMIT:

  * K5 `banded_attention`: s = q k^T with -1e9 outside |i - j| <= win,
    m = rowmax, p = exp(s - m), o = (p v) / sum(p);
  * K7 `banded_attention_dropout`: w = p / sum(p), then
    o = (w * mask / keep_prob) v with a caller-drawn uint8 keep-mask;
  * K6 `banded_attention_bwd`: recomputes w from q and k, then
    dv = (w * drop)^T do, dw = (do v^T) * drop,
    ds = w * (dw - rowsum(dw * w)), dq = ds k, dk = ds^T q,
    with drop = mask / keep_prob, or 1 without a mask.

Tensors keep the reference's layout, q, k, v, do [B, L, H, D] with q
already scaled by D^-1/2, and mask [B, H, L, L]. Every product runs in
float32 and the outputs come back in q's dtype (float32 or bfloat16).

On a CUDA tensor each wrapper launches its kernel in
csrc/banded_attention.cu (K6 is two tensor-core kernels in one launch
call: dq with each row's softmax statistics, then dk and dv) and counts
the launch; on a CPU tensor it runs the plain version beside it,
which writes out the TPU kernel's arithmetic on full [L, L] blocks.
`banded_attention_vjp` and `banded_attention_dropout_vjp` are the
differentiable forms (K5 or K7 forward, K6 backward), saving q, k, v
(and the mask) and recomputing the weights as the TPU kernels do.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from deepconsensus_tpu_torch.ops import _build

# Launches of the CUDA kernels, one per wrapper call on CUDA tensors.
n_fwd_launches = 0          # K5
n_dropout_fwd_launches = 0  # K7
n_bwd_launches = 0          # K6

_NEG = -1e9
_DTYPES = (torch.float32, torch.bfloat16)
# Dynamic shared memory one block may use on the H100 (227 KB).
MAX_SMEM_BYTES = 232448
# K6 holds at most two column groups of 144 output columns a block.
MAX_BWD_HEAD_DIM = 256


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: Optional[torch.Tensor] = None,
           do: Optional[torch.Tensor] = None) -> None:
  """Raises unless q, k, v (and do) are one contiguous [B, L, H, D]
  float32 or bfloat16 layout on one device, and mask a contiguous uint8
  [B, H, L, L] beside them."""
  if q.dim() != 4:
    raise ValueError(f'q must be [B, L, H, D], got {tuple(q.shape)}')
  if q.dtype not in _DTYPES:
    raise ValueError(f'q must be one of {_DTYPES}, got {q.dtype}')
  if q.device.type not in ('cpu', 'cuda'):
    raise ValueError(f'unsupported device {q.device}')
  named = [('q', q), ('k', k), ('v', v)] + ([('do', do)] if do is not None
                                              else [])
  for name, t in named:
    if tuple(t.shape) != tuple(q.shape):
      raise ValueError(f'{name} shape {tuple(t.shape)}, want '
                       f'{tuple(q.shape)}')
    if t.dtype != q.dtype:
      raise ValueError(f'{name} is {t.dtype}, q is {q.dtype}')
    if t.device != q.device:
      raise ValueError(f'{name} is on {t.device}, q on {q.device}')
    if not t.is_contiguous():
      raise ValueError(f'{name} must be contiguous [B, L, H, D]')
  if mask is not None:
    b, length, h, _ = q.shape
    if mask.dtype != torch.uint8:
      raise ValueError(f'mask must be uint8, got {mask.dtype}')
    if tuple(mask.shape) != (b, h, length, length):
      raise ValueError(f'mask shape {tuple(mask.shape)}, want '
                       f'{(b, h, length, length)}')
    if mask.device != q.device:
      raise ValueError(f'mask is on {mask.device}, q on {q.device}')
    if not mask.is_contiguous():
      raise ValueError('mask must be contiguous')


def _check_keep_prob(keep_prob: float) -> float:
  keep_prob = float(keep_prob)
  if not 0.0 < keep_prob <= 1.0:
    raise ValueError(f'keep_prob must be in (0, 1], got {keep_prob}')
  return keep_prob


# ---------------------------------------------------------------------------
# Plain versions: the TPU kernels' arithmetic on full [L, L] blocks.
# ---------------------------------------------------------------------------


def _softmax_parts(q: torch.Tensor, k: torch.Tensor,
                   attn_win_size: Optional[int]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
  """float32 p = exp(s - rowmax) [B, H, L, L] and its row sums
  [B, H, L, 1], with s = q k^T filled with -1e9 outside the band."""
  s = torch.einsum('bihd,bjhd->bhij', q.float(), k.float())
  if attn_win_size is not None:
    i = torch.arange(q.shape[1], device=q.device)
    band = (i[:, None] - i[None, :]).abs() <= attn_win_size
    s = torch.where(band, s, torch.full((), _NEG, device=q.device))
  p = torch.exp(s - s.amax(-1, keepdim=True))
  return p, p.sum(-1, keepdim=True)


def banded_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           attn_win_size: Optional[int]) -> torch.Tensor:
  """K5's arithmetic: the division by sum(p) comes after the product."""
  p, denom = _softmax_parts(q, k, attn_win_size)
  o = torch.einsum('bhij,bjhd->bihd', p, v.float())
  return (o / denom.transpose(1, 2)).to(q.dtype)


def _drop(mask: Optional[torch.Tensor], keep_prob: float):
  return 1.0 if mask is None else mask.float() / keep_prob


def banded_attention_dropout_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, mask: torch.Tensor,
                                   attn_win_size: Optional[int],
                                   keep_prob: float) -> torch.Tensor:
  """K7's arithmetic: w = p / sum(p) before the mask and the product."""
  p, denom = _softmax_parts(q, k, attn_win_size)
  w = (p / denom) * _drop(mask, keep_prob)
  return torch.einsum('bhij,bjhd->bihd', w, v.float()).to(q.dtype)


def banded_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, mask: Optional[torch.Tensor],
                               do: torch.Tensor, attn_win_size: Optional[int],
                               keep_prob: float
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
  """K6's arithmetic; returns (dq, dk, dv) in q's dtype."""
  p, denom = _softmax_parts(q, k, attn_win_size)
  w = p / denom
  drop = _drop(mask, keep_prob)
  do32 = do.float()
  dv = torch.einsum('bhij,bihd->bjhd', w * drop, do32)
  dw = torch.einsum('bihd,bjhd->bhij', do32, v.float()) * drop
  ds = w * (dw - (dw * w).sum(-1, keepdim=True))
  dq = torch.einsum('bhij,bjhd->bihd', ds, k.float())
  dk = torch.einsum('bhij,bihd->bjhd', ds, q.float())
  return tuple(t.to(q.dtype) for t in (dq, dk, dv))


# ---------------------------------------------------------------------------
# The wrappers: the plain version on a CPU tensor, the kernel on a CUDA one.
# ---------------------------------------------------------------------------


def kernel_win(length: int, attn_win_size: Optional[int]) -> int:
  """The kernels' band half-width: no band is a band that covers the
  window."""
  if attn_win_size is None:
    return length - 1
  if attn_win_size < 0:
    raise ValueError(f'attn_win_size must be >= 0, got {attn_win_size}')
  return min(int(attn_win_size), length - 1)


def _launch_args(q: torch.Tensor, attn_win_size: Optional[int],
                 bwd: bool = False):
  """The library and the trailing launch arguments; raises for shapes
  the forward's shared memory (K5, K7) or K6's column groups do not
  take."""
  b, length, h, d = q.shape
  win = kernel_win(length, attn_win_size)
  if bwd and d > MAX_BWD_HEAD_DIM:
    raise ValueError(f'head width {d} > {MAX_BWD_HEAD_DIM}: K6 holds at most '
                     'two column groups of 144')
  lib = _build.load('banded_attention')
  if not bwd:
    smem = lib.dc_banded_attention_smem_bytes(length, d, win)
    if smem > MAX_SMEM_BYTES:
      raise ValueError(
          f'banded attention at L={length}, D={d}, band +-{win} needs '
          f'{smem} B of shared memory per block, over {MAX_SMEM_BYTES}')
  return lib, (int(q.dtype == torch.bfloat16), b, length, h, d, win)


def _launch_fwd(q, k, v, mask, attn_win_size, keep_prob) -> torch.Tensor:
  lib, tail = _launch_args(q, attn_win_size)
  out = torch.empty_like(q)
  _build.launch(lib.dc_banded_attention_fwd, 'banded_attention_fwd',
                q.device, _build.ptr(q), _build.ptr(k), _build.ptr(v),
                _build.ptr(mask), float(keep_prob), _build.ptr(out), *tail)
  return out


def banded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     attn_win_size: Optional[int]) -> torch.Tensor:
  """K5: [B, L, H, D] q (pre-scaled), k, v -> o in q's dtype."""
  global n_fwd_launches
  check_inputs(q, k, v)
  if q.device.type == 'cpu':
    return banded_attention_plain(q, k, v, attn_win_size)
  out = _launch_fwd(q, k, v, None, attn_win_size, 1.0)
  n_fwd_launches += 1
  return out


def banded_attention_dropout(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, mask: torch.Tensor,
                             attn_win_size: Optional[int],
                             keep_prob: float) -> torch.Tensor:
  """K7: K5's inputs plus a uint8 keep-mask [B, H, L, L] on the
  attention weights."""
  global n_dropout_fwd_launches
  if mask is None:
    raise ValueError('the dropout forward needs a keep-mask')
  check_inputs(q, k, v, mask)
  keep_prob = _check_keep_prob(keep_prob)
  if q.device.type == 'cpu':
    return banded_attention_dropout_plain(q, k, v, mask, attn_win_size,
                                          keep_prob)
  out = _launch_fwd(q, k, v, mask, attn_win_size, keep_prob)
  n_dropout_fwd_launches += 1
  return out


def banded_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         mask: Optional[torch.Tensor], do: torch.Tensor,
                         attn_win_size: Optional[int], keep_prob: float
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
  """K6: (dq, dk, dv) for the cotangent do of K5 (mask None) or K7."""
  global n_bwd_launches
  check_inputs(q, k, v, mask, do)
  keep_prob = _check_keep_prob(keep_prob)
  if q.device.type == 'cpu':
    return banded_attention_bwd_plain(q, k, v, mask, do, attn_win_size,
                                      keep_prob)
  lib, tail = _launch_args(q, attn_win_size, bwd=True)
  dq, dk, dv = (torch.empty_like(q) for _ in range(3))
  b, length, h, _ = q.shape
  # Per query row: the softmax's max, 1 / its sum, and rowsum(dw * w).
  stats = torch.empty((b, h, length, 3), dtype=torch.float32,
                      device=q.device)
  _build.launch(lib.dc_banded_attention_bwd, 'banded_attention_bwd',
                q.device, _build.ptr(q), _build.ptr(k), _build.ptr(v),
                _build.ptr(mask), _build.ptr(do), float(keep_prob),
                _build.ptr(dq), _build.ptr(dk), _build.ptr(dv),
                _build.ptr(stats), *tail)
  n_bwd_launches += 1
  return dq, dk, dv


class BandedAttention(torch.autograd.Function):
  """K5 forward, K6 without a mask backward."""

  @staticmethod
  def forward(ctx, q, k, v, attn_win_size):
    ctx.save_for_backward(q, k, v)
    ctx.attn_win_size = attn_win_size
    return banded_attention(q, k, v, attn_win_size)

  @staticmethod
  def backward(ctx, do):
    q, k, v = ctx.saved_tensors
    dq, dk, dv = banded_attention_bwd(
        q, k, v, None, do.to(q.dtype).contiguous(), ctx.attn_win_size, 1.0)
    return dq, dk, dv, None


class BandedAttentionDropout(torch.autograd.Function):
  """K7 forward, K6 with the same mask backward."""

  @staticmethod
  def forward(ctx, q, k, v, mask, attn_win_size, keep_prob):
    ctx.save_for_backward(q, k, v, mask)
    ctx.attn_win_size, ctx.keep_prob = attn_win_size, keep_prob
    return banded_attention_dropout(q, k, v, mask, attn_win_size, keep_prob)

  @staticmethod
  def backward(ctx, do):
    q, k, v, mask = ctx.saved_tensors
    dq, dk, dv = banded_attention_bwd(
        q, k, v, mask, do.to(q.dtype).contiguous(), ctx.attn_win_size,
        ctx.keep_prob)
    return dq, dk, dv, None, None, None


def banded_attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         attn_win_size: Optional[int]) -> torch.Tensor:
  """Differentiable K5 (the reference's banded_attention_vjp)."""
  return BandedAttention.apply(q, k, v, attn_win_size)


def banded_attention_dropout_vjp(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, mask: torch.Tensor,
                                 attn_win_size: Optional[int],
                                 keep_prob: float) -> torch.Tensor:
  """Differentiable K7 (the reference's banded_attention_dropout_vjp);
  the mask gets no gradient."""
  return BandedAttentionDropout.apply(q, k, v, mask, attn_win_size,
                                      float(keep_prob))
