"""Launch helpers for the CUDA kernels shared by K1 and K2.

Thin ctypes calls: each checks its tensors, launches on the current
stream, and raises if the launch returned a CUDA error. Outputs are
allocated by the caller (the K1/K2 wrappers, with torch.empty). The
launch counts that prove the main path went through the kernels live
on the K1/K2/K3 wrappers, not here.
"""
from __future__ import annotations

from typing import Optional

import torch

from deepconsensus_tpu_torch.ops import _build

_DTYPES = (torch.float32, torch.bfloat16)


def _check(t: torch.Tensor, name: str, dtypes=_DTYPES) -> int:
  """Validates a kernel operand; returns 1 for bfloat16, 0 for f32."""
  if t.device.type != 'cuda':
    raise ValueError(f'{name} must be a CUDA tensor, got {t.device}')
  if t.dtype not in dtypes:
    raise ValueError(f'{name} must be one of {dtypes}, got {t.dtype}')
  if not t.is_contiguous():
    raise ValueError(f'{name} must be contiguous')
  return int(t.dtype == torch.bfloat16)


def gemm(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, *,
         scale: float = 1.0, scale_cols: int = 0,
         bias: Optional[torch.Tensor] = None,
         relu: bool = False,
         res: Optional[torch.Tensor] = None,
         alpha: Optional[torch.Tensor] = None) -> None:
  """out[M, N] = epilogue(a[M, K] @ b[K, N]) (csrc/gemm.cu): columns
  below scale_cols times scale, + bias, ReLU, then res + alpha * y."""
  m, k = a.shape
  k2, n = b.shape
  if k != k2 or tuple(out.shape) != (m, n):
    raise ValueError(f'gemm shapes {tuple(a.shape)} x {tuple(b.shape)} '
                     f'-> {tuple(out.shape)}')
  a_bf16 = _check(a, 'a')
  b_bf16 = _check(b, 'b')
  out_bf16 = _check(out, 'out')
  res_bf16 = 0
  if bias is not None:
    _check(bias, 'bias', (torch.float32,))
    if bias.numel() != n:
      raise ValueError(f'bias has {bias.numel()} values, want {n}')
  if res is not None:
    res_bf16 = _check(res, 'res')
    if tuple(res.shape) != (m, n):
      raise ValueError(f'res shape {tuple(res.shape)}, want {(m, n)}')
    if alpha is None or alpha.numel() != 1:
      raise ValueError('a residual needs a one-element alpha tensor')
    _check(alpha, 'alpha', (torch.float32,))
  lib = _build.load('gemm')
  _build.check(lib.dc_gemm(
      _build.ptr(a), a_bf16, _build.ptr(b), b_bf16, m, n, k, float(scale),
      int(scale_cols), _build.ptr(bias), int(relu),
      _build.ptr(res), res_bf16, _build.ptr(alpha), _build.ptr(out),
      out_bf16, _build.stream_ptr(a.device)), 'gemm')


def _check_lengths(lengths: Optional[torch.Tensor], batch: int) -> int:
  """Validates a ragged lengths operand ([B, wps] int32, non-negative
  window widths packed from the slot's start); returns wps (0 for
  None)."""
  if lengths is None:
    return 0
  _check(lengths, 'lengths', (torch.int32,))
  if lengths.dim() != 2 or lengths.shape[0] != batch:
    raise ValueError(f'lengths shape {tuple(lengths.shape)}, want '
                     f'({batch}, windows per slot)')
  return int(lengths.shape[1])


def embed_condense(rows: torch.Tensor, meta: torch.Tensor,
                   tables: torch.Tensor, w_cond: torch.Tensor,
                   pos: Optional[torch.Tensor], x_f32: torch.Tensor,
                   x_base_bf16: Optional[torch.Tensor],
                   lengths: Optional[torch.Tensor] = None) -> None:
  """x[b, l] = embed(rows[b, :, l]) @ w_cond + pos[l]
  (csrc/embed_condense.cu); rows [B, R, L] f32 raw pileup values, meta
  [5, K] int32 column map, tables the flat scaled embedding tables.
  With lengths (ragged slots) the position add is pos[l - start(l)] on
  positions inside a window and nothing elsewhere."""
  b, r, length = rows.shape
  wps = _check_lengths(lengths, b)
  k, n = w_cond.shape
  _check(rows, 'rows', (torch.float32,))
  _check(meta, 'meta', (torch.int32,))
  is_bf16 = _check(w_cond, 'w_cond')
  if _check(tables, 'tables') != is_bf16:
    raise ValueError('tables and w_cond must share the compute dtype')
  if pos is not None and (_check(pos, 'pos') != is_bf16
                          or tuple(pos.shape) != (length, n)):
    raise ValueError('pos must be [L, H] in the compute dtype')
  if tuple(meta.shape) != (5, k):
    raise ValueError(f'meta shape {tuple(meta.shape)}, want {(5, k)}')
  _check(x_f32, 'x_f32', (torch.float32,))
  if tuple(x_f32.shape) != (b, length, n):
    raise ValueError(f'x shape {tuple(x_f32.shape)}, want {(b, length, n)}')
  if x_base_bf16 is not None:
    _check(x_base_bf16, 'x_base', (torch.bfloat16,))
  lib = _build.load('embed_condense')
  _build.check(lib.dc_embed_condense(
      _build.ptr(rows), r, length, _build.ptr(meta), _build.ptr(tables),
      _build.ptr(w_cond), _build.ptr(pos), is_bf16, b * length, n, k,
      _build.ptr(x_f32), _build.ptr(x_base_bf16), _build.ptr(lengths), wps,
      _build.stream_ptr(rows.device)), 'embed_condense')


def attention(qkv: torch.Tensor, out: torch.Tensor, *, batch: int,
              length: int, num_heads: int, win: int,
              lengths: Optional[torch.Tensor] = None) -> None:
  """o = banded softmax(q k^T) v per head (csrc/ragged_attention.cu);
  qkv [B*L, 3H] f32 with q pre-scaled, out [B*L, H] f32. With lengths
  [B, wps] int32 each query attends only inside its own window, and
  positions past the slot's windows get o = 0."""
  _check(qkv, 'qkv', (torch.float32,))
  _check(out, 'out', (torch.float32,))
  wps = _check_lengths(lengths, batch)
  m, h3 = qkv.shape
  hidden = h3 // 3
  if (m != batch * length or h3 != 3 * hidden
      or tuple(out.shape) != (m, hidden) or hidden % num_heads):
    raise ValueError(f'attention shapes qkv {tuple(qkv.shape)} out '
                     f'{tuple(out.shape)} for B={batch} L={length}')
  lib = _build.load('ragged_attention')
  _build.check(lib.dc_attention(
      _build.ptr(qkv), _build.ptr(lengths), wps, _build.ptr(out), batch,
      length, hidden, num_heads, int(win), _build.stream_ptr(qkv.device)),
      'attention')


def attention_smem_bytes(length: int, hidden: int, num_heads: int,
                         win: int) -> int:
  """Dynamic shared memory one block of the attention core asks for."""
  return int(_build.load('ragged_attention').dc_attention_smem_bytes(
      length, hidden, num_heads, int(win)))
