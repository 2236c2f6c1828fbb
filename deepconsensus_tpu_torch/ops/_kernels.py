"""Launch helpers for the CUDA kernels shared by K1 and K2.

Thin ctypes calls: each checks its tensors, launches on the current
stream, and raises if the launch returned a CUDA error. Outputs are
allocated by the caller (the K1/K2 wrappers, with torch.empty). The
launch counts that prove the main path went through the kernels live
on the K1/K2/K3 wrappers, not here.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

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


def split_pieces(a_dtype: torch.dtype, b_dtype: torch.dtype,
                 compute_dtype: torch.dtype) -> Tuple[int, int]:
  """(A pieces, B pieces): how many bf16 pieces the tensor-core GEMMs
  (csrc/mma_gemm.cuh) split each operand into, so that their bf16 MMAs
  reproduce the reference's float32 product of the widened operands.
  bf16 and int8 values are exact in one piece. A float32 A takes 2
  pieces in a bfloat16 run (16 bits, far below the output's rounding)
  and 3 in a float32 run (all 24 bits: exact). A float32 B takes 3
  pieces, and so does A beside it: the float32 x float32 product keeps
  the 6 of the 9 piece products above 2^-24."""
  for dt, name in ((a_dtype, 'a'), (b_dtype, 'b')):
    if dt not in _DTYPES + (torch.int8,) or (name == 'a' and dt == torch.int8):
      raise ValueError(f'{name} dtype {dt} has no bf16 split')
  b_pieces = 3 if b_dtype == torch.float32 else 1
  if a_dtype == torch.bfloat16:
    return 1, b_pieces
  if compute_dtype == torch.bfloat16 and b_pieces == 1:
    return 2, b_pieces
  return 3, b_pieces


def _b_type(b: torch.Tensor, name: str) -> int:
  """Validates a weight operand: 0 float32, 1 bfloat16, 2 int8."""
  _check(b, name, _DTYPES + (torch.int8,))
  return _DTYPES.index(b.dtype) if b.dtype in _DTYPES else 2


def _check_vector(v: Optional[torch.Tensor], name: str, n: int) -> None:
  if v is not None:
    _check(v, name, (torch.float32,))
    if v.numel() != n:
      raise ValueError(f'{name} has {v.numel()} values, want {n}')


def gemm(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor, *,
         compute_dtype: torch.dtype = torch.float32,
         scale: float = 1.0, scale_cols: int = 0,
         col_scale: Optional[torch.Tensor] = None,
         bias: Optional[torch.Tensor] = None,
         relu: bool = False,
         res: Optional[torch.Tensor] = None,
         alpha: Optional[torch.Tensor] = None) -> None:
  """out[M, N] = epilogue(a[M, K] @ b[K, N]) (csrc/gemm.cu): times
  col_scale[n] (int8 weights: the dequantization), columns below
  scale_cols times scale, + bias, ReLU, then res + alpha * y. b is
  float32, bfloat16 or int8; an int8 b needs its float32 col_scale.
  The product runs on the tensor cores with the operands split as
  split_pieces(a, b, compute_dtype) says; K and N are multiples of 8."""
  m, k = a.shape
  k2, n = b.shape
  if k != k2 or tuple(out.shape) != (m, n):
    raise ValueError(f'gemm shapes {tuple(a.shape)} x {tuple(b.shape)} '
                     f'-> {tuple(out.shape)}')
  a_bf16 = _check(a, 'a')
  b_type = _b_type(b, 'b')
  if b_type == 2 and col_scale is None:
    raise ValueError('an int8 b needs its per-output-channel col_scale')
  out_bf16 = _check(out, 'out')
  res_bf16 = 0
  _check_vector(col_scale, 'col_scale', n)
  _check_vector(bias, 'bias', n)
  if res is not None:
    res_bf16 = _check(res, 'res')
    if tuple(res.shape) != (m, n):
      raise ValueError(f'res shape {tuple(res.shape)}, want {(m, n)}')
    if alpha is None or alpha.numel() != 1:
      raise ValueError('a residual needs a one-element alpha tensor')
    _check(alpha, 'alpha', (torch.float32,))
  if k % 8 or n % 8:
    raise ValueError(f'gemm K = {k} and N = {n} must be multiples of 8')
  a_pieces, b_pieces = split_pieces(a.dtype, b.dtype, compute_dtype)
  lib = _build.load('gemm')
  _build.check(lib.dc_gemm(
      _build.ptr(a), a_bf16, a_pieces, _build.ptr(b), b_type, b_pieces, m,
      n, k, float(scale), int(scale_cols), _build.ptr(col_scale),
      _build.ptr(bias), int(relu), _build.ptr(res), res_bf16,
      _build.ptr(alpha), _build.ptr(out), out_bf16,
      _build.stream_ptr(a.device)), 'gemm')


# The fused FFN's limits (csrc/mma_gemm.cuh::FfnTile): the [64, H]
# output accumulator of a block stays in registers.
FFN_MAX_HIDDEN = 288


def ffn(x: torch.Tensor, w_filter: torch.Tensor, w_output: torch.Tensor,
        out: torch.Tensor, *, b_filter: torch.Tensor, b_output: torch.Tensor,
        alpha: torch.Tensor, compute_dtype: torch.dtype,
        filter_scale: Optional[torch.Tensor] = None,
        output_scale: Optional[torch.Tensor] = None) -> None:
  """out = x + alpha * ((relu((x @ w_filter) * filter_scale + b_filter)
  @ w_output) * output_scale + b_output) in one launch (csrc/ffn.cu),
  with the [M, F] intermediate kept on chip. x [M, H] float32 or
  bfloat16 (also the residual); weights float32, bfloat16 or int8 (int8
  with their float32 scales); H <= FFN_MAX_HIDDEN and a multiple of 8,
  F a multiple of 32. Operands split as split_pieces says; the
  intermediate as a float32 A of the compute dtype."""
  m, hidden = x.shape
  hidden2, filt = w_filter.shape
  if (hidden2 != hidden or tuple(w_output.shape) != (filt, hidden)
      or tuple(out.shape) != (m, hidden)):
    raise ValueError(f'ffn shapes x {tuple(x.shape)}, w_filter '
                     f'{tuple(w_filter.shape)}, w_output '
                     f'{tuple(w_output.shape)} -> {tuple(out.shape)}')
  x_bf16 = _check(x, 'x')
  b_type = _b_type(w_filter, 'w_filter')
  if _b_type(w_output, 'w_output') != b_type:
    raise ValueError('w_filter and w_output must share their dtype')
  if (b_type == 2) != (filter_scale is not None) or (
      (b_type == 2) != (output_scale is not None)):
    raise ValueError('int8 weights need their scales, float ones none')
  _check_vector(filter_scale, 'filter_scale', filt)
  _check_vector(output_scale, 'output_scale', hidden)
  _check_vector(b_filter, 'b_filter', filt)
  _check_vector(b_output, 'b_output', hidden)
  _check(alpha, 'alpha', (torch.float32,))
  if alpha.numel() != 1:
    raise ValueError('alpha must hold one value')
  out_bf16 = _check(out, 'out')
  if hidden > FFN_MAX_HIDDEN or hidden % 8 or filt % 32:
    raise ValueError(f'ffn takes H <= {FFN_MAX_HIDDEN}, a multiple of 8, '
                     f'and F a multiple of 32; got H = {hidden}, F = {filt}')
  a_pieces, b_pieces = split_pieces(x.dtype, w_filter.dtype, compute_dtype)
  h_pieces = split_pieces(torch.float32, w_filter.dtype, compute_dtype)[0]
  lib = _build.load('ffn')
  _build.check(lib.dc_ffn(
      _build.ptr(x), x_bf16, a_pieces, _build.ptr(w_filter),
      _build.ptr(w_output), b_type, b_pieces, h_pieces, m, hidden, filt,
      _build.ptr(filter_scale), _build.ptr(b_filter),
      _build.ptr(output_scale), _build.ptr(b_output), _build.ptr(alpha),
      _build.ptr(out), out_bf16, _build.stream_ptr(x.device)), 'ffn')


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


# The condenser's limits (csrc/embed_condense.cu): one block owns all
# N <= 288 columns; at most 8 tables, staged in shared memory; at most
# 128 pileup rows (32 a thread).
CONDENSE_MAX_HIDDEN = 288
CONDENSE_MAX_TABLES = 8
CONDENSE_MAX_ROWS = 128
SMEM_LIMIT = 232448


def embed_condense_smem_bytes(compute_dtype: torch.dtype, entries: int,
                              n_rows: int, k: int) -> int:
  """Dynamic shared memory one condenser block asks for."""
  return int(_build.load('embed_condense').dc_embed_condense_smem_bytes(
      int(compute_dtype == torch.bfloat16), entries, n_rows, k))


def embed_condense(rows: torch.Tensor, meta: torch.Tensor,
                   tables: Sequence[torch.Tensor],
                   table_scales: Sequence[float],
                   table_bases: Sequence[int], entries: int,
                   w_cond: torch.Tensor, pos: Optional[torch.Tensor],
                   x_f32: torch.Tensor, x_base_bf16: Optional[torch.Tensor],
                   lengths: Optional[torch.Tensor] = None) -> None:
  """x[b, l] = embed(rows[b, :, l]) @ w_cond + pos[l] on the tensor
  cores (csrc/embed_condense.cu). rows [B, R, L] float32 raw pileup
  values; meta the int32 row and column map
  (fused_window_attention.condense_layout); tables float32 or bfloat16,
  unscaled, staged at table_bases in planes of `entries` values and
  scaled there by table_scales (sqrt(width) in the compute dtype);
  w_cond [K, N] in the compute dtype, which also sets the pieces
  (split_pieces); pos [L, N] in the compute dtype or None. With lengths
  (ragged slots) the position add is pos[l - start(l)] on positions
  inside a window and nothing elsewhere."""
  b, r, length = rows.shape
  wps = _check_lengths(lengths, b)
  k, n = w_cond.shape
  _check(rows, 'rows', (torch.float32,))
  _check(meta, 'meta', (torch.int32,))
  is_bf16 = _check(w_cond, 'w_cond')
  dt = w_cond.dtype
  if pos is not None and (_check(pos, 'pos') != is_bf16
                          or tuple(pos.shape) != (length, n)):
    raise ValueError('pos must be [L, H] in the compute dtype')
  if meta.numel() != 4 * r + k + k // 8:
    raise ValueError(f'meta has {meta.numel()} values, want '
                     f'{4 * r + k + k // 8} for R = {r}, K = {k}')
  n_tables = len(tables)
  if not 1 <= n_tables <= CONDENSE_MAX_TABLES or not (
      len(table_scales) == len(table_bases) == n_tables):
    raise ValueError(f'{n_tables} tables (at most {CONDENSE_MAX_TABLES}), '
                     f'{len(table_scales)} scales, {len(table_bases)} bases')
  flags = [_check(t, f'table {i}') for i, t in enumerate(tables)]
  if r > CONDENSE_MAX_ROWS:
    raise ValueError(f'the condenser takes at most {CONDENSE_MAX_ROWS} '
                     f'pileup rows, got {r}')
  if k % 8 or n % 8 or n > CONDENSE_MAX_HIDDEN:
    raise ValueError(f'condenser K = {k} and N = {n} must be multiples of 8, '
                     f'N <= {CONDENSE_MAX_HIDDEN}')
  if entries % 8 or entries > 32768 or any(
      base + t.numel() > entries for base, t in zip(table_bases, tables)):
    raise ValueError(f'tables do not fit {entries} staged entries')
  smem = embed_condense_smem_bytes(dt, entries, r, k)
  if smem > SMEM_LIMIT:
    raise ValueError(
        f'the condenser needs {smem} bytes of shared memory for {entries} '
        f'table entries, R = {r}, K = {k} in {dt}; a block has {SMEM_LIMIT}')
  _check(x_f32, 'x_f32', (torch.float32,))
  if tuple(x_f32.shape) != (b, length, n):
    raise ValueError(f'x shape {tuple(x_f32.shape)}, want {(b, length, n)}')
  if x_base_bf16 is not None:
    _check(x_base_bf16, 'x_base', (torch.bfloat16,))
    if tuple(x_base_bf16.shape) != (b, length, n):
      raise ValueError(f'x_base shape {tuple(x_base_bf16.shape)}')
  ptrs = (ctypes.c_void_p * n_tables)(*[t.data_ptr() for t in tables])
  lib = _build.load('embed_condense')
  _build.check(lib.dc_embed_condense(
      _build.ptr(rows), r, length, _build.ptr(meta), n_tables, ptrs,
      (ctypes.c_int * n_tables)(*flags),
      (ctypes.c_float * n_tables)(*table_scales),
      (ctypes.c_int * n_tables)(*table_bases),
      (ctypes.c_int * n_tables)(*[t.numel() for t in tables]), entries,
      _build.ptr(w_cond), is_bf16, _build.ptr(pos), b * length, n, k,
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
