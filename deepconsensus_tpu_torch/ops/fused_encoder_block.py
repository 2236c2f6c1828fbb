"""K2: fused encoder blocks (banded MHA + ReZero, ReLU FFN + ReZero).

Port of deepconsensus_tpu/ops/fused_encoder_block.py
(`fused_encoder_stack`, one Pallas call per encoder block after K1).
Same contract: x [B, L, H] enters each block in the compute dtype,
every intermediate is float32, and each block's output is cast back to
the compute dtype; ReZero alphas stay separate scalars (not folded into
the weights).

On a CUDA tensor a block is a fixed sequence of the repository's
kernels: the fused q/k/v GEMM, the banded attention core, the output
GEMM with the attention residual in its epilogue (K1's
`project_attend`; csrc/gemm.cu), then the whole FFN in one launch
(csrc/ffn.cu): filter product, bias, ReLU, output product, bias and the
FFN residual, with the [tokens, filter] ReLU intermediate kept in
shared memory a chunk at a time, as the TPU kernel keeps it in VMEM.
Every product runs on the tensor cores with its operands split exactly
into bf16 pieces (csrc/mma_gemm.cuh), so it is the reference's float32
product up to the order of the sums. On a CPU tensor the wrapper runs
`fused_encoder_stack_plain`, the reference's arithmetic.

Ragged slots (`lengths` [B, wps], ops/ragged_window_attention.py): every
block with attention masks with the lengths-derived window (band AND
same window AND valid); on the card the attention core reads the
lengths row itself. The FFN half is position-wise and unchanged.

int8 weights (params.quantize_matmuls=int8, models/quantize.py): each
of a block's six matmul weights may be a `QuantizedWeight`, int8 values
[K, N] with a float32 per-output-channel scale [N], and each product is
the reference's `_dequant_matmul`, (x @ values) * scale, in float32. On
the card the kernels read the int8 values as int8, widen them to bf16
(exact), and apply the scale in their epilogues, before the q scale,
bias, ReLU and residual; no dequantized weight is made. Such blocks
count in `n_launches_int8`, the others in `n_launches`. An int8 weight on a CUDA tensor launches the
int8 kernel or raises.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence

import torch

from deepconsensus_tpu_torch.ops import _kernels
from deepconsensus_tpu_torch.ops import fused_window_attention as fwa
from deepconsensus_tpu_torch.ops import ragged_window_attention as rwa

# Launches of the CUDA path (one per encoder block on CUDA tensors):
# blocks with float weights, and blocks with int8 weights.
n_launches = 0
n_launches_int8 = 0

# Defined beside project_attend, which K1, K2 and K4 share.
QuantizedWeight = fwa.QuantizedWeight


class EncoderBlockWeights(NamedTuple):
  """Weights for one encoder block. The attention half (wq..wo,
  attn_alpha) is None for the layer-0 remainder block, whose attention
  K1 already ran. wq/wk/wv/wo are [H, H]; w_filter [H, F]; w_output
  [F, H], each a float tensor or a QuantizedWeight; biases and alphas
  float32."""

  wq: Optional[Any]
  wk: Optional[Any]
  wv: Optional[Any]
  wo: Optional[Any]
  attn_alpha: Optional[torch.Tensor]
  w_filter: Any
  b_filter: torch.Tensor
  w_output: Any
  b_output: torch.Tensor
  ffn_alpha: torch.Tensor


def _weights(block: EncoderBlockWeights):
  return [w for w in (block.wq, block.wk, block.wv, block.wo,
                      block.w_filter, block.w_output) if w is not None]


def is_int8(block: EncoderBlockWeights) -> bool:
  """Whether any of the block's matmul weights is int8."""
  return any(fwa.as_quantized(w).values.dtype == torch.int8
             for w in _weights(block))


def _alpha(a, device) -> torch.Tensor:
  return torch.as_tensor(a, dtype=torch.float32, device=device).reshape(1)


def _plain_weight(w, dt: torch.dtype):
  """A float weight in the compute dtype, or the QuantizedWeight whose
  scale runs after the product (fwa.matmul_plain)."""
  qw = fwa.as_quantized(w)
  return qw.values.to(dt) if qw.scale is None else qw


def encoder_block_plain(x: torch.Tensor, block: EncoderBlockWeights, *,
                        num_heads: int, attn_win_size: Optional[int],
                        compute_dtype: torch.dtype,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Plain PyTorch K2 block (any device); mask [B, L, L] (ragged slots)
  replaces the static band."""
  dt = compute_dtype
  x = x.to(dt).float()
  if block.wq is not None:
    y = fwa.attention_plain(
        x, *(_plain_weight(w, dt) for w in (block.wq, block.wk, block.wv,
                                            block.wo)),
        num_heads=num_heads, attn_win_size=attn_win_size, mask=mask)
    x = x + _alpha(block.attn_alpha, x.device) * y
  h = (fwa.matmul_plain(x, _plain_weight(block.w_filter, dt))
       + block.b_filter.float())
  h = torch.relu(h)
  y = (fwa.matmul_plain(h, _plain_weight(block.w_output, dt))
       + block.b_output.float())
  return (x + _alpha(block.ffn_alpha, x.device) * y).to(dt)


def fused_encoder_stack_plain(x, blocks, *, num_heads, attn_win_size,
                              softmax_dtype=torch.float32,
                              compute_dtype=torch.float32,
                              lengths=None) -> torch.Tensor:
  """Plain PyTorch K2 over a stack of blocks (any device)."""
  fwa.check_softmax_dtype(softmax_dtype)
  dt = fwa.resolve_dtype(compute_dtype)
  mask = None
  if lengths is not None:
    mask = rwa.ragged_attention_mask(lengths.to(x.device), x.shape[1],
                                     attn_win_size)
  for block in blocks:
    x = encoder_block_plain(x, block, num_heads=num_heads,
                            attn_win_size=attn_win_size, compute_dtype=dt,
                            mask=mask)
  return x.to(dt)


def _block_cuda(x: torch.Tensor, block: EncoderBlockWeights, *,
                num_heads: int, attn_win_size: Optional[int],
                dt: torch.dtype,
                lengths: Optional[torch.Tensor]) -> torch.Tensor:
  b, length, hidden = x.shape
  dev = x.device
  x2 = x.view(b * length, hidden)
  ffn_in = x2
  if block.wq is not None:
    ffn_in = torch.empty((b * length, hidden), dtype=torch.float32,
                         device=dev)
    fwa.project_attend(
        x2, block.wq, block.wk, block.wv, block.wo, ffn_in, batch=b,
        length=length, num_heads=num_heads, attn_win_size=attn_win_size,
        compute_dtype=dt, res=x2, alpha=_alpha(block.attn_alpha, dev),
        lengths=lengths)
  w_filter, filter_scale = fwa.gemm_operand((block.w_filter,), dt)
  w_output, output_scale = fwa.gemm_operand((block.w_output,), dt)
  out = torch.empty((b, length, hidden), dtype=dt, device=dev)
  _kernels.ffn(ffn_in, w_filter, w_output, out.view(b * length, hidden),
               b_filter=block.b_filter.to(torch.float32).contiguous(),
               b_output=block.b_output.to(torch.float32).contiguous(),
               alpha=_alpha(block.ffn_alpha, dev), compute_dtype=dt,
               filter_scale=filter_scale, output_scale=output_scale)
  return out


def fused_encoder_stack(
    x: torch.Tensor,
    blocks: Sequence[EncoderBlockWeights],
    *,
    num_heads: int,
    attn_win_size: Optional[int],
    softmax_dtype: Any = torch.float32,
    compute_dtype: Any = torch.float32,
    lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
  """Runs encoder blocks over a [B, L, H] batch; returns [B, L, H] in
  the compute dtype. lengths: [B, wps] window widths of ragged slots,
  or None. A CPU tensor runs the plain version; a CUDA tensor launches
  the kernels, counting one launch per block (in n_launches_int8 for a
  block with int8 weights)."""
  global n_launches, n_launches_int8
  fwa.check_softmax_dtype(softmax_dtype)
  dt = fwa.resolve_dtype(compute_dtype)
  hidden = x.shape[-1]
  if hidden % num_heads:
    raise ValueError('hidden size must divide num_heads')
  if lengths is not None and (lengths.dim() != 2
                              or lengths.shape[0] != x.shape[0]):
    raise ValueError(f'lengths shape {tuple(lengths.shape)}, want '
                     f'({x.shape[0]}, windows per slot)')
  for block in blocks:  # before any launch
    for w in _weights(block):
      fwa.as_quantized(w)
  if x.device.type == 'cpu':
    return fused_encoder_stack_plain(
        x, blocks, num_heads=num_heads, attn_win_size=attn_win_size,
        compute_dtype=dt, lengths=lengths)
  if x.device.type != 'cuda':
    raise ValueError(f'unsupported device {x.device}')
  x = x.to(dt).contiguous()
  if lengths is not None:
    lengths = lengths.to(device=x.device, dtype=torch.int32).contiguous()
  for block in blocks:
    x = _block_cuda(x, block, num_heads=num_heads,
                    attn_win_size=attn_win_size, dt=dt, lengths=lengths)
    if is_int8(block):
      n_launches_int8 += 1
    else:
      n_launches += 1
  return x
