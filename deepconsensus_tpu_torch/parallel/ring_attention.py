"""Blockwise ring attention: exact banded attention over long windows.

Port of deepconsensus_tpu/parallel/ring_attention.py
(`ring_attention_blockwise`, `_block_attention`). The reference also
holds the shard_map `ring_attention` over a device mesh and its
`ring_attention_sharded` wrapper; those belong to multi-GPU training
and are not ported. Here keys and values stream through a flash-style
online softmax in blocks, so the [B, H, L, L] logits tensor is never
materialized. It is plain torch (XLA in the reference), differentiated
by autograd.
"""
from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30

# Calls of ring_attention_blockwise (the reference counts its traces);
# tests and chip_smoke.py read it to show the route was taken.
n_calls = 0


def _block_attention(q: torch.Tensor, k: torch.Tensor, q_offset: int,
                     k_offset: int,
                     attn_win_size: Optional[int]) -> torch.Tensor:
  """Scores of one (q_block, k_block) pair with optional band mask.

  q: [B, Lq, H, D]; k: [B, Lk, H, D]. Returns scores [B, H, Lq, Lk]
  scaled by D**-0.5, out-of-band logits at _NEG_INF.
  """
  depth = q.shape[-1]
  s = torch.einsum('bqhd,bkhd->bhqk', q, k) * (depth ** -0.5)
  if attn_win_size is not None:
    qi = q_offset + torch.arange(q.shape[1], device=q.device)
    ki = k_offset + torch.arange(k.shape[1], device=q.device)
    band = (qi[:, None] - ki[None, :]).abs() <= attn_win_size
    s = torch.where(band, s, torch.full((), _NEG_INF, dtype=s.dtype,
                                        device=s.device))
  return s


def ring_attention_blockwise(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    attn_win_size: Optional[int] = None,
    block_size: int = 128,
) -> torch.Tensor:
  """Single-device ring attention: K/V stream through the online
  softmax in blocks of `block_size` keys.

  Queries stay resident; each key block updates the running max, sum
  and output, kept in q's dtype as the reference keeps them. The
  forward holds one [B, H, L, block] score tile at a time; under
  autograd each block's weights are kept for the backward, as the
  reference's differentiated scan keeps them. The running max is held
  out of autograd (unlike the reference): the output does not depend on
  it in exact arithmetic, so its gradient is rounding alone, and
  without it autograd keeps no block's scores beside its weights.
  Fully-banded-out (query, key-block) rows heal themselves: their
  running max stays _NEG_INF, and the first real block rescales the
  junk accumulator by exp(_NEG_INF - m_real) == 0.

  q, k, v: [B, L, H, D] -> [B, L, H, D]. Scores are scaled by D**-0.5
  here: pass the unscaled query.
  """
  global n_calls
  n_calls += 1
  b, length, h, d = q.shape
  block = int(min(block_size, length))
  n_blocks = -(-length // block)
  pad = n_blocks * block - length
  k_p = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
  v_p = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
  neg_inf = torch.full((), _NEG_INF, dtype=q.dtype, device=q.device)

  m = torch.full((b, h, length), _NEG_INF, dtype=q.dtype, device=q.device)
  l_sum = torch.zeros((b, h, length), dtype=q.dtype, device=q.device)
  o = torch.zeros((b, length, h, d), dtype=q.dtype, device=q.device)
  for i in range(n_blocks):
    k_off = i * block
    k_cur = k_p[:, k_off:k_off + block]
    v_cur = v_p[:, k_off:k_off + block]
    s = _block_attention(q, k_cur, 0, k_off, attn_win_size)
    # Padded key slots (global index >= L) are masked out regardless of
    # the band so the pad never enters any softmax.
    valid = (k_off + torch.arange(block, device=q.device)) < length
    s = torch.where(valid[None, None, None, :], s, neg_inf)
    m_block = torch.amax(s.detach(), dim=-1)  # a constant shift
    m_new = torch.maximum(m, m_block)
    scale = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_sum = l_sum * scale + torch.sum(p, dim=-1)
    o = (o * scale.permute(0, 2, 1)[..., None]
         + torch.einsum('bhqk,bkhd->bqhd', p, v_cur))
    m = m_new
  denom = l_sum.permute(0, 2, 1)[..., None]
  return o / torch.clamp(denom, min=1e-30)
