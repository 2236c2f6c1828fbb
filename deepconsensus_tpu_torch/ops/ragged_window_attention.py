"""K4: fused embed -> condense -> pos -> layer-0 MHA over ragged slots.

Port of deepconsensus_tpu/ops/ragged_window_attention.py
(`ragged_embed_condense_attention`). Windows of every bucket width pack
back to back into fixed slots of S positions (S = the largest bucket);
a per-slot int32 `lengths` row [wps] (window widths in placement order,
0 = unused) drives what the window width drove on the fixed-width path:

  * attention is band AND same-window AND both positions valid
    (`ragged_attention_mask`);
  * the position add is pos[p - start(p)] on valid positions and zero
    elsewhere (`slot_geometry`);
  * embed and condense are position-wise and need nothing.

On a CUDA tensor the wrapper launches K1's four kernels in their ragged
mode (`fused_window_attention.embed_condense_attend` with lengths): the
embedding-gather condenser GEMM whose epilogue derives each position's
window from the lengths row (csrc/embed_condense.cu), the q/k/v GEMM,
the attention core, which derives each query's window from the lengths
row and stages only the K/V rows its query tile reaches (in key blocks
of 96 rows where a band reaches further), so any slot up to 256 fits in
shared memory (csrc/ragged_attention.cu), and the output GEMM. The
attn_softmax_dtype lever (softmax_dtype, fwa.softmax_chain) reaches the
core's softmax; such calls count in n_launches_bf16_softmax. A position past every window gets attention output 0 from the
kernel, where the reference's softmax is uniform; those positions are
never delivered. On a CPU tensor it runs
`ragged_embed_condense_attention_plain`, the reference's semantics at
every position.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from deepconsensus_tpu_torch.ops import fused_window_attention as fwa

# Longest slot the ragged path takes (reference RAGGED_MAX_SLOT_LEN).
RAGGED_MAX_SLOT_LEN = 256

# Launches of the CUDA path (one per call on CUDA tensors), with a float32
# softmax and with the attn_softmax_dtype=bfloat16 variant.
n_launches = 0
n_launches_bf16_softmax = 0


def validate_ragged_buckets(buckets: Sequence[int]) -> Tuple[int, ...]:
  """Ragged packing needs a divisibility chain: each bucket divides
  every larger one, so largest-first packing starts every window at a
  multiple of its own width."""
  out = tuple(int(b) for b in buckets)
  if not out or any(b <= 0 for b in out):
    raise ValueError(f'ragged buckets must be positive ints, got {out}')
  if list(out) != sorted(set(out)):
    raise ValueError(f'ragged buckets must be strictly ascending, got {out}')
  for small, big in zip(out, out[1:]):
    if big % small:
      raise ValueError(
          f'ragged buckets must form a divisibility chain (each bucket '
          f'divides every larger one); {small} does not divide {big} '
          f'in {out}')
  return out


def windows_per_slot(buckets: Sequence[int]) -> int:
  """Max windows one slot can hold: slot_len // smallest bucket."""
  b = validate_ragged_buckets(buckets)
  return b[-1] // b[0]


def slot_geometry(lengths: torch.Tensor, slot_len: int
                  ) -> Tuple[torch.Tensor, ...]:
  """(seg, start, width, valid), each [B, slot_len], from lengths
  [B, wps]: the window ordinal owning each position, its start offset
  and width, and whether the position holds window data. Invalid
  positions keep seg/start/width 0."""
  lengths = lengths.to(torch.int32)
  b, wps = lengths.shape
  p = torch.arange(slot_len, dtype=torch.int32,
                   device=lengths.device).expand(b, slot_len)
  seg = torch.zeros((b, slot_len), dtype=torch.int32, device=lengths.device)
  width = torch.zeros_like(seg)
  start = torch.zeros_like(seg)
  cur = torch.zeros((b, 1), dtype=torch.int32, device=lengths.device)
  for j in range(wps):
    w_j = lengths[:, j:j + 1]
    nxt = cur + w_j
    sel = (p >= cur) & (p < nxt)
    seg = torch.where(sel, torch.full_like(seg, j), seg)
    width = torch.where(sel, w_j.expand(b, slot_len), width)
    start = torch.where(sel, cur.expand(b, slot_len), start)
    cur = nxt
  return seg, start, width, p < cur


def ragged_attention_mask(lengths: torch.Tensor, slot_len: int,
                          attn_win_size: Optional[int]) -> torch.Tensor:
  """[B, S, S] bool: the band AND same window AND both positions
  valid."""
  seg, _, _, valid = slot_geometry(lengths, slot_len)
  mask = (seg[:, :, None] == seg[:, None, :])
  mask = mask & valid[:, :, None] & valid[:, None, :]
  if attn_win_size is not None:
    i = torch.arange(slot_len, device=lengths.device)
    mask = mask & ((i[:, None] - i[None, :]).abs() <= attn_win_size)
  return mask


def pos_contribution(start: torch.Tensor, valid: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
  """[B, S, H] float32: pos[p - start(p)] on valid positions, zero
  elsewhere (the reference's one-hot product has one term per row, so a
  gather gives the same values)."""
  slot_len = start.shape[1]
  p = torch.arange(slot_len, device=start.device)
  off = torch.clamp(p - start.long(), 0, pos.shape[0] - 1)
  return pos.float()[off] * valid[..., None]


def _check_args(rows, lengths, w_cond, specs, num_heads) -> None:
  slot_len = rows.shape[2]
  if slot_len > RAGGED_MAX_SLOT_LEN:
    raise ValueError(
        f'ragged slot length {slot_len} exceeds RAGGED_MAX_SLOT_LEN '
        f'{RAGGED_MAX_SLOT_LEN}')
  cond_in, hidden = w_cond.shape
  if sum(s.n_rows * s.width for s in specs) != cond_in:
    raise ValueError(
        f'condenser expects {cond_in} input features, family specs '
        f'cover {sum(s.n_rows * s.width for s in specs)}')
  if hidden % num_heads:
    raise ValueError('hidden size must divide num_heads')
  if lengths.dim() != 2 or lengths.shape[0] != rows.shape[0]:
    raise ValueError(f'lengths shape {tuple(lengths.shape)}, want '
                     f'({rows.shape[0]}, windows per slot)')


def ragged_embed_condense_attention_plain(
    rows, lengths, tables, w_cond, wq, wk, wv, wo, pos, *, specs,
    table_keys, num_heads, attn_win_size, softmax_dtype=torch.float32,
    compute_dtype=torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
  """Plain PyTorch K4 (any device), the reference's
  `reference_ragged_forward` from compute-dtype inputs in float32."""
  sdt = fwa.resolve_softmax_dtype(softmax_dtype)
  dt = fwa.resolve_dtype(compute_dtype)
  _check_args(rows, lengths, w_cond, specs, num_heads)
  slot_len = rows.shape[2]
  lengths = lengths.to(rows.device)
  x = fwa.embed_condense_plain(rows, tables, w_cond, specs=specs,
                               table_keys=table_keys, compute_dtype=dt)
  if pos is not None:
    _, start, _, valid = slot_geometry(lengths, slot_len)
    x = x + pos_contribution(start, valid, pos.to(dt))
  out = fwa.attention_plain(
      x, wq.to(dt), wk.to(dt), wv.to(dt), wo.to(dt), num_heads=num_heads,
      attn_win_size=attn_win_size,
      mask=ragged_attention_mask(lengths, slot_len, attn_win_size),
      softmax_dtype=sdt)
  return x.to(dt), out.to(dt)


def ragged_embed_condense_attention(
    rows: torch.Tensor,
    lengths: torch.Tensor,
    tables: Dict[str, torch.Tensor],
    w_cond: torch.Tensor,
    wq: torch.Tensor,
    wk: torch.Tensor,
    wv: torch.Tensor,
    wo: torch.Tensor,
    pos: Optional[torch.Tensor],
    *,
    specs: Tuple[fwa.FamilySpec, ...],
    table_keys: Tuple[str, ...],
    num_heads: int,
    attn_win_size: Optional[int],
    softmax_dtype: Any = torch.float32,
    compute_dtype: Any = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
  """K4 over ragged slots. rows: [B, R, S] raw pileup rows, windows
  packed back to back per slot; lengths: [B, wps] int window widths;
  pos: [S, H] position table (indexed by offset in the window) or
  None; the rest as fused_embed_condense_attention. Returns (x_base,
  attn_out) [B, S, H] in the compute dtype. A CPU tensor runs the plain
  version; a CUDA tensor launches the kernels."""
  global n_launches, n_launches_bf16_softmax
  sdt = fwa.resolve_softmax_dtype(softmax_dtype)
  dt = fwa.resolve_dtype(compute_dtype)
  _check_args(rows, lengths, w_cond, specs, num_heads)
  if rows.device.type == 'cpu':
    return ragged_embed_condense_attention_plain(
        rows, lengths, tables, w_cond, wq, wk, wv, wo, pos, specs=specs,
        table_keys=table_keys, num_heads=num_heads,
        attn_win_size=attn_win_size, softmax_dtype=sdt, compute_dtype=dt)
  if rows.device.type != 'cuda':
    raise ValueError(f'unsupported device {rows.device}')
  out = fwa.embed_condense_attend(
      rows, tables, w_cond, wq, wk, wv, wo, pos, specs=specs,
      table_keys=table_keys, num_heads=num_heads,
      attn_win_size=attn_win_size, compute_dtype=dt, softmax_dtype=sdt,
      lengths=lengths.to(device=rows.device, dtype=torch.int32).contiguous())
  if sdt == torch.float32:
    n_launches += 1
  else:
    n_launches_bf16_softmax += 1
  return out
