"""K1: fused embed -> condense -> position add -> layer-0 banded MHA.

Port of deepconsensus_tpu/ops/fused_window_attention.py
(`fused_embed_condense_attention`, the Pallas kernel of the L=100 hot
path). Same contract: rows [B, R, L] raw pileup values in, (x_base,
attn_out) [B, L, H] in the compute dtype out; the caller applies the
ReZero residual x_base + alpha * attn_out.

On a CUDA tensor the wrapper launches the repository's kernels, four
in order: the embedding-gather condenser on the tensor cores
(csrc/embed_condense.cu: it stages the tables, scaled by sqrt(width) at
the compute dtype as the TPU kernel folds them, in shared memory, adds
pos and writes x in float32 and the compute dtype), the fused q/k/v
projection with the q scale in its epilogue (csrc/gemm.cu), the banded
attention core (csrc/ragged_attention.cu) and the output projection
(csrc/gemm.cu). K4 (ops/ragged_window_attention.py) runs the same four
with a lengths vector (`embed_condense_attend`). Every intermediate is
float32, as inside the TPU kernel. The attn_softmax_dtype lever
(`softmax_dtype`: float32, or bfloat16 as `softmax_chain` computes it)
reaches the core's softmax; such calls count in n_launches_bf16_softmax.
On a CPU
tensor it runs `fused_embed_condense_attention_plain`, which mirrors
the reference's arithmetic with a gather in place of the one-hot
product (the same values).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from deepconsensus_tpu_torch import constants
from deepconsensus_tpu_torch.models import config as config_lib
from deepconsensus_tpu_torch.ops import _kernels
from deepconsensus_tpu_torch.preprocess.pileup import row_indices

_NEG = -1e9

MAX_WINDOW_LEN = config_lib.FUSED_MAX_WINDOW_LEN

# Launches of the CUDA path (one per call on CUDA tensors), with a float32
# softmax and with the attn_softmax_dtype=bfloat16 variant.
n_launches = 0
n_launches_bf16_softmax = 0


class FamilySpec(NamedTuple):
  """Static description of one feature family's slice of the pileup.

  cond_offset is the family's first row in the condenser weight (the
  concat order of the model's row embedding); shift is added to raw ids
  before clipping/embedding (ccs_bq stores gap as -1).
  """

  name: str
  row_start: int
  n_rows: int
  vocab: int
  width: int
  table_idx: int
  cond_offset: int
  shift: int


def build_family_specs(params) -> Tuple[Tuple[FamilySpec, ...],
                                        Tuple[str, ...], int]:
  """Family specs + table keys + condenser input width for a config
  (same row ranges, concat order and table sharing as the model: ccs
  rows embed through the bases table)."""
  (base_r, pw_r, ip_r, strand_r, ccs_r, ccs_bq_r, sn_r) = row_indices(
      params.max_passes, params.use_ccs_bq
  )
  specs = []
  table_keys: list = []
  offset = 0

  def add(name, rng, vocab, width, table_key, shift=0):
    nonlocal offset
    if table_key not in table_keys:
      table_keys.append(table_key)
    specs.append(FamilySpec(
        name=name, row_start=rng[0], n_rows=rng[1] - rng[0], vocab=vocab,
        width=width, table_idx=table_keys.index(table_key),
        cond_offset=offset, shift=shift,
    ))
    offset += (rng[1] - rng[0]) * width

  if params.use_bases:
    add('bases', base_r, constants.SEQ_VOCAB_SIZE,
        params.per_base_hidden_size, 'bases')
  if params.use_pw:
    add('pw', pw_r, params.PW_MAX + 1, params.pw_hidden_size, 'pw')
  if params.use_ip:
    add('ip', ip_r, params.IP_MAX + 1, params.ip_hidden_size, 'ip')
  if params.use_strand:
    add('strand', strand_r, params.STRAND_MAX + 1,
        params.strand_hidden_size, 'strand')
  if params.use_ccs:
    add('ccs', ccs_r, constants.SEQ_VOCAB_SIZE,
        params.per_base_hidden_size, 'bases')
  if params.use_ccs_bq:
    add('ccs_bq', ccs_bq_r, params.CCS_BQ_MAX,
        params.ccs_bq_hidden_size, 'ccs_bq', shift=1)
  if params.use_sn:
    add('sn', sn_r, params.SN_MAX + 1, params.sn_hidden_size, 'sn')
  return tuple(specs), tuple(table_keys), offset


def resolve_dtype(dtype: Any) -> torch.dtype:
  """'float32' / 'bfloat16' / torch dtype -> torch dtype (the kernels
  take those two)."""
  if isinstance(dtype, torch.dtype):
    resolved = dtype
  else:
    resolved = {'float32': torch.float32,
                'bfloat16': torch.bfloat16}.get(str(dtype))
  if resolved not in (torch.float32, torch.bfloat16):
    raise NotImplementedError(
        f'compute dtype {dtype!r}: the port runs float32 or bfloat16')
  return resolved


def resolve_softmax_dtype(softmax_dtype: Any) -> torch.dtype:
  """The attn_softmax_dtype lever: None, 'float32', 'bfloat16' or a
  torch dtype -> torch.float32 or torch.bfloat16; anything else raises."""
  if softmax_dtype is None:
    return torch.float32
  resolved = softmax_dtype if isinstance(softmax_dtype, torch.dtype) else {
      'float32': torch.float32, 'bfloat16': torch.bfloat16}.get(
          str(softmax_dtype))
  if resolved not in (torch.float32, torch.bfloat16):
    raise NotImplementedError(
        f'attn_softmax_dtype {softmax_dtype!r}: the port takes float32 or '
        'bfloat16')
  return resolved


def softmax_chain(logits: torch.Tensor, softmax_dtype: Any) -> torch.Tensor:
  """Softmax over the last axis of float32 logits in the
  attn_softmax_dtype, rounded where the reference's compiled kernels
  round; float32 weights out. float32 is torch.softmax. bfloat16 is the
  chain XLA compiles `exp(sd - max) / sum` of bf16 logits sd into:
    m = max(sd)               exact
    d = bf16(sd - m)
    e = exp(d)                float32, not rounded
    z = bf16(sum(e))          a float32 sum of the unrounded e
    w = bf16(e) / z           a true float32 division
  The kernels (K1, K2, K4) cast w to float32 at once, so the quotient is
  never rounded; jax.nn.softmax's bfloat16 output is bf16(w). e and w
  below float32's smallest normal are 0, as XLA (and the TPU) flush
  them. Masked logits (-1e9) stay finite in bfloat16 and get weight 0
  beside any unmasked one."""
  logits = logits.float()
  if resolve_softmax_dtype(softmax_dtype) == torch.float32:
    return torch.softmax(logits, dim=-1)
  bf16 = torch.bfloat16
  zero = torch.zeros((), device=logits.device)
  tiny = torch.finfo(torch.float32).tiny
  sd = logits.to(bf16)
  m = sd.amax(dim=-1, keepdim=True)
  e = torch.exp((sd.float() - m.float()).to(bf16).float())
  e = torch.where(e < tiny, zero, e)
  z = e.sum(dim=-1, keepdim=True).to(bf16).float()
  w = e.to(bf16).float() / z
  return torch.where(w < tiny, zero, w)


def rows_to_ids(rows: torch.Tensor) -> torch.Tensor:
  """Raw pileup rows -> int32 as XLA converts floats (jnp astype, and a
  CUDA cast): truncation toward zero, NaN to 0, values past int32's
  range (and +-inf) to its ends. A plain .to(torch.int32) leaves those
  undefined: on the CPU a NaN row becomes -2**31, not id 0."""
  if not rows.is_floating_point():
    return rows.to(torch.int32)
  r = torch.nan_to_num(rows.float(), nan=0.0)
  # 2147483520 is the largest float32 below 2**31.
  ids = r.clamp(-2.0 ** 31, 2147483520.0).to(torch.int32)
  return torch.where(r >= 2.0 ** 31,
                     torch.full_like(ids, torch.iinfo(torch.int32).max), ids)


def prepare_ids(rows: torch.Tensor, specs: Sequence[FamilySpec]
                ) -> torch.Tensor:
  """[B, R, L] raw rows -> int32 ids (rows_to_ids), then shifted and
  clipped per family to [0, vocab-1]."""
  ids = rows_to_ids(rows)
  for spec in specs:
    sl = slice(spec.row_start, spec.row_start + spec.n_rows)
    ids[:, sl] = torch.clamp(ids[:, sl] + spec.shift, 0, spec.vocab - 1)
  return ids


def scaled_tables(tables: Dict[str, torch.Tensor],
                  specs: Sequence[FamilySpec], table_keys: Sequence[str],
                  dtype: torch.dtype) -> list:
  """Each table in the compute dtype times sqrt(width) in that dtype
  (the embedding's output scale folded into its table)."""
  out = []
  for i, key in enumerate(table_keys):
    width = next(s.width for s in specs if s.table_idx == i)
    t = tables[key].to(dtype)
    out.append(t * torch.tensor(width ** 0.5, dtype=dtype, device=t.device))
  return out


class QuantizedWeight(NamedTuple):
  """One matmul weight, optionally int8-quantized (the reference's
  ops/fused_encoder_block.py QuantizedWeight). values: [K, N], floats
  when scale is None, int8 otherwise; scale: float32 [N], so that the
  effective weight is values * scale[None, :]. K2 takes these;
  project_attend, shared by K1, K2 and K4, reads them."""

  values: torch.Tensor
  scale: Optional[torch.Tensor] = None


def as_quantized(w) -> QuantizedWeight:
  """A QuantizedWeight (a plain tensor is wrapped with scale None),
  checked: 2-D values, float without a scale or int8 with one, and the
  scale one value per output column."""
  qw = w if isinstance(w, QuantizedWeight) else QuantizedWeight(w, None)
  values, scale = qw
  if values.dim() != 2:
    raise ValueError(f'weight must be 2-D, got {tuple(values.shape)}')
  if values.dtype == torch.int8:
    if scale is None:
      raise ValueError('an int8 weight needs its per-output-channel scale')
    if tuple(scale.shape) != (values.shape[1],):
      raise ValueError(f'scale shape {tuple(scale.shape)}, want '
                       f'({values.shape[1]},)')
  elif not values.is_floating_point() or scale is not None:
    raise ValueError(f'weight values must be float (no scale) or int8 '
                     f'(with a scale), got {values.dtype}')
  return qw


def matmul_plain(x: torch.Tensor, w) -> torch.Tensor:
  """x @ w in float32. An int8 QuantizedWeight is the reference's
  _dequant_matmul, (x @ values) * scale: the scale after the product,
  not folded into the weight."""
  if isinstance(w, QuantizedWeight):
    out = x @ w.values.float()
    return out if w.scale is None else out * w.scale.float()
  return x @ w.float()


def attention_core_plain(qkv: torch.Tensor, *, batch: int, length: int,
                         num_heads: int, attn_win_size: Optional[int],
                         mask: Optional[torch.Tensor] = None,
                         softmax_dtype: Any = torch.float32) -> torch.Tensor:
  """The attention core's plain version (_kernels.attention's kernel,
  csrc/ragged_attention.cu), as the reference computes it: qkv
  [B*L, 3H] float32 with q pre-scaled -> o [B*L, H] float32. Full
  [L, L] scores per head, logits -1e9 outside the band (or outside mask,
  [B, L, L] bool, ragged slots), softmax_chain in the softmax dtype,
  weights times v in float32."""
  hidden = qkv.shape[1] // 3
  q, k, v = (t.reshape(batch, length, num_heads, hidden // num_heads)
             for t in qkv.float().split(hidden, dim=1))
  s = torch.einsum('blnd,bmnd->bnlm', q, k)
  if mask is None and attn_win_size is not None:
    i = torch.arange(length, device=qkv.device)
    mask = (i[:, None] - i[None, :]).abs() <= attn_win_size
  if mask is not None:
    if mask.dim() == 3:
      mask = mask[:, None]
    s = torch.where(mask, s, torch.full((), _NEG, device=qkv.device))
  w = softmax_chain(s, softmax_dtype)
  return torch.einsum('bnlm,bmnd->blnd', w, v).reshape(batch * length,
                                                        hidden)


def attention_plain(x: torch.Tensor, wq, wk, wv, wo, *, num_heads: int,
                    attn_win_size: Optional[int],
                    mask: Optional[torch.Tensor] = None,
                    softmax_dtype: Any = torch.float32) -> torch.Tensor:
  """Banded MHA on [B, L, H] float32 as the reference computes it: the
  q/k/v projections (q scaled), attention_core_plain (mask, [B, L, L]
  bool for ragged slots, replaces the static band), the output
  projection. Weights (tensors or QuantizedWeights, matmul_plain) are
  upcast to float32. Shared by the K1, K2 and K4 plain paths."""
  b, length, hidden = x.shape
  head_dim = hidden // num_heads
  x2 = x.reshape(b * length, hidden)
  qkv = torch.cat([matmul_plain(x2, wq) * (head_dim ** -0.5),
                   matmul_plain(x2, wk), matmul_plain(x2, wv)], dim=1)
  o = attention_core_plain(qkv, batch=b, length=length, num_heads=num_heads,
                           attn_win_size=attn_win_size, mask=mask,
                           softmax_dtype=softmax_dtype)
  return matmul_plain(o, wo).reshape(b, length, hidden)


def embed_condense_plain(rows, tables, w_cond, *, specs, table_keys,
                         compute_dtype) -> torch.Tensor:
  """[B, R, L] rows -> float32 [B, L, H]: gather embedding (id 0 masked,
  tables scaled at the compute dtype) and the condenser, no pos."""
  b, _, length = rows.shape
  ids = prepare_ids(rows, specs).long()
  tabs = [t.float() for t in scaled_tables(
      tables, specs, table_keys, compute_dtype)]
  blocks = []
  for spec in specs:
    seg = ids[:, spec.row_start:spec.row_start + spec.n_rows]  # [B, r, L]
    emb = tabs[spec.table_idx][seg] * (seg > 0)[..., None]  # [B, r, L, W]
    blocks.append(emb.permute(0, 2, 1, 3).reshape(b, length, -1))
  return torch.cat(blocks, dim=-1) @ w_cond.to(compute_dtype).float()


def fused_embed_condense_attention_plain(
    rows, tables, w_cond, wq, wk, wv, wo, pos, *, specs, table_keys,
    num_heads, attn_win_size, softmax_dtype=torch.float32,
    compute_dtype=torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
  """Plain PyTorch K1 (any device): gather embedding, condenser, pos,
  layer-0 attention, all in float32 from compute-dtype inputs."""
  sdt = resolve_softmax_dtype(softmax_dtype)
  dt = resolve_dtype(compute_dtype)
  x = embed_condense_plain(rows, tables, w_cond, specs=specs,
                           table_keys=table_keys, compute_dtype=dt)
  if pos is not None:
    x = x + pos.to(dt).float()[None]
  out = attention_plain(
      x, wq.to(dt), wk.to(dt), wv.to(dt), wo.to(dt), num_heads=num_heads,
      attn_win_size=attn_win_size, softmax_dtype=sdt)
  return x.to(dt), out.to(dt)


class CondenseLayout(NamedTuple):
  """Where the condenser kernel stages each table in shared memory and
  how it maps pileup rows and condenser columns onto them
  (csrc/embed_condense.cu). A function of the family specs and shapes
  only, never of the weights' values."""

  meta: np.ndarray  # int32 [4 R + K + K / 8]
  bases: Tuple[int, ...]  # staged offset of each table's first entry
  entries: int  # staged entries per plane, a multiple of 8


def _round8(n: int) -> int:
  return -(-n // 8) * 8


@functools.lru_cache(maxsize=16)
def condense_layout(specs: Tuple[FamilySpec, ...],
                    table_sizes: Tuple[int, ...], n_rows: int
                    ) -> CondenseLayout:
  """The staged tables: a zero region (as wide as the widest family,
  where id 0 points) and then each table (table_sizes[i] entries) at an
  offset that is a multiple of 8. meta: per pileup row (shift, largest
  id, table base, width; zeros for a row of no family), per condenser
  column (row | element << 16), and per group of eight columns
  (row | element0 << 16 | 1 << 31 when the eight are one row's elements
  element0 .. element0 + 7 at a 16-byte aligned staged offset, else 0)."""
  bases = []
  end = _round8(max(s.width for s in specs))
  for size in table_sizes:
    bases.append(end)
    end = _round8(end + size)
  rows = np.zeros((n_rows, 4), np.int64)
  cols = []
  for spec in specs:
    base = bases[spec.table_idx]
    for r in range(spec.row_start, spec.row_start + spec.n_rows):
      rows[r] = (spec.shift, spec.vocab - 1, base, spec.width)
      cols.extend((r, e, spec.width % 8 == 0) for e in range(spec.width))
  groups = []
  for g in range(0, len(cols) - len(cols) % 8, 8):
    r0, e0, aligned = cols[g]
    whole = all(cols[g + j][:2] == (r0, e0 + j) for j in range(8))
    groups.append(r0 | e0 << 16 | 1 << 31 if whole and aligned
                  and e0 % 8 == 0 else 0)
  meta = np.concatenate([
      rows.reshape(-1), [r | e << 16 for r, e, _ in cols], groups])
  return CondenseLayout(meta.astype(np.uint32).view(np.int32),
                        tuple(bases), end)


@functools.lru_cache(maxsize=16)
def _table_scale(width: int, dtype: torch.dtype) -> float:
  """sqrt(width) in the compute dtype, as scaled_tables multiplies."""
  return float(torch.tensor(width ** 0.5, dtype=dtype))


def fused_embed_condense_attention(
    rows: torch.Tensor,
    tables: Dict[str, torch.Tensor],
    w_cond: torch.Tensor,
    wq: torch.Tensor,
    wk: torch.Tensor,
    wv: torch.Tensor,
    wo: torch.Tensor,
    pos: Optional[torch.Tensor],
    *,
    specs: Tuple[FamilySpec, ...],
    table_keys: Tuple[str, ...],
    num_heads: int,
    attn_win_size: Optional[int],
    softmax_dtype: Any = torch.float32,
    compute_dtype: Any = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
  """K1 over a window batch. rows: [B, R, L] raw pileup rows; tables:
  unscaled embedding tables keyed per build_family_specs; w_cond
  [cond_in, H]; wq/wk/wv/wo [H, H] (the attention kernels flattened);
  pos [L, H] or None. Returns (x_base, attn_out) [B, L, H] in the
  compute dtype. softmax_dtype: the attn_softmax_dtype lever (float32
  or bfloat16, softmax_chain). A CPU tensor runs the plain version; a
  CUDA tensor launches the kernels."""
  global n_launches, n_launches_bf16_softmax
  sdt = resolve_softmax_dtype(softmax_dtype)
  dt = resolve_dtype(compute_dtype)
  b, _, length = rows.shape
  cond_in, hidden = w_cond.shape
  if sum(s.n_rows * s.width for s in specs) != cond_in:
    raise ValueError(
        f'condenser expects {cond_in} input features, family specs '
        f'cover {sum(s.n_rows * s.width for s in specs)}')
  if hidden % num_heads:
    raise ValueError('hidden size must divide num_heads')
  if length > MAX_WINDOW_LEN:
    raise NotImplementedError(
        f'window length {length} > {MAX_WINDOW_LEN}: wider windows run '
        'in ragged slots (ops/ragged_window_attention.py, '
        '--use_ragged_kernel)')
  if rows.device.type == 'cpu':
    return fused_embed_condense_attention_plain(
        rows, tables, w_cond, wq, wk, wv, wo, pos, specs=specs,
        table_keys=table_keys, num_heads=num_heads,
        attn_win_size=attn_win_size, softmax_dtype=sdt, compute_dtype=dt)
  if rows.device.type != 'cuda':
    raise ValueError(f'unsupported device {rows.device}')
  out = embed_condense_attend(
      rows, tables, w_cond, wq, wk, wv, wo, pos, specs=specs,
      table_keys=table_keys, num_heads=num_heads,
      attn_win_size=attn_win_size, compute_dtype=dt, softmax_dtype=sdt)
  if sdt == torch.float32:
    n_launches += 1
  else:
    n_launches_bf16_softmax += 1
  return out


class CondenseOperands(NamedTuple):
  """What the condenser launch reads besides the rows, gathered per call
  from the weights as they are then: the kernel scales the tables
  itself, so nothing here copies them (and nothing caches them: training
  and evaluate update them in place)."""

  meta: torch.Tensor
  tables: Tuple[torch.Tensor, ...]
  scales: Tuple[float, ...]
  bases: Tuple[int, ...]
  entries: int
  w_cond: torch.Tensor
  pos: Optional[torch.Tensor]


@functools.lru_cache(maxsize=16)
def _device_meta(specs: Tuple[FamilySpec, ...], table_sizes: Tuple[int, ...],
                 n_rows: int, device: torch.device) -> torch.Tensor:
  return torch.from_numpy(
      condense_layout(specs, table_sizes, n_rows).meta).to(device)


def condense_operands(tables, w_cond, pos, *, specs, table_keys,
                      compute_dtype: torch.dtype, n_rows: int
                      ) -> CondenseOperands:
  """The per-call preparation of the condenser's operands: the tables
  as they are (unscaled, their own dtype), their layout, w_cond and pos
  in the compute dtype."""
  dt = compute_dtype
  tabs = tuple(tables[key].contiguous() for key in table_keys)
  for i, t in enumerate(tabs):
    width = next(s.width for s in specs if s.table_idx == i)
    if t.dim() != 2 or t.shape[1] != width:
      raise ValueError(f'table {table_keys[i]} shape {tuple(t.shape)}, '
                       f'want [vocab, {width}]')
  sizes = tuple(int(t.numel()) for t in tabs)
  layout = condense_layout(specs, sizes, n_rows)
  meta = _device_meta(specs, sizes, n_rows, w_cond.device)
  scales = tuple(_table_scale(next(s.width for s in specs
                                   if s.table_idx == i), dt)
                 for i in range(len(tabs)))
  return CondenseOperands(meta, tabs, scales, layout.bases, layout.entries,
                          w_cond.to(dt).contiguous(),
                          None if pos is None else pos.to(dt).contiguous())


def condense(rows: torch.Tensor, ops: CondenseOperands, x: torch.Tensor,
             x_base: Optional[torch.Tensor],
             lengths: Optional[torch.Tensor] = None) -> None:
  """The condenser launch: x [B, L, H] float32 (and x_base, bfloat16
  runs) = embed(rows) @ w_cond + pos."""
  _kernels.embed_condense(rows, ops.meta, ops.tables, ops.scales, ops.bases,
                          ops.entries, ops.w_cond, ops.pos, x, x_base,
                          lengths=lengths)


def embed_condense_attend(
    rows, tables, w_cond, wq, wk, wv, wo, pos, *, specs, table_keys,
    num_heads, attn_win_size, compute_dtype: torch.dtype,
    softmax_dtype: torch.dtype, lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
  """The CUDA body of K1 (lengths None) and K4 (lengths [B, wps] int32
  on the card: ragged slots, from which the kernels derive each
  position's window themselves)."""
  b, _, length = rows.shape
  hidden = w_cond.shape[1]
  dt = compute_dtype
  dev = rows.device
  ops = condense_operands(tables, w_cond, pos, specs=specs,
                          table_keys=table_keys, compute_dtype=dt,
                          n_rows=rows.shape[1])
  x = torch.empty((b, length, hidden), dtype=torch.float32, device=dev)
  x_base = x if dt == torch.float32 else torch.empty_like(x, dtype=dt)
  condense(rows.to(torch.float32).contiguous(), ops, x,
           None if dt == torch.float32 else x_base, lengths=lengths)
  attn_out = torch.empty((b, length, hidden), dtype=dt, device=dev)
  project_attend(x.view(b * length, hidden), wq, wk, wv, wo,
                 attn_out.view(b * length, hidden), batch=b, length=length,
                 num_heads=num_heads, attn_win_size=attn_win_size,
                 compute_dtype=dt, softmax_dtype=softmax_dtype,
                 lengths=lengths)
  return x_base, attn_out


def gemm_operand(weights: Sequence[Any], compute_dtype: torch.dtype
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
  """(values, col_scale) of one GEMM over weights joined along their
  output columns: int8 values stay int8 (with their float32 scales
  joined alike), float values go to the compute dtype (no scale).
  int8 and float weights do not mix in one GEMM."""
  qws = [as_quantized(w) for w in weights]
  if len({qw.scale is None for qw in qws}) > 1:
    raise ValueError('int8 and float weights in one fused GEMM')
  if qws[0].scale is None:
    values = [qw.values.to(compute_dtype) for qw in qws]
    return torch.cat(values, dim=1).contiguous(), None
  return (torch.cat([qw.values for qw in qws], dim=1).contiguous(),
          torch.cat([qw.scale.float() for qw in qws]).contiguous())


def project_attend(x2: torch.Tensor, wq, wk, wv, wo, out: torch.Tensor, *,
                   batch: int, length: int, num_heads: int,
                   attn_win_size: Optional[int], compute_dtype: torch.dtype,
                   softmax_dtype: torch.dtype = torch.float32,
                   res: Optional[torch.Tensor] = None,
                   alpha: Optional[torch.Tensor] = None,
                   lengths: Optional[torch.Tensor] = None) -> None:
  """CUDA banded MHA on token rows x2 [B*L, H] into out [B*L, H]: the
  fused q/k/v GEMM (q scaled in its epilogue), the attention core
  (csrc/ragged_attention.cu, its softmax in softmax_dtype; with
  lengths, each query attends only inside its own ragged window), and
  the output GEMM, whose epilogue
  optionally adds the ReZero residual res + alpha * y. Shared by K1, K2
  and K4. Weights are tensors or QuantizedWeights: int8 q/k/v join into
  one [H, 3H] int8 operand with a [3H] scale, dequantized in the GEMM's
  epilogue before the q scale, and wo keeps its own scale."""
  hidden = x2.shape[1]
  head_dim = hidden // num_heads
  wqkv, qkv_scale = gemm_operand((wq, wk, wv), compute_dtype)
  qkv = torch.empty((x2.shape[0], 3 * hidden), dtype=torch.float32,
                    device=x2.device)
  _kernels.gemm(x2, wqkv, qkv, compute_dtype=compute_dtype,
                scale=head_dim ** -0.5, scale_cols=hidden, col_scale=qkv_scale)
  o = torch.empty((x2.shape[0], hidden), dtype=torch.float32,
                  device=x2.device)
  win = length - 1 if attn_win_size is None else int(attn_win_size)
  _kernels.attention(qkv, o, batch=batch, length=length,
                     num_heads=num_heads, win=win, lengths=lengths,
                     softmax_dtype=softmax_dtype)
  wo_values, wo_scale = gemm_operand((wo,), compute_dtype)
  _kernels.gemm(o, wo_values, out, compute_dtype=compute_dtype,
                col_scale=wo_scale, res=res, alpha=alpha)
