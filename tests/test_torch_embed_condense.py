"""The arithmetic of K1/K4's tensor-core condenser and of K3's binary
search, emulated on the CPU and held against the JAX package.

csrc/embed_condense.cu and csrc/phred_epilogue.cu run only on the card
(tests/test_torch_gpu.py holds them against their plain versions
there). What they compute is emulated here step by step from the same
layout the wrapper hands the kernel (fused_window_attention.
condense_layout): the staged, scaled tables split into bf16 piece
planes; the ids decoded into offsets (truncated, shifted, clipped, id 0
to the zero region); the A operand gathered column by column; the
piece products each MMA keeps, summed in float64 within a 32-deep K
chunk and accumulated in float32 chunk by chunk; then pos. Tolerances:
float32 rtol 1e-5 (atol 1e-6) against the reference's float32
`_embed_condense` (only the order of float32 sums differs); bfloat16
within one bf16 ulp of the reference's x_base; the table scaling and
K3 bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepconsensus_tpu.calibration import lib as jax_calibration
from deepconsensus_tpu.models import config as jax_config
from deepconsensus_tpu.ops import fused_window_attention as jax_fwa
from deepconsensus_tpu.ops import output_plane as jax_output_plane
from deepconsensus_tpu_torch.ops import _kernels
from deepconsensus_tpu_torch.ops import fused_window_attention as fwa
from deepconsensus_tpu_torch.ops import output_plane

HIDDEN, CHUNK = 280, 32


def bf16_pieces(x: torch.Tensor, n: int):
  """x (float32) as n bf16 pieces, largest first, each rounding what the
  earlier ones left (mma_gemm.cuh::split_pair)."""
  out, rest = [], x.float()
  for _ in range(n):
    piece = rest.to(torch.bfloat16).float()
    out.append(piece)
    rest = rest - piece
  return out


def kernel_scaled_table(table: torch.Tensor, scale: float,
                        dt: torch.dtype) -> torch.Tensor:
  """The kernel's prologue: the table value rounded to the compute
  dtype, times the scale (already in the compute dtype) in float32,
  rounded to the compute dtype."""
  v = table.to(dt).float() * torch.tensor(scale, dtype=torch.float32)
  return v.to(dt).float()


def emulate_condenser(rows, tables, w_cond, pos, specs, keys, dt):
  """x [B, L, N] float32 as csrc/embed_condense.cu computes it."""
  b, r, length = rows.shape
  k, n = w_cond.shape
  sizes = tuple(int(tables[key].numel()) for key in keys)
  layout = fwa.condense_layout(specs, sizes, r)
  meta = layout.meta.astype(np.int64)
  row_meta = meta[:4 * r].reshape(r, 4)
  cols = meta[4 * r:4 * r + k]
  pieces = 1 if dt == torch.bfloat16 else 3
  assert _kernels.split_pieces(dt, dt, dt) == (pieces, pieces)
  staged = torch.zeros(layout.entries)
  for i, key in enumerate(keys):
    width = next(s.width for s in specs if s.table_idx == i)
    scale = fwa._table_scale(width, dt)
    vals = kernel_scaled_table(tables[key].reshape(-1), scale, dt)
    staged[layout.bases[i]:layout.bases[i] + sizes[i]] = vals
  planes = bf16_pieces(staged, pieces)
  # ids -> offsets: truncate, shift, clip, id 0 -> the zero region.
  ids = torch.from_numpy(rows).to(torch.int32).long()  # [B, R, L]
  shift, vmax, base, width = (torch.from_numpy(row_meta[:, j])[None, :, None]
                              for j in range(4))
  ids = torch.minimum(torch.clamp(ids + shift, min=0), vmax)
  off = torch.where(ids > 0, base + ids * width, torch.zeros_like(ids))
  off = off.permute(0, 2, 1).reshape(b * length, r)
  # Each column's (row, element): a fast group's eight from its one
  # entry (the kernel's 16-byte read), the others column by column.
  col_row, col_elem = cols & 0xffff, cols >> 16
  for g, entry in enumerate(meta[4 * r + k:]):
    if entry < 0:  # bit 31 set
      col_row[8 * g:8 * g + 8] = entry & 0xffff
      col_elem[8 * g:8 * g + 8] = ((entry >> 16) & 0x7fff) + np.arange(8)
  col_row, col_elem = torch.from_numpy(col_row), torch.from_numpy(col_elem)
  gather = off[:, col_row] + col_elem[None]  # [M, K]
  a = [p[gather] for p in planes]
  wb = bf16_pieces(w_cond.to(dt).float(), pieces)
  acc = torch.zeros((b * length, n), dtype=torch.float32)
  for k0 in range(0, k, CHUNK):
    ks = slice(k0, k0 + CHUNK)
    part = torch.zeros((b * length, n), dtype=torch.float64)
    for p in range(pieces):
      for q in range(pieces - p):  # the 6 products above 2^-24 (3 x 3)
        part += a[p][:, ks].double() @ wb[q][ks].double()
    acc = (acc.double() + part).float()
  return acc.reshape(b, length, n) + pos.to(dt).float()[None]


def jax_params(use_ccs_bq: bool):
  params = jax_config.get_config(
      'transformer_learn_values+' + ('test_bq' if use_ccs_bq else 'test'))
  jax_config.finalize_params(params, max_length=100)
  return params


def edge_rows(params, batch, rng):
  """Pileup rows in the model's ranges, plus edge ids in every family:
  negative, fractional, past the vocabulary, 0."""
  mp = params.max_passes
  rows = np.zeros((batch, params.total_rows, 100), np.float32)
  rows[:, :mp] = rng.integers(0, 5, rows[:, :mp].shape)
  rows[:, mp:3 * mp] = rng.integers(0, 256, rows[:, mp:3 * mp].shape)
  rows[:, 3 * mp:4 * mp] = rng.integers(0, 3, rows[:, :mp].shape)
  rows[:, 4 * mp] = rng.integers(0, 5, rows[:, 4 * mp].shape)
  sn_lo = 4 * mp + 1
  if params.use_ccs_bq:
    rows[:, sn_lo] = rng.integers(-1, params.CCS_BQ_MAX - 1,
                                  rows[:, sn_lo].shape)
    sn_lo += 1
  rows[:, sn_lo:] = rng.uniform(0, 520, rows[:, sn_lo:].shape)
  edges = np.array([-3.7, -1.0, -0.5, 0.0, 0.9, 2.5, 94.2, 95.0, 256.0,
                    501.0, 1e4], np.float32)
  mask = rng.random(rows.shape) < 0.05
  rows[mask] = rng.choice(edges, mask.sum())
  return rows


@pytest.mark.parametrize('use_ccs_bq', [False, True])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_condenser_emulation_matches_reference(dtype, use_ccs_bq):
  """The kernel's arithmetic, at full width (85 or 86 rows, 560 or 568
  -> 280, 4 windows x 100), vs the reference's _embed_condense + pos."""
  params = jax_params(use_ccs_bq)
  specs, keys, cond_in = jax_fwa.build_family_specs(params)
  rng = np.random.default_rng(7)
  tables = {k: rng.normal(0, 0.5, (next(
      s.vocab for s in specs if s.table_idx == i), next(
      s.width for s in specs if s.table_idx == i))).astype(np.float32)
            for i, k in enumerate(keys)}
  w_cond = rng.normal(0, 0.05, (cond_in, HIDDEN)).astype(np.float32)
  pos = rng.normal(0, 1, (100, HIDDEN)).astype(np.float32)
  rows = edge_rows(params, 4, rng)

  jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
  table_in = [
      jnp.asarray(tables[key], jdt) * jnp.asarray(
          next(s.width for s in specs if s.table_idx == i) ** 0.5, jdt)
      for i, key in enumerate(keys)]
  ids = jax_fwa.prepare_ids(jnp.asarray(rows), specs)
  ref = jax_fwa._embed_condense(
      ids, table_in, jnp.asarray(w_cond, jdt).astype(jnp.float32), specs, 4,
      100, HIDDEN) + jnp.asarray(pos, jdt).astype(jnp.float32)[None]
  ref = np.asarray(ref)

  got = emulate_condenser(
      rows, {k: torch.from_numpy(v) for k, v in tables.items()},
      torch.from_numpy(w_cond), torch.from_numpy(pos), specs, keys, dtype)
  if dtype == torch.float32:
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
  else:
    bits = lambda a: torch.as_tensor(a).to(torch.bfloat16).view(
        torch.int16).int()
    got_b, ref_b = bits(got), bits(np.array(jnp.asarray(ref, jdt)
                                            .astype(jnp.float32)))
    same_sign = (got_b < 0) == (ref_b < 0)
    assert bool(same_sign[(got_b - ref_b) != 0].all())
    assert int((got_b - ref_b).abs().max()) <= 1


@pytest.mark.parametrize('table_dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_kernel_table_scaling_is_bit_exact(dtype, table_dtype):
  """The prologue's scaling reproduces scaled_tables (and the
  reference's cast-then-multiply) bit for bit over every entry."""
  params = jax_params(True)
  specs, keys, _ = jax_fwa.build_family_specs(params)
  rng = np.random.default_rng(3)
  jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
  tables = {key: torch.from_numpy(rng.normal(0, 2, (
      next(s.vocab for s in specs if s.table_idx == i),
      next(s.width for s in specs if s.table_idx == i))).astype(
          np.float32)).to(table_dtype) for i, key in enumerate(keys)}
  want = fwa.scaled_tables(tables, specs, keys, dtype)
  for i, key in enumerate(keys):
    width = next(s.width for s in specs if s.table_idx == i)
    got = kernel_scaled_table(tables[key], fwa._table_scale(width, dtype),
                              dtype)
    assert torch.equal(got.view(torch.int32),
                       want[i].float().view(torch.int32))
    ref = np.asarray((jnp.asarray(tables[key].float().numpy()).astype(jdt)
                      * jnp.asarray(width ** 0.5, jdt)).astype(jnp.float32))
    assert np.array_equal(got.numpy().view(np.int32), ref.view(np.int32))


def test_condense_layout_maps_every_column():
  """Every column's (row, element) and every fast group's 16-byte
  read, for widths that are and are not multiples of 8."""
  specs = (
      fwa.FamilySpec('a', 0, 3, 5, 8, 0, 0, 0),
      fwa.FamilySpec('b', 3, 4, 7, 2, 1, 24, 1),
      fwa.FamilySpec('c', 7, 2, 9, 3, 2, 32, 0),
      fwa.FamilySpec('d', 9, 1, 5, 8, 0, 38, 0),
  )
  layout = fwa.condense_layout(specs, (40, 14, 27), 11)
  meta = layout.meta.astype(np.int64)
  k = 46
  assert meta.size == 4 * 11 + k + k // 8
  assert layout.bases == (8, 48, 64) and layout.entries == 96
  row_meta = meta[:44].reshape(11, 4)
  assert row_meta[10].tolist() == [0, 0, 0, 0]  # no family
  assert row_meta[4].tolist() == [1, 6, 48, 2]
  cols = meta[44:44 + k]
  want = ([(r, e) for r in range(3) for e in range(8)]
          + [(r, e) for r in range(3, 7) for e in range(2)]
          + [(r, e) for r in range(7, 9) for e in range(3)]
          + [(9, e) for e in range(8)])
  assert [(c & 0xffff, c >> 16) for c in cols] == want
  groups = meta[44 + k:].astype(np.uint32).view(np.int32)
  fast = [g < 0 for g in groups]
  assert fast == [True, True, True, False, False]
  assert [(int(g) & 0xffff, (int(g) >> 16) & 0x7fff) for g in groups[:3]] == [
      (0, 0), (1, 0), (2, 0)]


def k3_emulate(preds: np.ndarray, thr: np.ndarray):
  """csrc/phred_epilogue.cu per position: argmax (first of ties, first
  NaN) and the upper-bound binary search of at most 8 probes."""
  flat = preds.reshape(-1, preds.shape[-1])
  ids = np.zeros(flat.shape[0], np.uint8)
  quals = np.zeros(flat.shape[0], np.uint8)
  for i, row in enumerate(flat):
    best, arg = row[0], 0
    for v in range(1, row.size):
      if row[v] > best or (np.isnan(row[v]) and not np.isnan(best)):
        best, arg = row[v], v
    q, step = 0, 128
    while step:
      if q + step <= thr.size and best >= thr[q + step - 1]:
        q += step
      step >>= 1
    ids[i], quals[i] = arg, q
  return ids.reshape(preds.shape[:-1]), quals.reshape(preds.shape[:-1])


def k3_thresholds(kind: str) -> np.ndarray:
  if kind == 'empty':
    return np.zeros((0,), np.float32)
  cal = 'skip' if kind == 'skip' else '0,1.1,-0.5'
  return output_plane.quality_thresholds(
      jax_calibration.parse_calibration_string(cal), 93)


@pytest.mark.parametrize('kind', ['skip', 'monotone', 'empty'])
def test_k3_binary_search_matches_reference_exactly(kind):
  thr = k3_thresholds(kind)
  if kind != 'empty':
    assert thr.size > 0 and np.all(np.diff(thr) >= 0)
  rng = np.random.default_rng(5)
  preds = rng.dirichlet(np.ones(5) * 0.3, (4, 40)).astype(np.float32)
  preds[0, :10] = 0.2  # five-way ties
  preds[0, 10:20, 1] = preds[0, 10:20, 3] = 0.45
  preds[1, :5, 2] = np.nan
  preds[1, 5:10] = np.nan
  if thr.size:
    preds[2, :, 4] = thr[rng.integers(0, thr.size, 40)]  # on thresholds
    preds[2, :5, 0] = np.nextafter(thr[:5], np.float32(-1))
  preds[3, :5, 0] = 0.0
  preds[3, 5:10, 1] = 1.0
  ids, quals = k3_emulate(preds, thr)
  plain = output_plane.phred_epilogue_plain(torch.from_numpy(preds),
                                            torch.from_numpy(thr))
  pallas = jax_output_plane.phred_epilogue_pallas(
      jnp.asarray(preds), thr, interpret=True)
  for got, p, j in zip((ids, quals), plain, pallas):
    np.testing.assert_array_equal(got, p.numpy())
    np.testing.assert_array_equal(got, np.asarray(j))


def test_k3_wrapper_refuses_unsorted_numpy_thresholds():
  preds = torch.full((1, 2, 5), 0.2)
  with pytest.raises(ValueError, match='non-decreasing'):
    output_plane.phred_epilogue(preds, np.float32([0.5, 0.4]))
  with pytest.raises(ValueError, match='non-decreasing'):
    output_plane.phred_epilogue(preds, np.float32([0.1, np.nan]))
  ids, quals = output_plane.phred_epilogue(preds, np.float32([0.1, 0.2]))
  assert ids.tolist() == [[0, 0]] and quals.tolist() == [[2, 2]]
