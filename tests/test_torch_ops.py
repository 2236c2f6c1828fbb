"""K1-K3 of the PyTorch port held against the JAX package's kernels.

The same seeded numpy inputs go through the JAX function (its Pallas
kernel in interpret mode, as the JAX package's own CPU tests run it,
and its pure-jnp reference) and through the port's wrapper on CPU
tensors, where the wrapper runs its plain version. Tolerances: float32
atol 1e-5 (different but valid summation orders); K3 exact (pure
comparisons, no transcendentals). ReZero alphas are non-zero so the
residual branches count. tests/test_torch_gpu.py holds each CUDA kernel
against its plain version on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepconsensus_tpu.calibration import lib as jax_calibration
from deepconsensus_tpu.models import config as jax_config
from deepconsensus_tpu.ops import fused_encoder_block as jax_feb
from deepconsensus_tpu.ops import fused_window_attention as jax_fwa
from deepconsensus_tpu.ops import output_plane as jax_output_plane
from deepconsensus_tpu_torch.models import config as torch_config
from deepconsensus_tpu_torch.ops import fused_encoder_block as feb
from deepconsensus_tpu_torch.ops import fused_window_attention as fwa
from deepconsensus_tpu_torch.ops import output_plane
from deepconsensus_tpu_torch.ops import ragged_window_attention as rwa

HIDDEN, HEADS, BAND, FILTER = 280, 2, 12, 64


def jax_params(use_ccs_bq: bool, length: int):
  params = jax_config.get_config(
      'transformer_learn_values+' + ('test_bq' if use_ccs_bq else 'test'))
  jax_config.finalize_params(params, max_length=length)
  return params


def torch_params(use_ccs_bq: bool, length: int):
  params = torch_config.get_config(
      'transformer_learn_values+' + ('test_bq' if use_ccs_bq else 'test'))
  torch_config.finalize_params(params, max_length=length)
  return params


def fake_rows(params, batch, rng):
  mp = params.max_passes
  rows = np.zeros((batch, params.total_rows, params.max_length), np.float32)
  rows[:, :mp] = rng.integers(0, 5, rows[:, :mp].shape)
  rows[:, mp:3 * mp] = rng.integers(0, 256, rows[:, mp:3 * mp].shape)
  rows[:, 3 * mp:4 * mp] = rng.integers(0, 3, rows[:, :mp].shape)
  rows[:, 4 * mp] = rng.integers(0, 5, rows[:, 4 * mp].shape)
  sn_lo = 4 * mp + 1
  if params.use_ccs_bq:
    rows[:, sn_lo] = rng.integers(-1, params.CCS_BQ_MAX - 1,
                                  rows[:, sn_lo].shape)
    sn_lo += 1
  # SN values are floats; the id path truncates them.
  rows[:, sn_lo:] = rng.uniform(0, 520, rows[:, sn_lo:].shape)
  return rows


def k1_inputs(params, rng, batch):
  specs, keys, cond_in = jax_fwa.build_family_specs(params)
  tables = {k: rng.normal(0, 0.5, (next(
      s.vocab for s in specs if s.table_idx == i), next(
      s.width for s in specs if s.table_idx == i))).astype(np.float32)
            for i, k in enumerate(keys)}
  weights = [rng.normal(0, 0.05, shape).astype(np.float32) for shape in
             [(cond_in, HIDDEN)] + [(HIDDEN, HIDDEN)] * 4]
  pos = rng.normal(0, 1, (params.max_length, HIDDEN)).astype(np.float32)
  return fake_rows(params, batch, rng), tables, weights, pos, specs, keys


@pytest.mark.parametrize('use_ccs_bq,length', [(False, 100), (True, 20)])
def test_k1_plain_matches_jax(use_ccs_bq, length):
  params = jax_params(use_ccs_bq, length)
  rng = np.random.default_rng(1)
  rows, tables, weights, pos, specs, keys = k1_inputs(params, rng, 3)
  port_specs = fwa.build_family_specs(torch_params(use_ccs_bq, length))
  assert port_specs == (specs, keys, weights[0].shape[0])
  kw = dict(specs=specs, table_keys=keys, num_heads=HEADS,
            attn_win_size=BAND)
  got = fwa.fused_embed_condense_attention(
      torch.from_numpy(rows), {k: torch.from_numpy(v)
                               for k, v in tables.items()},
      *map(torch.from_numpy, weights), torch.from_numpy(pos), **kw)
  jargs = (jnp.asarray(rows), {k: jnp.asarray(v) for k, v in tables.items()},
           *map(jnp.asarray, weights), jnp.asarray(pos))
  pallas = jax_fwa.fused_embed_condense_attention(*jargs, **kw,
                                                  tile_windows=2)
  ref = jax_fwa.reference_fused_forward(*jargs, **kw)
  for g, p, r in zip(got, pallas, ref):
    np.testing.assert_allclose(g.numpy(), np.asarray(p), atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)


def random_block(rng, has_attn):
  w = lambda *shape: rng.normal(0, 0.05, shape).astype(np.float32)
  attn = ([w(HIDDEN, HIDDEN) for _ in range(4)]
          + [np.float32(rng.uniform(0.5, 1.0))]) if has_attn else [None] * 5
  return attn + [w(HIDDEN, FILTER), w(FILTER), w(FILTER, HIDDEN), w(HIDDEN),
                 np.float32(rng.uniform(0.5, 1.0))]


@pytest.mark.parametrize('length', [20, 100])
def test_k2_plain_matches_jax(length):
  rng = np.random.default_rng(2)
  raw = [random_block(rng, False), random_block(rng, True)]
  x = rng.normal(0, 1, (3, length, HIDDEN)).astype(np.float32)
  to_t = lambda a: None if a is None else torch.from_numpy(np.asarray(a))
  to_j = lambda a: None if a is None else jnp.asarray(a)
  jblocks = []
  for b in raw:
    vals = [to_j(a) for a in b]
    for i in (0, 1, 2, 3, 5, 7):
      if vals[i] is not None:
        vals[i] = jax_feb.QuantizedWeight(vals[i], None)
    jblocks.append(jax_feb.EncoderBlockWeights(*vals))
  tblocks = [feb.EncoderBlockWeights(*[to_t(a) for a in b]) for b in raw]
  for n in (1, 2):  # the FFN-only block, then it and a full block
    kw = dict(num_heads=HEADS, attn_win_size=BAND)
    got = feb.fused_encoder_stack(torch.from_numpy(x), tblocks[:n], **kw)
    pallas = jax_feb.fused_encoder_stack(jnp.asarray(x), jblocks[:n], **kw,
                                         tile_windows=2)
    ref = jax_feb.reference_encoder_stack(jnp.asarray(x), jblocks[:n], **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def epilogue_preds(thresholds, rng, batch=4, length=16):
  """Softmax rows plus rows with tied maxima and maxima placed exactly
  on quality thresholds."""
  logits = rng.normal(0, 3, (batch, length, 5))
  preds = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
  preds = preds.astype(np.float32)
  preds[0] = 0.2
  preds[1, :, 1] = preds[1, :, 3] = 0.45
  preds[1, :, [0, 2, 4]] = 0.1 / 3
  preds[2, :, 4] = thresholds[rng.integers(0, len(thresholds), length)]
  preds[2, :, :4] = (1.0 - preds[2, :, 4:]) / 16
  return preds


@pytest.mark.parametrize('calibration', ['skip', '0,1.1,-2'])
def test_k3_plain_matches_jax_exactly(calibration):
  cv = jax_calibration.parse_calibration_string(calibration)
  thresholds = jax_output_plane.quality_thresholds(cv, 93)
  port_thr = output_plane.quality_thresholds(cv, 93)
  np.testing.assert_array_equal(thresholds, port_thr)
  preds = epilogue_preds(thresholds, np.random.default_rng(3))
  want = jax_output_plane.phred_epilogue(
      jnp.asarray(preds), thresholds, use_pallas=True)
  got = output_plane.phred_epilogue(torch.from_numpy(preds), port_thr)
  for g, w in zip(got, want):
    assert g.dtype == torch.uint8
    np.testing.assert_array_equal(g.numpy(), np.asarray(w))
  assert (got[0][1] == 1).all()  # first of the tied maxima


def test_cpu_tensor_runs_plain_version_without_launch():
  thr = output_plane.quality_thresholds(
      jax_calibration.parse_calibration_string('skip'), 93)
  preds = torch.from_numpy(epilogue_preds(thr, np.random.default_rng(4)))
  before = (fwa.n_launches, feb.n_launches, output_plane.n_launches)
  got = output_plane.phred_epilogue(preds, thr)
  want = output_plane.phred_epilogue_plain(preds, torch.from_numpy(thr))
  for g, w in zip(got, want):
    assert torch.equal(g, w)
  x = torch.randn(2, 20, HIDDEN)
  block = feb.EncoderBlockWeights(*[
      None if a is None else torch.from_numpy(np.asarray(a))
      for a in random_block(np.random.default_rng(5), True)])
  kw = dict(num_heads=HEADS, attn_win_size=BAND)
  assert torch.equal(feb.fused_encoder_stack(x, [block], **kw),
                     feb.fused_encoder_stack_plain(x, [block], **kw))
  assert (fwa.n_launches, feb.n_launches, output_plane.n_launches) == before


def test_unported_variants_raise():
  """A softmax dtype other than float32 and bfloat16 stays unported on
  every kernel, the ragged K4 included (the bfloat16 softmax is ported:
  tests/test_torch_softmax_dtype.py); K2's lengths variant is ported and
  takes [B, wps] lengths only."""
  x = torch.zeros(1, 20, HIDDEN)
  block = feb.EncoderBlockWeights(*[
      None if a is None else torch.from_numpy(np.asarray(a))
      for a in random_block(np.random.default_rng(6), False)])
  with pytest.raises(ValueError, match='lengths'):
    feb.fused_encoder_stack(x, [block], num_heads=HEADS, attn_win_size=BAND,
                            lengths=torch.ones(1))
  with pytest.raises(NotImplementedError, match='float32'):
    feb.fused_encoder_stack(x, [block], num_heads=HEADS, attn_win_size=BAND,
                            softmax_dtype='float16')
  params = jax_params(False, 20)
  rows, tables, weights, pos, specs, keys = k1_inputs(
      params, np.random.default_rng(7), 1)
  with pytest.raises(NotImplementedError, match='float32'):
    rwa.ragged_embed_condense_attention(
        torch.from_numpy(rows), torch.full((1, 1), 20),
        {k: torch.from_numpy(v) for k, v in tables.items()},
        *map(torch.from_numpy, weights), torch.from_numpy(pos), specs=specs,
        table_keys=keys, num_heads=HEADS, attn_win_size=BAND,
        softmax_dtype='float16')
