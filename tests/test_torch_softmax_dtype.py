"""The attn_softmax_dtype=bfloat16 variant of K1, K2 and K4 and of the
module route, held against the JAX package.

* `fused_window_attention.softmax_chain` against jitted jax.nn.softmax
  of bfloat16 logits, bit for bit, and against the attention weights of
  the reference's K2 kernel in interpret mode, bit for bit (read out
  through one-hot values). The compiled kernels cast the weights to
  float32 at once, so XLA leaves the last quotient unrounded: the chain
  follows the kernels, and jax.nn.softmax's bfloat16 output is the
  chain's weights rounded once more.
* The plain K1, K2 (float and int8 weights, with and without lengths)
  and K4 with the variant against the reference's Pallas kernels in
  interpret mode: atol 1e-2 (the bfloat16 tolerance; the max error is
  printed).
* The port's module and fused routes against the Flax model's jitted
  apply with attn_softmax_dtype='bfloat16': atol 0.02, argmax agreement
  > 0.999 (the bar of tests/test_model.py) in float32; >= 0.99 with
  bfloat16 activations (PERF.md's bf16 gate).
* An emulation of csrc/ragged_attention.cu's arithmetic (q, k, v, and
  the float32 softmax numerators split into bf16 pieces; piece products
  summed in float64; the division after the P v products) against the
  reference's `_attention` and the port's attention_core_plain in both
  softmax dtypes: atol 1e-5 (bfloat16: on all but 1% of the elements,
  the rest within 2e-2; see the test).
* `cli train --set attn_softmax_dtype=bfloat16` and `cli run` over its
  params on the CPU.

Inputs are seeded numpy arrays at hidden 280, 2 heads of 140, band 12.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepconsensus_tpu.models import config as jax_config
from deepconsensus_tpu.models import model as jax_model
from deepconsensus_tpu.models import quantize as jax_quantize
from deepconsensus_tpu.ops import fused_encoder_block as jax_feb
from deepconsensus_tpu.ops import fused_window_attention as jax_fwa
from deepconsensus_tpu.ops import ragged_window_attention as jax_rwa
from deepconsensus_tpu_torch import cli
from deepconsensus_tpu_torch.models import config as torch_config
from deepconsensus_tpu_torch.models import model as torch_model
from deepconsensus_tpu_torch.models import weights as weights_lib
from deepconsensus_tpu_torch.ops import fused_encoder_block as feb
from deepconsensus_tpu_torch.ops import fused_window_attention as fwa
from deepconsensus_tpu_torch.ops import ragged_window_attention as rwa
from deepconsensus_tpu_torch.testing import synthetic

HIDDEN, HEADS, BAND, FILTER = 280, 2, 12, 64
HEAD_DIM = HIDDEN // HEADS
BF16 = torch.bfloat16
# Ragged slots of 200 positions: one 200, two 100s, a lone 100, empty.
SLOT_LENGTHS = np.array([[200, 0], [100, 100], [100, 0], [0, 0]], np.int32)


def band_logits(rng, batch, length, scale, win=BAND):
  """[batch, 2, L, L] float32 logits, -1e9 outside the band."""
  s = rng.normal(0, scale, (batch, 2, length, length)).astype(np.float32)
  i = np.arange(length)
  band = np.abs(i[:, None] - i[None, :]) <= win
  return np.where(band, s, np.float32(-1e9)).astype(np.float32)


@pytest.mark.parametrize('case', ['band', 'wide_range', 'masked_rows'])
def test_chain_matches_jitted_jax_softmax_bit_for_bit(case):
  rng = np.random.default_rng(0)
  s = band_logits(rng, 2, 100, 20.0 if case == 'wide_range' else 3.0)
  if case == 'masked_rows':
    s[:, :, ::7] = np.float32(-1e9)  # rows without an unmasked logit
  as_bf16 = jax.jit(lambda x: jax.nn.softmax(x.astype(jnp.bfloat16), -1))
  as_f32 = jax.jit(lambda x: jax.nn.softmax(
      x.astype(jnp.bfloat16), -1).astype(jnp.float32))
  got = fwa.softmax_chain(torch.from_numpy(s), 'bfloat16')
  assert got.dtype == torch.float32
  want16 = np.asarray(as_bf16(s).astype(jnp.float32))
  np.testing.assert_array_equal(got.to(BF16).float().numpy(), want16)
  np.testing.assert_array_equal(got.numpy(), np.asarray(as_f32(s)))
  # A single rounding (torch.softmax on bfloat16) is not the chain.
  once = torch.softmax(torch.from_numpy(s).to(BF16), -1).float().numpy()
  assert (once != want16).mean() > 0.1


def test_chain_float32_is_torch_softmax():
  s = torch.from_numpy(band_logits(np.random.default_rng(1), 2, 60, 3.0))
  for dt in (None, 'float32', torch.float32):
    assert torch.equal(fwa.softmax_chain(s, dt), torch.softmax(s, -1))
  for bad in ('float16', torch.float16, 'int8'):
    with pytest.raises(NotImplementedError, match='float32 or bfloat16'):
      fwa.softmax_chain(s, bad)


def one_hot_block(rng, length):
  """A K2 block whose attention output is its weights: x holds a one-hot
  of each position in the columns of head 1, v maps position j to
  column j of head 0, wo is the identity and the FFN is zero. Returns
  (x, block, q, k): head 0's scaled queries and keys."""
  x = np.zeros((1, length, HIDDEN), np.float32)
  x[0, np.arange(length), HEAD_DIM + np.arange(length)] = 1.0
  wq = np.zeros((HIDDEN, HIDDEN), np.float32)
  wk = np.zeros((HIDDEN, HIDDEN), np.float32)
  wq[HEAD_DIM:HEAD_DIM + length, :HEAD_DIM] = rng.normal(
      0, 1, (length, HEAD_DIM))
  wk[HEAD_DIM:HEAD_DIM + length, :HEAD_DIM] = rng.normal(
      0, 1, (length, HEAD_DIM))
  wv = np.zeros((HIDDEN, HIDDEN), np.float32)
  wv[HEAD_DIM + np.arange(length), np.arange(length)] = 1.0
  z = lambda *shape: jnp.zeros(shape, jnp.float32)
  qw = lambda w: jax_feb.QuantizedWeight(jnp.asarray(w), None)
  block = jax_feb.EncoderBlockWeights(
      qw(wq), qw(wk), qw(wv), qw(np.eye(HIDDEN, dtype=np.float32)),
      jnp.float32(1.0), qw(z(HIDDEN, FILTER)), z(FILTER),
      qw(z(FILTER, HIDDEN)), z(HIDDEN), jnp.float32(1.0))
  q = wq[HEAD_DIM:HEAD_DIM + length, :HEAD_DIM] * np.float32(
      HEAD_DIM ** -0.5)
  return x, block, q, wk[HEAD_DIM:HEAD_DIM + length, :HEAD_DIM]


@pytest.mark.parametrize('lengths', [None, [[60, 40]]])
def test_chain_equals_interpret_kernel_weights_bit_for_bit(lengths):
  """The reference's K2 kernel, in interpret mode, with a bfloat16
  softmax: its head-0 output is the attention weights, exactly."""
  length = 100
  x, block, q, k = one_hot_block(np.random.default_rng(2), length)
  jl = None if lengths is None else jnp.asarray(np.array(lengths, np.int32))
  out = jax_feb.fused_encoder_stack(
      jnp.asarray(x), [block], num_heads=HEADS, attn_win_size=BAND,
      softmax_dtype='bfloat16', lengths=jl, tile_windows=1, interpret=True)
  weights = np.asarray(out)[0, :, :length]
  s = torch.from_numpy(q @ k.T)
  if lengths is None:
    i = torch.arange(length)
    mask = (i[:, None] - i[None, :]).abs() <= BAND
  else:
    mask = rwa.ragged_attention_mask(
        torch.tensor(lengths, dtype=torch.int32), length, BAND)[0]
  s = torch.where(mask, s, torch.full((), -1e9))
  got = fwa.softmax_chain(s, torch.bfloat16).numpy()
  np.testing.assert_array_equal(got, weights)


def k1_inputs(rng, params, batch, length):
  specs, keys, cond_in = jax_fwa.build_family_specs(params)
  tables = {k: rng.normal(0, 0.5, (next(
      s.vocab for s in specs if s.table_idx == i), next(
      s.width for s in specs if s.table_idx == i))).astype(np.float32)
            for i, k in enumerate(keys)}
  weights = [rng.normal(0, 0.05, shape).astype(np.float32) for shape in
             [(cond_in, HIDDEN)] + [(HIDDEN, HIDDEN)] * 4]
  pos = rng.normal(0, 1, (length, HIDDEN)).astype(np.float32)
  mp = params.max_passes
  rows = np.zeros((batch, params.total_rows, length), np.float32)
  rows[:, :mp] = rng.integers(0, 5, rows[:, :mp].shape)
  rows[:, mp:3 * mp] = rng.integers(0, 256, rows[:, mp:3 * mp].shape)
  rows[:, 3 * mp:4 * mp] = rng.integers(0, 3, rows[:, :mp].shape)
  rows[:, 4 * mp] = rng.integers(0, 5, rows[:, 4 * mp].shape)
  rows[:, 4 * mp + 1:] = rng.uniform(0, 500, rows[:, 4 * mp + 1:].shape)
  return rows, tables, weights, pos, specs, keys


def report(name, got, want):
  diff = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
  err = float(diff.max()) if diff.size else 0.0
  print(f'{name}: max |port - jax| {err:.3g}')
  return err


@pytest.mark.parametrize('length', [20, 100])
def test_k1_plain_with_bf16_softmax_matches_interpret_kernel(length):
  params = jax_config.get_config('transformer_learn_values+test')
  jax_config.finalize_params(params, max_length=length)
  rows, tables, weights, pos, specs, keys = k1_inputs(
      np.random.default_rng(3), params, 3, length)
  kw = dict(specs=specs, table_keys=keys, num_heads=HEADS,
            attn_win_size=BAND, softmax_dtype='bfloat16')
  got = fwa.fused_embed_condense_attention(
      torch.from_numpy(rows), {k: torch.from_numpy(v)
                               for k, v in tables.items()},
      *map(torch.from_numpy, weights), torch.from_numpy(pos), **kw)
  want = jax_fwa.fused_embed_condense_attention(
      jnp.asarray(rows), {k: jnp.asarray(v) for k, v in tables.items()},
      *map(jnp.asarray, weights), jnp.asarray(pos), **kw, tile_windows=2,
      interpret=True)
  for name, g, w in zip(('x_base', 'attn_out'), got, want):
    assert report(f'K1 {name}', g.numpy(), w) <= 1e-2
    np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-2)


def k2_block(rng, int8):
  """(JAX block, port block) of one full encoder block."""
  jw, tw = [], []
  for shape in [(HIDDEN, HIDDEN)] * 4 + [(HIDDEN, FILTER), (FILTER, HIDDEN)]:
    w = rng.normal(0, 0.05, shape).astype(np.float32)
    if int8:
      values, scale = jax_quantize._quantize_2d(jnp.asarray(w))
      jw.append(jax_feb.QuantizedWeight(values, scale))
      tw.append(feb.QuantizedWeight(torch.from_numpy(np.array(values)),
                                    torch.from_numpy(np.array(scale))))
    else:
      jw.append(jax_feb.QuantizedWeight(jnp.asarray(w), None))
      tw.append(torch.from_numpy(w))
  b_f = rng.normal(0, 0.1, FILTER).astype(np.float32)
  b_o = rng.normal(0, 0.1, HIDDEN).astype(np.float32)
  alphas = [np.float32(0.7), np.float32(0.9)]
  jblock = jax_feb.EncoderBlockWeights(
      *jw[:4], jnp.asarray(alphas[0]), jw[4], jnp.asarray(b_f), jw[5],
      jnp.asarray(b_o), jnp.asarray(alphas[1]))
  tblock = feb.EncoderBlockWeights(
      *tw[:4], torch.tensor(alphas[0]), tw[4], torch.from_numpy(b_f), tw[5],
      torch.from_numpy(b_o), torch.tensor(alphas[1]))
  return jblock, tblock


@pytest.mark.parametrize('int8', [False, True])
@pytest.mark.parametrize('with_lengths', [False, True])
def test_k2_plain_with_bf16_softmax_matches_interpret_kernel(int8,
                                                             with_lengths):
  rng = np.random.default_rng(4)
  jblock, tblock = k2_block(rng, int8)
  length = 200 if with_lengths else 100
  x = rng.normal(0, 1, (len(SLOT_LENGTHS), length, HIDDEN)).astype(
      np.float32)
  lengths = SLOT_LENGTHS if with_lengths else None
  kw = dict(num_heads=HEADS, attn_win_size=BAND, softmax_dtype='bfloat16')
  got = feb.fused_encoder_stack(
      torch.from_numpy(x), [tblock], **kw,
      lengths=None if lengths is None else torch.from_numpy(lengths))
  want = jax_feb.fused_encoder_stack(
      jnp.asarray(x), [jblock], **kw,
      lengths=None if lengths is None else jnp.asarray(lengths),
      tile_windows=2, interpret=True)
  assert report(f'K2 int8={int8} lengths={with_lengths}', got.numpy(),
                want) <= 1e-2
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-2)


@pytest.mark.parametrize('use_ccs_bq', [False, True])
def test_k4_plain_with_bf16_softmax_matches_interpret_kernel(use_ccs_bq):
  params = jax_config.get_config(
      'transformer_learn_values+' + ('test_bq' if use_ccs_bq else 'test'))
  jax_config.finalize_params(params, max_length=200)
  rng = np.random.default_rng(5)
  rows, tables, weights, pos, specs, keys = k1_inputs(
      rng, params, len(SLOT_LENGTHS), 200)
  valid = rwa.slot_geometry(torch.from_numpy(SLOT_LENGTHS), 200)[3].numpy()
  rows = rows * valid[:, None, :]
  kw = dict(specs=specs, table_keys=keys, num_heads=HEADS,
            attn_win_size=BAND, softmax_dtype='bfloat16')
  got = rwa.ragged_embed_condense_attention(
      torch.from_numpy(rows), torch.from_numpy(SLOT_LENGTHS),
      {k: torch.from_numpy(v) for k, v in tables.items()},
      *map(torch.from_numpy, weights), torch.from_numpy(pos), **kw)
  want = jax_rwa.ragged_embed_condense_attention(
      jnp.asarray(rows), jnp.asarray(SLOT_LENGTHS),
      {k: jnp.asarray(v) for k, v in tables.items()},
      *map(jnp.asarray, weights), jnp.asarray(pos), **kw, interpret=True)
  for name, g, w in zip(('x_base', 'attn_out'), got, want):
    assert report(f'K4 {name}', g.numpy(), w) <= 1e-2
    np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-2)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_module_and_fused_routes_match_flax_jit(dtype):
  """The port's module route and its fused route (the plain versions) vs
  the Flax model's jitted apply (module route), with the bfloat16
  softmax; 2 layers, L = 100."""
  overrides = dict(dtype=dtype, num_hidden_layers=2, filter_size=64,
                   attn_softmax_dtype='bfloat16')
  jparams = jax_config.get_config('transformer_learn_values+test')
  jax_config.finalize_params(jparams, max_length=100, is_training=False)
  with jparams.unlocked():
    jparams.update(overrides)
  rng = np.random.default_rng(6)
  rows = k1_inputs(rng, jparams, 4, 100)[0][..., None]
  model = jax_model.get_model(jparams)
  tree = jax.device_get(model.init(jax.random.PRNGKey(0),
                                   jnp.asarray(rows))['params'])
  for layer in range(2):
    for wrap in ('attention_wrapper', 'ffn_wrapper'):
      tree['encoder'][f'{wrap}_{layer}']['alpha'] = np.float32(
          rng.uniform(0.5, 1.0))
  want = np.asarray(jax.jit(model.apply)({'params': tree},
                                         jnp.asarray(rows)))
  for fused in (False, True):
    params = torch_config.get_config('transformer_learn_values+test')
    torch_config.finalize_params(params, max_length=100)
    params.update({**overrides, 'use_fused_hotpath': fused})
    port = torch_model.DeepConsensusModel(params, device='cpu')
    port.load_state_dict(weights_lib.from_flax_params(tree, params))
    got = port(torch.from_numpy(rows)).numpy()
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    report(f'model fused={fused} {dtype} (argmax agreement {agree})', got,
           want)
    np.testing.assert_allclose(got, want, atol=0.02)
    # The reference's bar in float32; bfloat16 activations (a bf16
    # forward on both sides, rounded at other places) take the port's
    # bf16 bar, ids agreeing on >= 99% (PERF.md).
    assert agree > 0.999 if dtype == 'float32' else agree >= 0.99


def bf16_pieces(x: torch.Tensor, n: int):
  """x float32 as n bf16 pieces (float32 tensors) summing to x."""
  out = []
  for _ in range(n):
    p = x.to(BF16).float()
    out.append(p)
    x = x - p
  return out


def piece_matmul(a, b, na, nb):
  """a @ b as the tensor cores form it from split operands: the piece
  products p + q < max(na, nb), exact, summed in float64."""
  pa, pb = bf16_pieces(a, na), bf16_pieces(b, nb)
  acc = 0
  for i in range(na):
    for j in range(nb):
      if i + j < max(na, nb):
        acc = acc + pa[i].double() @ pb[j].double()
  return acc.float()


def emulate_core(qkv, length, win, mask, softmax_dtype):
  """csrc/ragged_attention.cu's arithmetic on qkv [L, 3H] (q scaled):
  S from 3 x 3 pieces; the softmax on S with masked logits dropped;
  numerators bf16 (1 piece) or float32 (3 pieces) times v in 3 pieces;
  then one division by z per output element; rows without keys 0."""
  bf = softmax_dtype == BF16
  q, k, v = (t.reshape(length, HEADS, HEAD_DIM).permute(1, 0, 2)
             for t in qkv.split(HIDDEN, dim=1))
  s = piece_matmul(q, k.transpose(1, 2), 3, 3)
  if bf:
    s = s.to(BF16).float()
  s = torch.where(mask, s, torch.full((), -float('inf')))
  m = s.amax(-1, keepdim=True)
  d = torch.where(mask, s - m, torch.zeros(()))
  e = torch.exp(d.to(BF16).float() if bf else d)
  e = torch.where(mask, e, torch.zeros(()))
  z = e.sum(-1, keepdim=True)
  if bf:
    z, e = z.to(BF16).float(), e.to(BF16).float()
  o = piece_matmul(e, v, 1 if bf else 3, 3)
  o = torch.where(z > 0, o / torch.where(z > 0, z, torch.ones(())),
                  torch.zeros(()))
  return o.permute(1, 0, 2).reshape(length, HIDDEN)


@pytest.mark.parametrize('softmax_dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('case', ['L100_band', 'L100_no_band',
                                  'L200_ragged'])
def test_core_emulation_matches_reference(softmax_dtype, case):
  """The reference's `_attention` on one-hot positions (so its q/k/v are
  the weights' rows and its output projection the identity) vs the
  emulated core, on every position a window holds; the same inputs
  through the port's attention_core_plain as well."""
  length = 200 if case == 'L200_ragged' else 100
  win = None if case == 'L100_no_band' else BAND
  rng = np.random.default_rng(7)
  ws = [rng.normal(0, 1, (HIDDEN, HIDDEN)).astype(np.float32)
        for _ in range(3)]
  ws.append(np.eye(HIDDEN, dtype=np.float32))
  lengths = SLOT_LENGTHS if case == 'L200_ragged' else np.full(
      (1, 1), length, np.int32)
  x = np.zeros((len(lengths), length, HIDDEN), np.float32)
  x[:, np.arange(length), np.arange(length)] = 1.0
  jmask = (jax_rwa.ragged_attention_mask(jnp.asarray(lengths), length, win)
           if case == 'L200_ragged' else None)
  attend = jax.jit(functools.partial(
      jax_feb._attention, num_heads=HEADS, qscale=HEAD_DIM ** -0.5,
      attn_win_size=win, length=length,
      softmax_dtype=jnp.dtype(softmax_dtype), mask=jmask))
  want = np.asarray(attend(jnp.asarray(x),
                           *[(jnp.asarray(w), None) for w in ws]))
  sdt = fwa.resolve_softmax_dtype(softmax_dtype)
  qkv = torch.cat([torch.from_numpy(ws[0][:length]) * (HEAD_DIM ** -0.5),
                   torch.from_numpy(ws[1][:length]),
                   torch.from_numpy(ws[2][:length])], dim=1)
  mask = rwa.ragged_attention_mask(torch.from_numpy(lengths), length, win)
  _, _, _, valid = rwa.slot_geometry(torch.from_numpy(lengths), length)
  for b in range(len(lengths)):
    got = emulate_core(qkv, length, win, mask[b], sdt).numpy()
    keep = valid[b].numpy()
    if not keep.any():  # an empty slot: no position to deliver
      continue
    plain = fwa.attention_core_plain(
        qkv, batch=1, length=length, num_heads=HEADS, attn_win_size=win,
        mask=mask[b:b + 1], softmax_dtype=sdt).numpy()
    for ref in (want[b], plain):
      err = report(f'core {case} {softmax_dtype} slot {b}', got[keep],
                   ref[keep])
      if sdt == torch.float32:
        assert err <= 1e-5
        continue
      # bf16(s) and bf16(sum e) amplify the float32 rounding of another
      # summation order: a logit or a row's z on a bf16 rounding edge
      # moves one bf16 step. Those elements stay within the variant's
      # bf16 tolerance; all others within float32's.
      far = np.abs(got[keep] - ref[keep]) > 1e-5
      print(f'  share beyond 1e-5: {far.mean():.3g}')
      assert err <= 2e-2 and far.mean() <= 0.01


def test_cli_train_and_run_with_bf16_softmax_on_cpu(tmp_path):
  """`cli train --set attn_softmax_dtype=bfloat16` (module route, 3
  steps), then `cli run` over the params.json it wrote (the fused route
  through the plain versions): the lever survives in params.json and
  both finish with finite losses and one read per ZMW."""
  for split, n, seed in (('train', 24, 3), ('eval', 8, 4)):
    synthetic.write_synthetic_tfrecords(
        str(tmp_path / split), n_shards=1, n_examples=n, max_passes=20,
        max_length=100, seed=seed)
  out = str(tmp_path / 'model')
  assert cli.main([
      'train', '--out_dir', out, '--train_path', str(tmp_path / 'train/*'),
      '--eval_path', str(tmp_path / 'eval/*'), '--device', 'cpu',
      '--num_epochs', '1', '--batch_size', '8', '--set',
      'num_hidden_layers=2', '--set', 'filter_size=64', '--set',
      'dtype=float32', '--set', 'log_every_n_steps=1', '--set',
      'attn_softmax_dtype=bfloat16']) == 0
  assert torch_config.read_params_from_json(out)[
      'attn_softmax_dtype'] == 'bfloat16'
  with open(os.path.join(out, 'metrics.jsonl')) as f:
    train = [e for e in map(json.loads, f) if e['split'] == 'train']
  assert len(train) == 3 and all(
      np.isfinite(e['loss']) and np.isfinite(e['grad_norm']) for e in train)
  bams = synthetic.write_synthetic_zmw_bams(
      str(tmp_path / 'bams'), n_zmws=3, n_subreads=4, seq_len=260, seed=11)
  fastq = str(tmp_path / 'out.fastq')
  assert cli.main([
      'run', '--subreads_to_ccs', bams[0], '--ccs_bam', bams[1],
      '--weights', os.path.join(out, 'weights.npz'), '--params',
      os.path.join(out, 'params.json'), '--output', fastq, '--batch_size',
      '8', '--min_quality', '0', '--skip_windows_above', '0', '--device',
      'cpu']) == 0
  with open(fastq) as f:
    assert len(f.read().splitlines()) == 4 * 3
