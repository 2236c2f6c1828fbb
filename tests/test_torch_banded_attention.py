"""The port's banded-attention training kernels (K5-K7) vs the JAX package.

On the CPU the wrappers in deepconsensus_tpu_torch/ops/banded_attention.py
run their plain versions; the JAX side runs its Pallas kernels in
interpret mode, as tests/test_banded_attention_kernel.py does. Inputs
come from numpy seeds; q is scaled by D^-1/2 as the model scales it.
Tolerances:

* K5's plain version vs `banded_attention(interpret=True)` and
  `reference_banded_attention`: atol 2e-5, rtol 1e-5 (the JAX package's
  own test of its kernel);
* K7 forward and K6 with and without a mask vs jax.vjp through
  `banded_attention_dropout_vjp` / `banded_attention_vjp` (interpret),
  same mask and cotangent, float32: atol 1e-5 (sums in another order);
* the autograd Functions vs torch.autograd through the plain forward:
  atol 1e-5;
* `forward_train` with use_pallas_attention and no dropout vs the JAX
  model.apply with use_pallas_attention=True: predictions atol 1e-5,
  loss rtol 1e-5, every leaf's gradient rtol 1e-4, atol 1e-5, and one
  full train step vs a JAX step: loss rtol 1e-5, parameters atol 1e-5
  (the tolerances of tests/test_torch_train.py's forward and one-step
  tests, with its loss_reg 1.0 and epsilon 1e-3 for the same reasons);
* kernel route vs module route with dropout on, one seeded generator
  each: atol 1e-5 (the same masks; only rounding differs).

JAX runs on the CPU; no JAX state is changed.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepconsensus_tpu.models import config as jax_config
from deepconsensus_tpu.models import losses as jax_losses
from deepconsensus_tpu.models import model as jax_model
from deepconsensus_tpu.models import train as jax_train
from deepconsensus_tpu.ops import banded_attention as jax_ba
from deepconsensus_tpu_torch.models import config as torch_config
from deepconsensus_tpu_torch.models import losses as torch_losses
from deepconsensus_tpu_torch.models import model as torch_model
from deepconsensus_tpu_torch.models import train as torch_train
from deepconsensus_tpu_torch.models import weights as weights_lib
from deepconsensus_tpu_torch.ops import banded_attention as ba
from deepconsensus_tpu_torch.testing import synthetic

SMALL = dict(dtype='float32', num_hidden_layers=2, filter_size=64)
NO_DROPOUT = dict(attention_dropout=0.0, relu_dropout=0.0,
                  layer_postprocess_dropout=0.0)
MAX_PASSES, LENGTH, BATCH = 5, 20, 4
KERNELS = ('banded_attention_plain', 'banded_attention_dropout_plain',
           'banded_attention_bwd_plain')


@pytest.fixture(autouse=True)
def one_torch_thread():
  """One intra-op thread per test (the other files' workers share the
  machine), restored afterwards."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def qkv(b, l, h, d, seed):
  rng = np.random.default_rng(seed)
  q, k, v, do = (rng.normal(size=(b, l, h, d)).astype(np.float32)
                 for _ in range(4))
  mask = (rng.random((b, h, l, l)) < 0.9).astype(np.uint8)
  return q * np.float32(d ** -0.5), k, v, do, mask


def t(x):
  return torch.from_numpy(x)


@pytest.fixture
def plain_calls(monkeypatch):
  """Counts the plain versions' calls (the CPU side of each kernel)."""
  calls = dict.fromkeys(KERNELS, 0)
  for name in KERNELS:
    fn = getattr(ba, name)

    def counted(*args, _fn=fn, _name=name, **kwargs):
      calls[_name] += 1
      return _fn(*args, **kwargs)

    monkeypatch.setattr(ba, name, counted)
  return calls


def launches():
  return (ba.n_fwd_launches, ba.n_dropout_fwd_launches, ba.n_bwd_launches)


# ---------------------------------------------------------------------------
# The kernels' plain versions vs the JAX package's kernels.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('length', [24, 100])
@pytest.mark.parametrize('win', [12, 6, None])
def test_k5_plain_matches_jax_kernel_and_reference(win, length):
  q, k, v, _, _ = qkv(2, length, 2, 40, seed=length)
  before = launches()
  got = ba.banded_attention(t(q), t(k), t(v), win).numpy()
  assert launches() == before  # a CPU tensor: the plain version
  jq, jk, jv = map(jnp.asarray, (q, k, v))
  for want in (jax_ba.banded_attention(jq, jk, jv, win, interpret=True),
               jax_ba.reference_banded_attention(jq, jk, jv, win)):
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5, rtol=1e-5)


# (win, length): the window of 30 and lengths across K6's 64-row blocks
# and 16-row chunks (65, 100, 128), with band 12, the diagonal alone and
# none. The cases at 30 keep their ids.
VJP_CASES = [(w, n) for n in (30, 65, 100, 128) for w in (12, 0, None)]


@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize(
    'win,length', VJP_CASES,
    ids=[str(w) if n == 30 else f'{w}-L{n}' for w, n in VJP_CASES])
def test_k7_and_k6_match_jax_vjp(win, length, masked):
  q, k, v, do, mask = qkv(2, length, 2, 24, seed=7)
  keep = 0.9
  jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
  if masked:
    want, vjp = jax.vjp(
        lambda a, b, c: jax_ba.banded_attention_dropout_vjp(
            a, b, c, jnp.asarray(mask), win, keep, True), jq, jk, jv)
    got = ba.banded_attention_dropout(t(q), t(k), t(v), t(mask), win, keep)
  else:
    want, vjp = jax.vjp(
        lambda a, b, c: jax_ba.banded_attention_vjp(a, b, c, win, True),
        jq, jk, jv)
    got = ba.banded_attention(t(q), t(k), t(v), win)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
  before = launches()
  grads = ba.banded_attention_bwd(t(q), t(k), t(v),
                                  t(mask) if masked else None, t(do), win,
                                  keep if masked else 1.0)
  assert launches() == before
  for g, w, name in zip(grads, vjp(jdo), ('dq', 'dk', 'dv')):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                               err_msg=name)


@pytest.mark.parametrize('b,l,h,d,win', [(2, 24, 2, 16, 12), (3, 17, 1, 8, 4),
                                         (1, 9, 2, 5, None)])
def test_autograd_functions_match_plain_autograd(b, l, h, d, win):
  """K6 (the Functions' backward) against torch.autograd through the
  plain forwards, with and without the mask."""
  q, k, v, do, mask = qkv(b, l, h, d, seed=b * l)
  for masked in (False, True):
    grads = []
    for fn in ((ba.banded_attention_dropout_vjp if masked
                else ba.banded_attention_vjp),
               (ba.banded_attention_dropout_plain if masked
                else ba.banded_attention_plain)):
      ins = [t(x).requires_grad_(True) for x in (q, k, v)]
      extra = (t(mask), win, 0.8) if masked else (win,)
      out = fn(*ins, *extra)
      out.backward(t(do))
      grads.append([out.detach()] + [x.grad for x in ins])
    for g, w in zip(*grads):
      np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5)


def test_wrappers_reject_what_the_kernels_do_not_take():
  q, k, v, do, mask = (t(x) for x in qkv(1, 8, 2, 4, seed=1))
  with pytest.raises(ValueError, match='one of'):
    ba.banded_attention(q.double(), k.double(), v.double(), 2)
  with pytest.raises(ValueError, match='contiguous'):
    ba.banded_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k,
                        v, 2)
  with pytest.raises(ValueError, match='k is torch.bfloat16'):
    ba.banded_attention(q, k.bfloat16(), v, 2)
  with pytest.raises(ValueError, match='mask must be uint8'):
    ba.banded_attention_dropout(q, k, v, mask.bool(), 2, 0.9)
  with pytest.raises(ValueError, match='mask shape'):
    ba.banded_attention_dropout(q, k, v, mask[:, :1].contiguous(), 2, 0.9)
  with pytest.raises(ValueError, match='keep_prob'):
    ba.banded_attention_bwd(q, k, v, mask, do, 2, 0.0)
  with pytest.raises(ValueError, match='do shape'):
    ba.banded_attention_bwd(q, k, v, None, do[:, :4], 2, 1.0)


# ---------------------------------------------------------------------------
# The model with use_pallas_attention.
# ---------------------------------------------------------------------------


def jax_params(**overrides):
  params = jax_config.get_config('transformer_learn_values+test')
  with params.unlocked():
    params.max_passes = MAX_PASSES
  jax_config.finalize_params(params, max_length=LENGTH, is_training=False)
  with params.unlocked():
    for key, value in {**SMALL, **overrides}.items():
      params[key] = value
  return params


def torch_params(**overrides):
  params = torch_config.get_config('transformer_learn_values+custom')
  params.max_passes = MAX_PASSES
  torch_config.finalize_params(params, max_length=LENGTH)
  params.update({**SMALL, **overrides})
  return params


def fake_rows(batch, seed, length=LENGTH):
  rng = np.random.default_rng(seed)
  mp = MAX_PASSES
  rows = np.zeros((batch, 4 * mp + 5, length, 1), np.float32)
  rows[:, :mp] = rng.integers(0, 5, rows[:, :mp].shape)
  rows[:, mp:3 * mp] = rng.integers(0, 256, rows[:, mp:3 * mp].shape)
  rows[:, 3 * mp:4 * mp] = rng.integers(0, 3, rows[:, :mp].shape)
  rows[:, 4 * mp] = rng.integers(0, 5, rows[:, 4 * mp].shape)
  rows[:, 4 * mp + 1:] = rng.integers(0, 501, rows[:, 4 * mp + 1:].shape)
  return rows


def gapped_labels(batch, seed):
  rng = np.random.default_rng(seed)
  label = rng.integers(1, 5, (batch, LENGTH))
  label[rng.random((batch, LENGTH)) < 0.2] = 0
  label[:, -3:] = 0
  return label.astype(np.float32)


@pytest.fixture(scope='module')
def flax_params():
  """A Flax init at the small size (flag off), every ReZero alpha
  non-zero from a numpy seed so gradients reach every branch."""
  import flax

  variables = jax.jit(jax_model.get_model(jax_params()).init)(
      jax.random.PRNGKey(0), jnp.asarray(fake_rows(1, 0)))
  flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(variables))
  rng = np.random.default_rng(3)
  for key in flat:
    if key[-1] == 'alpha':
      flat[key] = jnp.asarray(rng.uniform(0.5, 1.0), jnp.float32)
  return jax.device_get(flax.traverse_util.unflatten_dict(flat))['params']


def port_model(tree, **overrides):
  params = torch_params(**overrides)
  model = torch_model.DeepConsensusModel(params, device='cpu')
  model.load_state_dict(weights_lib.from_flax_params(tree, params))
  return model.requires_grad_(True)


def jax_apply(tree, rows, **overrides):
  model = jax_model.get_model(jax_params(**overrides))
  return model.apply({'params': tree}, jnp.asarray(rows), train=True,
                     rngs={'dropout': jax.random.PRNGKey(1)})


def assert_tree_close(got, want, rtol, atol):
  got_flat = weights_lib.flatten_tree(got)
  want_flat = weights_lib.flatten_tree(want)
  assert got_flat.keys() == want_flat.keys()
  for key in want_flat:
    np.testing.assert_allclose(np.asarray(got_flat[key]),
                               np.asarray(want_flat[key]), rtol=rtol,
                               atol=atol, err_msg=key)


def test_flag_leaves_the_params_tree_unchanged(flax_params):
  """K5-K7 add no parameters: a JAX model built with the flag has the
  same tree, which loads into the port unchanged."""
  on = jax.jit(jax_model.get_model(
      jax_params(use_pallas_attention=True)).init)(
          jax.random.PRNGKey(0), jnp.asarray(fake_rows(1, 0)))['params']
  on_flat = weights_lib.flatten_tree(jax.device_get(on))
  off_flat = weights_lib.flatten_tree(flax_params)
  assert on_flat.keys() == off_flat.keys()
  assert all(np.shape(on_flat[k]) == np.shape(off_flat[k]) for k in on_flat)
  params = torch_params(use_pallas_attention=True)
  state = weights_lib.from_flax_params(jax.device_get(on), params)
  model = torch_model.DeepConsensusModel(params, device='cpu')
  model.load_state_dict(state)
  for name, p in model.state_dict().items():
    np.testing.assert_array_equal(
        p.numpy(), np.asarray(on_flat[name.replace('.', '/')]))


def test_training_forward_and_gradients_match_jax(flax_params, plain_calls):
  """Dropout off, so both models take K5 (interpret mode in JAX) and
  differentiate through K6. loss_reg 1.0: see
  tests/test_torch_train.py's forward test."""
  rows, label = fake_rows(BATCH, 1), gapped_labels(BATCH, 2)
  flag = dict(use_pallas_attention=True, **NO_DROPOUT)
  loss_jax = jax_losses.AlignmentLoss(del_cost=10.0, loss_reg=1.0)

  def jax_loss(p):
    preds = jax_apply(p, rows, **flag)
    return loss_jax(jnp.asarray(label), preds), preds

  (want_loss, want_preds), want_grads = jax.jit(jax.value_and_grad(
      jax_loss, has_aux=True))(flax_params)
  model = port_model(flax_params, **flag)
  preds = model.forward_train(t(rows), torch.Generator())
  np.testing.assert_allclose(preds.detach().numpy(), np.asarray(want_preds),
                             atol=1e-5)
  loss = torch_losses.AlignmentLoss(del_cost=10.0, loss_reg=1.0)(
      t(label), preds)
  loss.backward()
  np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
  assert_tree_close(weights_lib.gradients_to_flax(model),
                    jax.device_get(want_grads), rtol=1e-4, atol=1e-5)
  assert plain_calls == {'banded_attention_plain': 2,
                         'banded_attention_dropout_plain': 0,
                         'banded_attention_bwd_plain': 2}


def test_one_train_step_matches_jax(flax_params):
  """One full float32 step with the flag, dropout off (epsilon 1e-3:
  see tests/test_torch_train.py's one-step test)."""
  rows, label = fake_rows(BATCH, 11), gapped_labels(BATCH, 12)
  step_cfg = dict(warmup_steps=2, epsilon=1e-3, use_pallas_attention=True,
                  **NO_DROPOUT)
  jparams = jax_params(**step_cfg)
  loss_jax = jax_train.make_loss(jparams)
  tx = jax_train.create_optimizer(jparams, 10)

  @jax.jit
  def jax_step(p):
    loss, grads = jax.value_and_grad(lambda w: loss_jax(
        jnp.asarray(label), jax_apply(w, rows, **step_cfg)))(p)
    updates, _ = tx.update(grads, tx.init(p), p)
    return loss, optax.apply_updates(p, updates)

  want_loss, want_params = jax.device_get(jax_step(flax_params))
  params = torch_params(**step_cfg)
  model = port_model(flax_params, **step_cfg)
  lamb = torch_train.Lamb(model.named_parameters(), params, 10)
  batch = torch_train.batch_to_device({'rows': rows, 'label': label}, 'cpu')
  metrics = torch_train.train_step(model, lamb, torch_train.make_loss(params),
                                   batch, torch.Generator())
  np.testing.assert_allclose(float(metrics['loss']), float(want_loss),
                             rtol=1e-5)
  assert_tree_close(weights_lib.to_flax_params(model.state_dict()),
                    want_params, rtol=0, atol=1e-5)


def test_dropout_kernel_route_matches_module_route(flax_params, plain_calls):
  """The config's dropout rates (0.1 each) on one seeded generator per
  route: the kernel route draws its keep-mask where the module route's
  Dropout draws, so both apply the same masks."""
  rows = t(fake_rows(BATCH, 5))
  results = []
  for flag in (True, False):
    model = port_model(flax_params, use_pallas_attention=flag)
    gen = torch.Generator().manual_seed(17)
    preds = model.forward_train(rows, gen)
    (preds * torch.linspace(0, 1, preds.shape[-1])).sum().backward()
    results.append((preds.detach(), weights_lib.gradients_to_flax(model),
                    gen.get_state()))
  (kp, kg, ks), (mp, mg, ms) = results
  assert torch.equal(ks, ms)  # the same number of draws
  np.testing.assert_allclose(kp.numpy(), mp.numpy(), atol=1e-5)
  assert_tree_close(kg, mg, rtol=1e-4, atol=1e-5)
  assert plain_calls == {'banded_attention_plain': 0,
                         'banded_attention_dropout_plain': 2,
                         'banded_attention_bwd_plain': 2}
  with torch.no_grad():  # and the masks are drawn: another seed differs
    other = port_model(flax_params, use_pallas_attention=True).forward_train(
        rows, torch.Generator().manual_seed(18))
  assert np.abs(other.numpy() - kp.numpy()).max() > 1e-3


def test_long_windows_route_as_the_reference(flax_params, plain_calls,
                                             monkeypatch):
  """L > WHOLE_L_LIMIT: with attention dropout the module route (the
  same numbers as the flag off), without it the block-banded flash
  kernels (K8's plain version once per layer, within atol 1e-5 of the
  flag-off numbers)."""
  from deepconsensus_tpu_torch.ops import flash_band_attention as fba

  flash = {'n': 0}
  real = fba.flash_band_attention_plain

  def counted(*args, **kwargs):
    flash['n'] += 1
    return real(*args, **kwargs)

  monkeypatch.setattr(fba, 'flash_band_attention_plain', counted)
  length = torch_config.WHOLE_L_LIMIT + 8
  rows = t(fake_rows(2, 6, length=length))
  with torch.no_grad():
    got = port_model(flax_params, use_pallas_attention=True).forward_train(
        rows, torch.Generator().manual_seed(3))
    want = port_model(flax_params).forward_train(
        rows, torch.Generator().manual_seed(3))
  assert torch.equal(got, want)
  assert sum(plain_calls.values()) == 0 and flash['n'] == 0
  model = port_model(flax_params, use_pallas_attention=True,
                     attention_dropout=0.0)
  module = port_model(flax_params, attention_dropout=0.0)
  with torch.no_grad():
    for gen in (lambda: torch.Generator().manual_seed(4), lambda: None):
      np.testing.assert_allclose(
          model.forward_train(rows, gen()).numpy(),
          module.forward_train(rows, gen()).numpy(), atol=1e-5)
  assert flash['n'] == 2 * 2  # 2 layers, 2 forwards (the second eval)
  assert sum(plain_calls.values()) == 0


def test_cli_train_with_the_flag_on_cpu(tmp_path, plain_calls):
  """`cli train --set use_pallas_attention=true`: 3 steps of 8 and one
  eval batch through the plain versions (no kernel launch on the CPU),
  and params.json keeps the flag."""
  from deepconsensus_tpu_torch import cli

  for split, n, seed in (('train', 24, 3), ('eval', 8, 4)):
    synthetic.write_synthetic_tfrecords(
        str(tmp_path / split), n_shards=1, n_examples=n, max_passes=20,
        max_length=100, seed=seed)
  out = str(tmp_path / 'model')
  before = launches()
  assert cli.main([
      'train', '--out_dir', out, '--train_path', str(tmp_path / 'train/*'),
      '--eval_path', str(tmp_path / 'eval/*'), '--device', 'cpu',
      '--num_epochs', '1', '--batch_size', '8', '--set',
      'num_hidden_layers=2', '--set', 'filter_size=64', '--set',
      'dtype=float32', '--set', 'log_every_n_steps=1', '--set',
      'use_pallas_attention=true']) == 0
  assert launches() == before
  layers, steps, eval_batches = 2, 3, 1
  assert plain_calls == {
      'banded_attention_plain': layers * eval_batches,
      'banded_attention_dropout_plain': layers * steps,
      'banded_attention_bwd_plain': layers * steps}
  with open(os.path.join(out, 'params.json')) as f:
    assert json.load(f)['use_pallas_attention'] is True
  assert torch_config.read_params_from_json(out)['use_pallas_attention']
  with open(os.path.join(out, 'metrics.jsonl')) as f:
    train = [e for e in map(json.loads, f) if e['split'] == 'train']
  assert len(train) == steps
  assert all(np.isfinite(e['loss']) and np.isfinite(e['grad_norm'])
             for e in train)


def test_attention_dropout_rate_one_keeps_nothing(flax_params, plain_calls):
  """Rate 1.0: the module route's Dropout draws nothing and zeroes the
  weights; the kernel route's keep-mask keeps nothing (the reference's
  K7 would divide by keep_prob 0), so both give the same output."""
  rows = t(fake_rows(BATCH, 8))
  outs = []
  with torch.no_grad():
    for flag in (True, False):
      gen = torch.Generator().manual_seed(5)
      outs.append((port_model(flax_params, use_pallas_attention=flag,
                              attention_dropout=1.0).forward_train(rows, gen),
                   gen.get_state()))
  (kernel, ks), (module, ms) = outs
  assert torch.equal(ks, ms)
  np.testing.assert_allclose(kernel.numpy(), module.numpy(), atol=1e-6)
  assert plain_calls['banded_attention_dropout_plain'] == 2
