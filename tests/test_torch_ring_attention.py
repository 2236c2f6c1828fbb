"""The port's ring route (long windows) vs the JAX package's.

At L >= RING_ATTENTION_MIN_LEN (256) without attention dropout the
reference's BandedSelfAttention runs the blockwise ring scan
(parallel/ring_attention.py::ring_attention_blockwise) before it looks
at use_pallas_attention; the port routes the same way. Inputs come from
numpy seeds. Tolerances, float32:

* ring_attention_blockwise vs the reference's at L = 500 and 256,
  banded and unbanded, 2-3 heads of width 8: outputs and q/k/v
  gradients atol 1e-5; vs one softmax over the whole band, in float64:
  outputs and gradients atol 1e-12 (the routes differ by rounding only);
* the port's model (2 layers, hidden 16, band 12) vs the Flax model on
  the same weights at L = 256 and 300, no dropout: forward_train and
  the inference forward (encode) atol 1e-5.

JAX runs on the CPU; no JAX state is changed.
"""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepconsensus_tpu.models import config as jax_config
from deepconsensus_tpu.models import model as jax_model
from deepconsensus_tpu.parallel import ring_attention as jax_ring
from deepconsensus_tpu_torch.models import config as torch_config
from deepconsensus_tpu_torch.models import model as torch_model
from deepconsensus_tpu_torch.models import weights as weights_lib
from deepconsensus_tpu_torch.ops import banded_attention as ba
from deepconsensus_tpu_torch.parallel import ring_attention

MAX_PASSES, HIDDEN = 5, 16
SMALL = dict(dtype='float32', num_hidden_layers=2, filter_size=32)
NO_DROPOUT = dict(attention_dropout=0.0, relu_dropout=0.0,
                  layer_postprocess_dropout=0.0)


@pytest.fixture(autouse=True)
def one_torch_thread():
  """One intra-op thread per test (the other files' workers share the
  machine), restored afterwards."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def test_constants_match_the_reference():
  assert torch_config.RING_ATTENTION_MIN_LEN == (
      jax_config.RING_ATTENTION_MIN_LEN) == 256
  assert torch_config.LONG_INSERT_WINDOW_LEN == (
      jax_config.LONG_INSERT_WINDOW_LEN) == 500


# ---------------------------------------------------------------------------
# ring_attention_blockwise alone.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('win', [12, None])
@pytest.mark.parametrize('b,length,heads', [(2, 500, 2), (1, 256, 3)])
def test_blockwise_matches_reference(b, length, heads, win):
  """Forward and q/k/v gradients (unscaled query, as both take it)."""
  rng = np.random.default_rng(length + heads)
  q, k, v, do = (rng.normal(size=(b, length, heads, 8)).astype(np.float32)
                 for _ in range(4))
  want, vjp = jax.vjp(
      lambda a, c, e: jax_ring.ring_attention_blockwise(a, c, e, win),
      jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
  ins = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
  before = ring_attention.n_calls
  got = ring_attention.ring_attention_blockwise(*ins, win)
  assert ring_attention.n_calls == before + 1
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                             atol=1e-5)
  got.backward(torch.from_numpy(do))
  for g, w, name in zip(ins, vjp(jnp.asarray(do)), 'qkv'):
    np.testing.assert_allclose(g.grad.numpy(), np.asarray(w), atol=1e-5,
                               err_msg=f'd{name}')


def test_blockwise_matches_full_attention_and_keeps_the_dtype():
  """The ring scan is exact: it equals one softmax over the whole band
  (the module route's arithmetic); in bfloat16 its running state stays
  bfloat16, as the reference's does."""
  rng = np.random.default_rng(9)
  q, k, v = (torch.from_numpy(rng.normal(size=(2, 300, 2, 8))
                              .astype(np.float32)) for _ in range(3))
  got = ring_attention.ring_attention_blockwise(q, k, v, 12, block_size=64)
  i = torch.arange(300)
  band = (i[:, None] - i[None, :]).abs() <= 12
  logits = torch.einsum('bqhd,bkhd->bhqk', q * 8 ** -0.5, k)
  weights = torch.softmax(torch.where(band, logits, torch.tensor(-1e9)), -1)
  want = torch.einsum('bhqk,bkhd->bqhd', weights, v)
  np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
  half = ring_attention.ring_attention_blockwise(
      q.bfloat16(), k.bfloat16(), v.bfloat16(), 12)
  assert half.dtype == torch.bfloat16
  np.testing.assert_allclose(half.float().numpy(), want.numpy(), atol=0.1)


def test_blockwise_gradients_are_exact_in_float64():
  """The ring scan and one softmax over the whole band have the same
  gradients in exact arithmetic: in float64 they agree to 1e-12 at
  L = 500, so what differs between the routes in float32 is rounding."""
  rng = np.random.default_rng(10)
  q, k, v, do = (torch.from_numpy(rng.normal(size=(1, 500, 2, 8)))
                 for _ in range(4))
  i = torch.arange(500)
  band = (i[:, None] - i[None, :]).abs() <= 12

  def full(a, b, c):
    logits = torch.einsum('bqhd,bkhd->bhqk', a * 8 ** -0.5, b)
    weights = torch.softmax(torch.where(band, logits,
                                        torch.tensor(-1e9).double()), -1)
    return torch.einsum('bhqk,bkhd->bqhd', weights, c)

  grads = []
  for fn in (full, lambda a, b, c: ring_attention.ring_attention_blockwise(
      a, b, c, 12)):
    ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = fn(*ins)
    out.backward(do)
    grads.append([out.detach()] + [x.grad for x in ins])
  for g, w in zip(*grads):
    np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-12)


# ---------------------------------------------------------------------------
# The model at long windows.
# ---------------------------------------------------------------------------


def jax_params(length, **overrides):
  params = jax_config.get_config('transformer_learn_values+test')
  with params.unlocked():
    params.max_passes = MAX_PASSES
    params.transformer_input_size = HIDDEN
  jax_config.finalize_params(params, max_length=length, is_training=False)
  with params.unlocked():
    for key, value in {**SMALL, **overrides}.items():
      params[key] = value
  return params


def torch_params(length, **overrides):
  params = torch_config.get_config('transformer_learn_values+custom')
  params.max_passes = MAX_PASSES
  params.transformer_input_size = HIDDEN
  torch_config.finalize_params(params, max_length=length)
  params.update({**SMALL, **overrides})
  return params


def fake_rows(batch, length, seed):
  rng = np.random.default_rng(seed)
  mp = MAX_PASSES
  rows = np.zeros((batch, 4 * mp + 5, length, 1), np.float32)
  rows[:, :mp] = rng.integers(0, 5, rows[:, :mp].shape)
  rows[:, mp:3 * mp] = rng.integers(0, 256, rows[:, mp:3 * mp].shape)
  rows[:, 3 * mp:4 * mp] = rng.integers(0, 3, rows[:, :mp].shape)
  rows[:, 4 * mp] = rng.integers(0, 5, rows[:, 4 * mp].shape)
  rows[:, 4 * mp + 1:] = rng.integers(0, 501, rows[:, 4 * mp + 1:].shape)
  return rows


@pytest.fixture(scope='module')
def flax_params():
  """A Flax init at hidden 16, every ReZero alpha non-zero from a numpy
  seed so attention reaches the output."""
  params = jax_params(256)
  variables = jax.jit(jax_model.get_model(params).init)(
      jax.random.PRNGKey(0), jnp.asarray(fake_rows(1, 256, 0)))
  flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(variables))
  rng = np.random.default_rng(3)
  for key in flat:
    if key[-1] == 'alpha':
      flat[key] = jnp.asarray(rng.uniform(0.5, 1.0), jnp.float32)
  return jax.device_get(flax.traverse_util.unflatten_dict(flat))['params']


def port_model(tree, length, **overrides):
  params = torch_params(length, **overrides)
  assert params.hidden_size == HIDDEN
  model = torch_model.DeepConsensusModel(params, device='cpu')
  model.load_state_dict(weights_lib.from_flax_params(tree, params))
  return model


@pytest.mark.parametrize('length', [256, 300])
def test_model_matches_flax_at_long_windows(flax_params, length):
  """forward_train without a generator, forward_train with every
  dropout rate 0, and the inference forward (encode's module route),
  all through the ring route, vs the Flax model's train and eval
  applies."""
  rows = fake_rows(2, length, seed=length)
  jax_model_ = jax_model.get_model(jax_params(length, **NO_DROPOUT))
  want_eval = np.asarray(jax_model_.apply({'params': flax_params},
                                          jnp.asarray(rows)))
  want_train = np.asarray(jax_model_.apply(
      {'params': flax_params}, jnp.asarray(rows), train=True,
      rngs={'dropout': jax.random.PRNGKey(1)}))
  model = port_model(flax_params, length, **NO_DROPOUT)
  before = ring_attention.n_calls
  with torch.no_grad():
    got_eval = model.forward_train(torch.from_numpy(rows)).numpy()
    got_train = model.forward_train(torch.from_numpy(rows),
                                    torch.Generator()).numpy()
    got_encode = model(torch.from_numpy(rows)).numpy()
  assert ring_attention.n_calls == before + 3 * 2  # 2 layers, 3 forwards
  np.testing.assert_allclose(got_eval, want_eval, atol=1e-5)
  np.testing.assert_allclose(got_train, want_train, atol=1e-5)
  np.testing.assert_allclose(got_encode, want_eval, atol=1e-5)


@pytest.fixture
def plain_attention_calls(monkeypatch):
  """Counts the banded-attention kernels' plain versions (the CPU side
  of K5-K7)."""
  calls = {'n': 0}
  for name in ('banded_attention_plain', 'banded_attention_dropout_plain'):
    fn = getattr(ba, name)

    def counted(*args, _fn=fn, **kwargs):
      calls['n'] += 1
      return _fn(*args, **kwargs)

    monkeypatch.setattr(ba, name, counted)
  return calls


@pytest.mark.parametrize('flag', [False, True])
def test_long_windows_take_the_ring_route(flax_params, plain_attention_calls,
                                          flag):
  """L = 256 and 300 without attention dropout (the other dropouts on):
  the ring route, with and without use_pallas_attention, the same
  numbers either way; K5-K7 are not reached."""
  for length in (256, 300):
    rows = torch.from_numpy(fake_rows(2, length, seed=7))
    outs = []
    for use_flag in (flag, not flag):
      model = port_model(flax_params, length, attention_dropout=0.0,
                         use_pallas_attention=use_flag)
      before = ring_attention.n_calls
      with torch.no_grad():
        outs.append(model.forward_train(rows, torch.Generator().manual_seed(2)))
      assert ring_attention.n_calls == before + 2
    assert torch.equal(outs[0], outs[1])
  assert plain_attention_calls['n'] == 0


def test_flag_below_the_ring_route_still_raises(flax_params, monkeypatch):
  """128 < L < 256 with use_pallas_attention and no attention dropout
  takes the block-banded flash kernels (K8-K10; on the CPU K8's plain
  version, once per layer), not the ring route: the Flax model's
  numbers with the flag, atol 1e-5."""
  from deepconsensus_tpu_torch.ops import flash_band_attention as fba

  calls = {'n': 0}
  real = fba.flash_band_attention_plain

  def counted(*args, **kwargs):
    calls['n'] += 1
    return real(*args, **kwargs)

  monkeypatch.setattr(fba, 'flash_band_attention_plain', counted)
  model = port_model(flax_params, 200, attention_dropout=0.0,
                     use_pallas_attention=True)
  rows = fake_rows(1, 200, seed=8)
  want = np.asarray(jax_model.get_model(jax_params(
      200, use_pallas_attention=True, **NO_DROPOUT)).apply(
          {'params': flax_params}, jnp.asarray(rows)))
  before = ring_attention.n_calls
  with torch.no_grad():
    got = model.forward_train(torch.from_numpy(rows))
    model.forward_train(torch.from_numpy(rows), torch.Generator())
  assert ring_attention.n_calls == before
  assert calls['n'] == 2 * 2  # 2 layers, 2 forwards
  np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize('flag', [False, True])
def test_attention_dropout_at_long_windows_takes_the_module_route(
    flax_params, plain_attention_calls, flag):
  """L = 300 with attention dropout: the module route (the ring scan
  holds no weights to drop), with or without the flag, the same numbers
  from the same generator."""
  rows = torch.from_numpy(fake_rows(2, 300, seed=9))
  before = ring_attention.n_calls
  with torch.no_grad():
    got = port_model(flax_params, 300, use_pallas_attention=flag
                     ).forward_train(rows, torch.Generator().manual_seed(4))
    want = port_model(flax_params, 300).forward_train(
        rows, torch.Generator().manual_seed(4))
  assert ring_attention.n_calls == before
  assert plain_attention_calls['n'] == 0
  assert torch.equal(got, want)
  assert torch.isfinite(got).all()
