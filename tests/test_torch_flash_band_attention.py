"""The port's block-banded flash attention (K8-K10) vs the JAX package's.

On the CPU the wrappers in deepconsensus_tpu_torch/ops/flash_band_attention.py
run their plain versions; the JAX side runs its Pallas kernels in
interpret mode, as tests/test_banded_attention_kernel.py does. Inputs
come from numpy seeds; q is scaled by D^-1/2 as the model scales it.
Tolerances:

* K8's plain forward (o and lse) vs `_forward(..., interpret=True,
  emit_lse=True)` at the reference's own cases: float32 atol 1e-5 (sums
  in another order); bfloat16 o atol 1e-2 (an ulp of bfloat16 at |o| < 2:
  both round float32 sums of the same products), lse atol 1e-5;
* the gradients of `FlashBandAttention` (K8 with lse, K9, K10, through
  the plain versions) vs jax.vjp of `flash_band_attention_vjp(...,
  interpret=True)`: atol 1e-5;
* the model with use_pallas_attention at L = 200 vs the Flax model with
  the flag (eval apply): atol 1e-5, on the module route and with
  use_fused_hotpath (the fused route stops at 128 positions);
* one train step at L = 160 with the flag and attention dropout 0 vs a
  JAX step: loss rtol 1e-5, parameters atol 1e-5 (epsilon 1e-3: see
  tests/test_torch_train.py's one-step test);
* per-bucket `run_inference` (window_buckets (100, 200), smart windows,
  no ragged slots), flag on and off, vs the JAX package's
  `run_inference` on the same BAMs and bridged weights: the same reads,
  base ids identical, qualities within 1.

The kernels' own comparisons with these plain versions on the card are
in tests/test_torch_gpu.py and chip_smoke.py. JAX runs on the CPU; no
JAX state is changed.
"""
import json

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepconsensus_tpu.calibration import lib as jax_calibration
from deepconsensus_tpu.inference import runner as jax_runner
from deepconsensus_tpu.models import config as jax_config
from deepconsensus_tpu.models import model as jax_model
from deepconsensus_tpu.models import train as jax_train
from deepconsensus_tpu.ops import flash_band_attention as jax_fba
from deepconsensus_tpu_torch import cli
from deepconsensus_tpu_torch.inference import runner as torch_runner
from deepconsensus_tpu_torch.models import config as torch_config
from deepconsensus_tpu_torch.models import model as torch_model
from deepconsensus_tpu_torch.models import train as torch_train
from deepconsensus_tpu_torch.models import weights as weights_lib
from deepconsensus_tpu_torch.ops import banded_attention as ba
from deepconsensus_tpu_torch.ops import flash_band_attention as fba
from deepconsensus_tpu_torch.parallel import ring_attention
from deepconsensus_tpu_torch.testing import synthetic

HIDDEN = 16
SMALL = dict(dtype='float32', num_hidden_layers=2, filter_size=32)
NO_DROPOUT = dict(attention_dropout=0.0, relu_dropout=0.0,
                  layer_postprocess_dropout=0.0)
FLAG = dict(use_pallas_attention=True)
BUCKETS = (100, 200)
PLAIN = ('flash_band_attention_plain', 'flash_band_dq_plain',
         'flash_band_dkdv_plain', 'banded_attention_plain')


@pytest.fixture(autouse=True)
def one_torch_thread():
  """One intra-op thread per test (the other files' workers share the
  machine), restored afterwards."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.fixture
def plain_calls(monkeypatch):
  """Counts the plain versions' calls: K8-K10's, and K5's."""
  calls = dict.fromkeys(PLAIN, 0)
  for name in PLAIN:
    mod = ba if name == 'banded_attention_plain' else fba
    fn = getattr(mod, name)

    def counted(*args, _fn=fn, _name=name, **kwargs):
      calls[_name] += 1
      return _fn(*args, **kwargs)

    monkeypatch.setattr(mod, name, counted)
  return calls


def launches():
  return (fba.n_fwd_launches, fba.n_fwd_lse_launches, fba.n_dq_launches,
          fba.n_dkdv_launches)


def qkv(b, length, h, d, seed):
  rng = np.random.default_rng(seed)
  q, k, v, do = (rng.normal(size=(b, length, h, d)).astype(np.float32)
                 for _ in range(4))
  return q * np.float32(d ** -0.5), k, v, do


def t(x):
  return torch.from_numpy(x)


# ---------------------------------------------------------------------------
# The kernels' plain versions vs the JAX package's kernels.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('length,win', [(100, 12), (200, 12), (257, 30),
                                        (384, 130), (192, None), (200, 0),
                                        (129, 0), (191, 12), (200, 130),
                                        (255, None)])
def test_k8_plain_matches_jax_forward(length, win):
  """o and lse; at win 0 only the diagonal is valid, so o = v. The
  lengths and bands past the reference's own cases cross the CUDA
  kernels' tile edges (64-row blocks, 16-row chunks)."""
  q, k, v, _ = qkv(2, length, 2, 16, seed=length)
  before = launches()
  o, lse = fba.flash_band_attention(t(q), t(k), t(v), win, with_lse=True)
  assert launches() == before  # a CPU tensor: the plain version
  want_o, want_lse = jax_fba._forward(*map(jnp.asarray, (q, k, v)), win,
                                      True, emit_lse=True)
  want_lse = np.asarray(want_lse)  # [B*H, lq], lq = L padded to 128
  np.testing.assert_allclose(o.numpy(), np.asarray(want_o), atol=1e-5)
  np.testing.assert_allclose(lse.numpy(),
                             want_lse[:, :length].reshape(2, 2, length),
                             atol=1e-5)
  np.testing.assert_allclose(
      fba.flash_band_attention(t(q), t(k), t(v), win).numpy(), o.numpy(),
      rtol=0, atol=0)
  if win == 0:
    np.testing.assert_allclose(o.numpy(), v, atol=1e-6)


def test_k8_plain_matches_jax_forward_in_bfloat16():
  q, k, v, _ = qkv(2, 200, 2, 16, seed=5)
  o, lse = fba.flash_band_attention(
      *(t(x).bfloat16() for x in (q, k, v)), 12, with_lse=True)
  assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
  want_o, want_lse = jax_fba._forward(
      *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), 12, True,
      emit_lse=True)
  np.testing.assert_allclose(o.float().numpy(),
                             np.asarray(want_o, np.float32), atol=1e-2)
  np.testing.assert_allclose(
      lse.numpy(), np.asarray(want_lse)[:, :200].reshape(2, 2, 200),
      atol=1e-5)


@pytest.mark.parametrize('length,win', [(100, 12), (200, 12), (257, 30),
                                        (192, None), (129, 0), (191, 12),
                                        (200, 130), (255, None)])
def test_gradients_match_jax_vjp(length, win, plain_calls):
  """FlashBandAttention: K8 with lse forward, delta, K9 and K10."""
  q, k, v, do = qkv(2, length, 2, 16, seed=length + 1)
  want, vjp = jax.vjp(
      lambda a, b, c: jax_fba.flash_band_attention_vjp(a, b, c, win, True),
      *map(jnp.asarray, (q, k, v)))
  ins = [t(x).requires_grad_(True) for x in (q, k, v)]
  before = launches()
  got = fba.flash_band_attention_vjp(*ins, win)
  got.backward(t(do))
  assert launches() == before
  assert plain_calls == {'flash_band_attention_plain': 1,
                         'flash_band_dq_plain': 1, 'flash_band_dkdv_plain': 1,
                         'banded_attention_plain': 0}
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                             atol=1e-5)
  for g, w, name in zip(ins, vjp(jnp.asarray(do)), 'qkv'):
    np.testing.assert_allclose(g.grad.numpy(), np.asarray(w), atol=1e-5,
                               err_msg=f'd{name}')


def test_vjp_takes_the_forward_without_lse_when_no_gradient_is_wanted(
    monkeypatch):
  """As the reference's primal: K8 without lse under no_grad or with
  inputs that need no gradient, with lse (for K9/K10) otherwise."""
  with_lse = []
  real = fba.flash_band_attention_plain

  def recording(q, k, v, win, lse=False):
    with_lse.append(lse)
    return real(q, k, v, win, lse)

  monkeypatch.setattr(fba, 'flash_band_attention_plain', recording)
  q, k, v, _ = (t(x) for x in qkv(1, 140, 2, 8, seed=2))
  fba.flash_band_attention_vjp(q, k, v, 12)
  q.requires_grad_(True)
  with torch.no_grad():
    fba.flash_band_attention_vjp(q, k, v, 12)
  fba.flash_band_attention_vjp(q, k, v, 12)
  assert with_lse == [False, False, True]


def test_wrappers_reject_what_the_kernels_do_not_take():
  q, k, v, do = (t(x) for x in qkv(1, 8, 2, 4, seed=1))
  lse = torch.zeros(1, 2, 8)
  with pytest.raises(ValueError, match='one of'):
    fba.flash_band_attention(q.double(), k.double(), v.double(), 2)
  with pytest.raises(ValueError, match='contiguous'):
    fba.flash_band_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                             k, v, 2)
  with pytest.raises(ValueError, match='do shape'):
    fba.flash_band_dq(q, k, v, do[:, :4], lse, lse, 2)
  with pytest.raises(ValueError, match='lse must be float32'):
    fba.flash_band_dq(q, k, v, do, lse.double(), lse, 2)
  with pytest.raises(ValueError, match='delta shape'):
    fba.flash_band_dkdv(q, k, v, do, lse, lse[:, :1].contiguous(), 2)


# ---------------------------------------------------------------------------
# The model with use_pallas_attention past WHOLE_L_LIMIT.
# ---------------------------------------------------------------------------


def jax_params(length, **overrides):
  params = jax_config.get_config('transformer_learn_values+test')
  with params.unlocked():
    params.transformer_input_size = HIDDEN
  jax_config.finalize_params(params, max_length=length, is_training=False)
  with params.unlocked():
    for key, value in {**SMALL, **overrides}.items():
      params[key] = value
  return params


def torch_params(length, **overrides):
  params = torch_config.get_config('transformer_learn_values+test')
  params.transformer_input_size = HIDDEN
  torch_config.finalize_params(params, max_length=length)
  params.update({**SMALL, **overrides})
  return params


def fake_rows(params, batch, length, seed):
  rng = np.random.default_rng(seed)
  mp = params.max_passes
  rows = np.zeros((batch, params.total_rows, length, 1), np.float32)
  rows[:, :mp] = rng.integers(0, 5, rows[:, :mp].shape)
  rows[:, mp:3 * mp] = rng.integers(0, 256, rows[:, mp:3 * mp].shape)
  rows[:, 3 * mp:4 * mp] = rng.integers(0, 3, rows[:, :mp].shape)
  rows[:, 4 * mp] = rng.integers(0, 5, rows[:, 4 * mp].shape)
  rows[:, 4 * mp + 1:] = rng.integers(0, 501, rows[:, 4 * mp + 1:].shape)
  return rows


@pytest.fixture(scope='module')
def flax_params():
  """A Flax init at hidden 16 (2 heads of 8) with window_buckets (100,
  200), every ReZero alpha non-zero from a numpy seed so attention
  reaches the output."""
  params = jax_params(100, window_buckets=BUCKETS)
  variables = jax.jit(jax_model.get_model(params).init)(
      jax.random.PRNGKey(0), jnp.asarray(fake_rows(params, 1, 100, 0)))
  flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(variables))
  rng = np.random.default_rng(3)
  for key in flat:
    if key[-1] == 'alpha':
      flat[key] = jnp.asarray(rng.uniform(0.5, 1.0), jnp.float32)
  return jax.device_get(flax.traverse_util.unflatten_dict(flat))['params']


def port_model(tree, length, **overrides):
  params = torch_params(length, **overrides)
  model = torch_model.DeepConsensusModel(params, device='cpu')
  model.load_state_dict(weights_lib.from_flax_params(tree, params))
  return model


@pytest.mark.parametrize('fused', [False, True])
def test_model_with_the_flag_matches_flax_at_200(flax_params, plain_calls,
                                                 fused):
  """The inference forward at L = 200 with the flag: the encoder route
  (also with use_fused_hotpath, whose fused route stops at 128
  positions) through K8's plain version once per layer, vs the Flax
  model's eval apply with the flag (its K8 in interpret mode)."""
  rows = fake_rows(torch_params(200), 3, 200, seed=7)
  want = np.asarray(jax_model.get_model(jax_params(200, **FLAG)).apply(
      {'params': flax_params}, jnp.asarray(rows)))
  model = port_model(flax_params, 200, use_fused_hotpath=fused, **FLAG)
  assert not model.use_fused(torch.device('cpu'), 200)
  assert model.use_fused(torch.device('cpu'), 100) == fused
  got = model(t(rows)).numpy()
  np.testing.assert_allclose(got, want, atol=1e-5)
  assert plain_calls['flash_band_attention_plain'] == SMALL[
      'num_hidden_layers']
  assert model(t(rows), plain=True).numpy().tolist() == got.tolist()


def gapped_labels(batch, length, seed):
  rng = np.random.default_rng(seed)
  label = rng.integers(1, 5, (batch, length))
  label[rng.random((batch, length)) < 0.2] = 0
  label[:, -3:] = 0
  return label.astype(np.float32)


def test_one_train_step_at_160_matches_jax(flax_params, plain_calls):
  """One full float32 step at L = 160 with the flag and no dropout (as
  the reference's own test_model_trains_long_window_through_flash_vjp):
  K8 with lse, K9 and K10 in every layer."""
  length = 160
  step_cfg = dict(warmup_steps=2, epsilon=1e-3, **FLAG, **NO_DROPOUT)
  rows = fake_rows(torch_params(length), 2, length, seed=11)
  label = gapped_labels(2, length, seed=12)
  jparams = jax_params(length, **step_cfg)
  loss_jax = jax_train.make_loss(jparams)
  tx = jax_train.create_optimizer(jparams, 10)
  jmodel = jax_model.get_model(jparams)

  @jax.jit
  def jax_step(p):
    loss, grads = jax.value_and_grad(lambda w: loss_jax(
        jnp.asarray(label), jmodel.apply(
            {'params': w}, jnp.asarray(rows), train=True,
            rngs={'dropout': jax.random.PRNGKey(1)})))(p)
    updates, _ = tx.update(grads, tx.init(p), p)
    return loss, optax.apply_updates(p, updates)

  want_loss, want_params = jax.device_get(jax_step(flax_params))
  params = torch_params(length, **step_cfg)
  model = port_model(flax_params, length, **step_cfg).requires_grad_(True)
  lamb = torch_train.Lamb(model.named_parameters(), params, 10)
  batch = torch_train.batch_to_device({'rows': rows, 'label': label}, 'cpu')
  metrics = torch_train.train_step(model, lamb, torch_train.make_loss(params),
                                   batch, torch.Generator())
  layers = SMALL['num_hidden_layers']
  assert plain_calls == {'flash_band_attention_plain': layers,
                         'flash_band_dq_plain': layers,
                         'flash_band_dkdv_plain': layers,
                         'banded_attention_plain': 0}
  np.testing.assert_allclose(float(metrics['loss']), float(want_loss),
                             rtol=1e-5)
  got_flat = weights_lib.flatten_tree(
      weights_lib.to_flax_params(model.state_dict()))
  want_flat = weights_lib.flatten_tree(want_params)
  assert got_flat.keys() == want_flat.keys()
  for key in want_flat:
    np.testing.assert_allclose(np.asarray(got_flat[key]),
                               np.asarray(want_flat[key]), rtol=0,
                               atol=1e-5, err_msg=key)


def test_routes_around_whole_l_limit(flax_params, plain_calls):
  """L = 200 with the flag: K8 without dropout, the module route (the
  flag-off numbers) with it; L = 256: the ring route; L = 100: K5."""
  rows = t(fake_rows(torch_params(200), 2, 200, seed=8))
  with torch.no_grad():
    port_model(flax_params, 200, attention_dropout=0.0,
               **FLAG).forward_train(rows, torch.Generator())
    assert plain_calls['flash_band_attention_plain'] == 2
    got = port_model(flax_params, 200, **FLAG).forward_train(
        rows, torch.Generator().manual_seed(3))
    want = port_model(flax_params, 200).forward_train(
        rows, torch.Generator().manual_seed(3))
  assert torch.equal(got, want)
  assert plain_calls['flash_band_attention_plain'] == 2
  before = ring_attention.n_calls
  with torch.no_grad():
    port_model(flax_params, 256, attention_dropout=0.0, **FLAG).forward_train(
        t(fake_rows(torch_params(256), 1, 256, seed=9)))
    assert ring_attention.n_calls == before + 2
    port_model(flax_params, 100, attention_dropout=0.0, **FLAG).forward_train(
        t(fake_rows(torch_params(100), 1, 100, seed=10)))
  assert plain_calls == {'flash_band_attention_plain': 2,
                         'flash_band_dq_plain': 0, 'flash_band_dkdv_plain': 0,
                         'banded_attention_plain': 2}


# ---------------------------------------------------------------------------
# Per-bucket run_inference.
# ---------------------------------------------------------------------------


def read_fastq(path):
  with open(path, 'rb') as f:
    lines = f.read().split(b'\n')
  return [(lines[i], lines[i + 1], lines[i + 3])
          for i in range(0, len(lines) - 1, 4)]


RUN_KW = dict(batch_size=8, batch_zmws=4, min_quality=0,
              skip_windows_above=0, window_buckets=BUCKETS,
              use_ccs_smart_windows=True)


@pytest.fixture(scope='module')
def wl_bams(tmp_path_factory):
  return synthetic.write_synthetic_zmw_bams(
      str(tmp_path_factory.mktemp('wl_bams')), n_zmws=6, n_subreads=4,
      seq_len=420, seed=11, smart_windows=True)


@pytest.mark.parametrize('flag', [False, True])
def test_run_inference_per_bucket_matches_jax(wl_bams, flax_params,
                                              plain_calls, tmp_path, flag):
  """The 100 bucket through the fused route (use_fused_hotpath, plain
  K1-K3), the 200 bucket through the encoder (K8's plain version with
  the flag), vs the JAX package's per-bucket run (its fused kernels and
  K8 in interpret mode)."""
  overrides = dict(window_buckets=BUCKETS, use_fused_hotpath=True,
                   use_pallas_attention=flag)
  out = str(tmp_path / 'jax.fastq')
  opts = jax_runner.InferenceOptions(
      **RUN_KW, dc_calibration_values=jax_calibration.parse_calibration_string(
          'skip'))
  jax_runner.run_inference(
      wl_bams[0], wl_bams[1], None, out, options=opts,
      runner=jax_runner.ModelRunner(jax_params(100, **overrides),
                                    {'params': flax_params}, opts))
  want = read_fastq(out)
  params = torch_params(100, **overrides)
  runner = torch_runner.ModelRunner(
      params, weights_lib.from_flax_params(flax_params, params),
      torch_runner.InferenceOptions(**RUN_KW), device='cpu')
  out = str(tmp_path / 'port.fastq')
  counters = torch_runner.run_inference(wl_bams[0], wl_bams[1], out, runner)
  got = read_fastq(out)
  assert counters['success'] == len(got) == len(want) == 6
  assert counters['use_ragged_kernel'] == 0
  by_bucket = counters['n_windows_by_bucket']
  assert set(by_bucket) == set(BUCKETS) and min(by_bucket.values()) > 0
  packs = counters['n_model_packs_by_bucket']
  assert sum(packs.values()) == counters['n_model_packs']
  assert sum(counters['n_model_pad_rows_by_bucket'].values()) == (
      counters['n_model_pad_rows'])
  assert counters['n_model_pack_rows'] == sum(by_bucket.values())
  assert plain_calls['flash_band_attention_plain'] == (
      flag * SMALL['num_hidden_layers'] * packs[200])
  for (jn, js, jq), (tn, ts, tq) in zip(want, got):
    assert (jn, js) == (tn, ts)
    dq = np.abs(np.frombuffer(jq, np.uint8).astype(int)
                - np.frombuffer(tq, np.uint8).astype(int))
    assert dq.max() <= 1


def test_cli_run_per_bucket_on_cpu(wl_bams, flax_params, tmp_path):
  """`cli run --window_buckets 100,200` without --use_ragged_kernel:
  each bucket in its own packs of --batch_size."""
  params = torch_params(100, **FLAG)
  weights = str(tmp_path / 'w.npz')
  weights_lib.save_npz(weights, flax_params)
  params_json = str(tmp_path / 'params.json')
  with open(params_json, 'w') as f:
    json.dump(params.to_dict(), f)
  out = str(tmp_path / 'cli.fastq')
  assert cli.main([
      'run', '--subreads_to_ccs', wl_bams[0], '--ccs_bam', wl_bams[1],
      '--weights', weights, '--params', params_json, '--output', out,
      '--batch_size', '8', '--min_quality', '0', '--skip_windows_above',
      '0', '--device', 'cpu', '--use_ccs_smart_windows', '--window_buckets',
      '100,200']) == 0
  with open(out + '.inference.json') as f:
    counters = json.load(f)
  assert len(read_fastq(out)) == 6
  assert counters['window_buckets'] == list(BUCKETS)
  assert counters['use_ragged_kernel'] == 0
  assert set(counters['n_model_packs_by_bucket']) == {'100', '200'}
