"""The PyTorch port's `train` path vs the JAX package's.

Small size throughout: 2 layers, hidden 280, 2 heads, filter 64,
max_passes 5, windows of 20, batches of 4-8; inputs from numpy seeds.
What is held against JAX, with its tolerance:

* the plain alignment DP (the CPU side of K11) vs wavefront.alignment_scan
  and wavefront_pallas.alignment_scores(interpret=True): rtol 1e-5, atol
  1e-4, as tests/test_wavefront_pallas.py;
* its gradients (the CPU side of K12) vs jax.grad through
  alignment_scores_vjp(interpret=True): rtol 1e-4, atol 1e-5; both also
  at m = n = 1 and at 3 x 40 x 17 (lengths 0 and m);
* the plain banded DP (the CPU side of K13) vs
  wavefront.banded_alignment_scan and, at b = 3, m = 8, W = 2,
  banded_alignment_scores(interpret=True): rtol 1e-5, atol 1e-4; its
  gradients (K14's CPU side) vs jax.grad through
  banded_alignment_scores_vjp(interpret=True), and at a score on band
  row 1 vs jax.grad through the plain scan: rtol 1e-4, atol 1e-5;
* AlignmentLoss value (rtol 1e-5) and gradient wrt y_pred (rtol 1e-4),
  unbanded and with width 4; the substitution costs' label gather: its
  value rtol 1e-6, its gradient rtol 1e-4, atol 1e-6, and repeatable;
* the training forward with dropout 0 vs model.apply(train=True): atol
  1e-5, and its loss gradients leaf by leaf: rtol 1e-4, atol 1e-5;
  each dropout rate at 1.0 alone (both frameworks then drop everything):
  atol 1e-5;
* LAMB, its schedule and decay mask vs optax (params atol 1e-6), one
  full float32 train step (loss rtol 1e-5, params atol 1e-5);
* loader batches and synthetic shards: exact; with track_window_ids the
  batches' window ids equal the JAX loader's;
* params.remat: gradients and the dropout generator's state equal to
  those without it, with dropout on (f32 atol 1e-6);
* a bucketed pair of steps (widths 20 and 40, one LAMB state) vs two JAX
  steps: losses rtol 1e-5, parameters atol 1e-5;
* `cli train --window_buckets` in memory and streamed through two loader
  workers with augmentation and remat: one step geometry per bucket.

JAX runs on the CPU; no JAX state is changed (no Trainer is built).
"""
import json
import multiprocessing
import os

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepconsensus_tpu.models import config as jax_config
from deepconsensus_tpu.models import data as jax_data
from deepconsensus_tpu.models import losses as jax_losses
from deepconsensus_tpu.models import model as jax_model
from deepconsensus_tpu.models import train as jax_train
from deepconsensus_tpu.ops import wavefront as jax_wavefront
from deepconsensus_tpu.ops import wavefront_pallas
from deepconsensus_tpu_torch.models import config as torch_config
from deepconsensus_tpu_torch.models import data as torch_data
from deepconsensus_tpu_torch.models import losses as torch_losses
from deepconsensus_tpu_torch.models import model as torch_model
from deepconsensus_tpu_torch.models import train as torch_train
from deepconsensus_tpu_torch.models import weights as weights_lib
from deepconsensus_tpu_torch.ops import wavefront as torch_wavefront
from deepconsensus_tpu_torch.ops import wavefront_cuda
from deepconsensus_tpu_torch.testing import synthetic

SMALL = dict(dtype='float32', num_hidden_layers=2, filter_size=64)
NO_DROPOUT = dict(attention_dropout=0.0, relu_dropout=0.0,
                  layer_postprocess_dropout=0.0)
MAX_PASSES, LENGTH, BATCH = 5, 20, 4


def jax_params(**overrides):
  params = jax_config.get_config('transformer_learn_values+test')
  with params.unlocked():
    params.max_passes = MAX_PASSES
  jax_config.finalize_params(params, max_length=LENGTH, is_training=False)
  with params.unlocked():
    for k, v in {**SMALL, **overrides}.items():
      params[k] = v
  return params


def torch_params(**overrides):
  params = torch_config.get_config('transformer_learn_values+custom')
  params.max_passes = MAX_PASSES
  torch_config.finalize_params(params, max_length=LENGTH)
  params.update({**SMALL, **overrides})
  return params


def fake_rows(batch, seed):
  rng = np.random.default_rng(seed)
  mp = MAX_PASSES
  rows = np.zeros((batch, 4 * mp + 5, LENGTH, 1), np.float32)
  rows[:, :mp] = rng.integers(0, 5, rows[:, :mp].shape)
  rows[:, mp:3 * mp] = rng.integers(0, 256, rows[:, mp:3 * mp].shape)
  rows[:, 3 * mp:4 * mp] = rng.integers(0, 3, rows[:, :mp].shape)
  rows[:, 4 * mp] = rng.integers(0, 5, rows[:, 4 * mp].shape)
  rows[:, 4 * mp + 1:] = rng.integers(0, 501, rows[:, 4 * mp + 1:].shape)
  return rows


def gapped_labels(batch, seed):
  """Labels with interior gaps and a gapped tail."""
  rng = np.random.default_rng(seed)
  label = rng.integers(1, 5, (batch, LENGTH))
  label[rng.random((batch, LENGTH)) < 0.2] = 0
  label[:, -3:] = 0
  return label.astype(np.float32)


@pytest.fixture(autouse=True)
def one_torch_thread():
  """This file shares the machine with the other test files' workers;
  one intra-op thread keeps its small torch ops off their cores. The
  setting is restored after each test."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def flax_variables():
  """One Flax init at the small size, every ReZero alpha non-zero (from
  a numpy seed) so gradients reach every branch."""
  variables = jax.jit(jax_model.get_model(jax_params()).init)(
      jax.random.PRNGKey(0), jnp.asarray(fake_rows(1, 0)))
  flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(variables))
  rng = np.random.default_rng(3)
  for key in flat:
    if key[-1] == 'alpha':
      flat[key] = jnp.asarray(rng.uniform(0.5, 1.0), jnp.float32)
  return jax.device_get(flax.traverse_util.unflatten_dict(flat))


def port_model(flax_variables, **overrides):
  params = torch_params(**overrides)
  model = torch_model.DeepConsensusModel(params, device='cpu')
  model.load_state_dict(weights_lib.from_flax_params(
      flax_variables['params'], params))
  return model.requires_grad_(True)


def assert_tree_close(got, want, rtol, atol):
  got_flat = weights_lib.flatten_tree(got)
  want_flat = weights_lib.flatten_tree(want)
  assert got_flat.keys() == want_flat.keys()
  for key in want_flat:
    np.testing.assert_allclose(np.asarray(got_flat[key]),
                               np.asarray(want_flat[key]), rtol=rtol,
                               atol=atol, err_msg=key)


# ---------------------------------------------------------------------------
# The DP: K11's and K12's plain side.
# ---------------------------------------------------------------------------


def random_costs(seed, b, m, n):
  rng = np.random.default_rng(seed)
  subs = rng.uniform(0, 5, (b, m, n)).astype(np.float32)
  ins = rng.uniform(0, 5, (b, n)).astype(np.float32)
  lens = rng.integers(0, m + 1, b).astype(np.int32)
  lens[0], lens[-1] = 0, m
  return subs, ins, lens


def jax_minop(loss_reg):
  if loss_reg is None:
    return lambda t: jnp.min(t, axis=0)
  return lambda t: -loss_reg * jax.nn.logsumexp(-t / loss_reg, axis=0)


@pytest.mark.parametrize('loss_reg', [None, 0.1, 0.5])
@pytest.mark.parametrize('b,m,n', [(5, 12, 12), (3, 9, 14)])
def test_dp_scores_match_jax_scan_and_kernel(loss_reg, b, m, n):
  """A batch of 5 or 3 (no tile multiple), lengths 0 and m included."""
  subs, ins, lens = random_costs(b + m, b, m, n)
  before = wavefront_cuda.n_fwd_launches
  got = wavefront_cuda.alignment_scores(
      torch.from_numpy(subs), torch.from_numpy(ins), 3.0,
      torch.from_numpy(lens), loss_reg)
  assert wavefront_cuda.n_fwd_launches == before  # CPU: the plain DP
  scan = jax_wavefront.alignment_scan(
      jnp.asarray(subs), jnp.asarray(ins), jnp.float32(3.0),
      jnp.asarray(lens), jax_minop(loss_reg))
  np.testing.assert_allclose(got.numpy(), np.asarray(scan), rtol=1e-5,
                             atol=1e-4)
  if m == n:  # the interpret-mode kernel, square as the loss calls it
    kernel = wavefront_pallas.alignment_scores(
        jnp.asarray(subs), jnp.asarray(ins), 3.0, jnp.asarray(lens),
        loss_reg=loss_reg, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize('loss_reg', [None, 0.1, 1.0])
def test_dp_gradients_match_jax_vjp_kernel(loss_reg):
  """Autograd through the plain DP vs jax.grad through the Pallas
  custom VJP (K12 in interpret mode), hard minimum included."""
  subs, ins, lens = random_costs(7, 4, 8, 8)
  weights = np.random.default_rng(8).uniform(0.5, 2, 4).astype(np.float32)

  def jax_loss(s, i):
    return jnp.sum(wavefront_pallas.alignment_scores_vjp(
        s, i, jnp.asarray(lens), 3.0, loss_reg, interpret=True) * weights)

  want_val, (want_ds, want_di) = jax.value_and_grad(jax_loss, (0, 1))(
      jnp.asarray(subs), jnp.asarray(ins))
  before = wavefront_cuda.n_bwd_launches
  s = torch.from_numpy(subs).requires_grad_(True)
  i = torch.from_numpy(ins).requires_grad_(True)
  val = (wavefront_cuda.alignment_scores_vjp(
      s, i, torch.from_numpy(lens), 3.0, loss_reg)
         * torch.from_numpy(weights)).sum()
  val.backward()
  assert wavefront_cuda.n_bwd_launches == before
  np.testing.assert_allclose(val.item(), float(want_val), rtol=1e-5)
  np.testing.assert_allclose(s.grad.numpy(), np.asarray(want_ds), rtol=1e-4,
                             atol=1e-5)
  np.testing.assert_allclose(i.grad.numpy(), np.asarray(want_di), rtol=1e-4,
                             atol=1e-5)


@pytest.mark.parametrize('loss_reg', [None, 0.1])
@pytest.mark.parametrize('b,m,n', [(3, 1, 1), (3, 40, 17)])
def test_dp_edge_shapes_match_jax_scan_and_kernels(loss_reg, b, m, n):
  """The smallest DP (m = n = 1) and a wide, short one (m = 40 past a
  warp of DP rows, n = 17), lengths 0 and m: the plain DP (K11's and
  K12's CPU side) vs jax's scan and the interpret-mode Pallas K11 for
  the scores (rtol 1e-5, atol 1e-4), and vs jax.grad through the Pallas
  custom VJP (K12) for the gradients (rtol 1e-4, atol 1e-5)."""
  subs, ins, lens = random_costs(b + m + n, b, m, n)
  weights = np.random.default_rng(m + n).uniform(0.5, 2, b).astype(
      np.float32)
  args = (jnp.asarray(subs), jnp.asarray(ins), 3.0, jnp.asarray(lens))
  scan = jax_wavefront.alignment_scan(*args[:2], jnp.float32(3.0), args[3],
                                      jax_minop(loss_reg))
  kernel = wavefront_pallas.alignment_scores(*args, loss_reg=loss_reg,
                                             interpret=True)

  def jax_loss(s, i):
    return jnp.sum(wavefront_pallas.alignment_scores_vjp(
        s, i, args[3], 3.0, loss_reg, interpret=True) * weights)

  want_ds, want_di = jax.grad(jax_loss, (0, 1))(*args[:2])
  before = (wavefront_cuda.n_fwd_launches, wavefront_cuda.n_bwd_launches)
  s = torch.from_numpy(subs).requires_grad_(True)
  i = torch.from_numpy(ins).requires_grad_(True)
  got = wavefront_cuda.alignment_scores_vjp(s, i, torch.from_numpy(lens), 3.0,
                                            loss_reg)
  (got * torch.from_numpy(weights)).sum().backward()
  assert (wavefront_cuda.n_fwd_launches,
          wavefront_cuda.n_bwd_launches) == before  # CPU: the plain DP
  for want in (scan, kernel):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-4)
  np.testing.assert_allclose(s.grad.numpy(), np.asarray(want_ds), rtol=1e-4,
                             atol=1e-5)
  np.testing.assert_allclose(i.grad.numpy(), np.asarray(want_di), rtol=1e-4,
                             atol=1e-5)


def test_wavefrontify_matches_jax():
  rng = np.random.default_rng(2)
  t = rng.normal(size=(3, 6, 9)).astype(np.float32)
  v = rng.normal(size=(3, 9)).astype(np.float32)
  np.testing.assert_array_equal(
      torch_wavefront.wavefrontify(torch.from_numpy(t)).numpy(),
      np.asarray(jax_wavefront.wavefrontify(jnp.asarray(t))))
  np.testing.assert_array_equal(
      torch_wavefront.wavefrontify_vec(torch.from_numpy(v), 7).numpy(),
      np.asarray(jax_wavefront.wavefrontify_vec(jnp.asarray(v), 7)))


def test_dp_wrapper_rejects_what_the_kernels_do_not_take():
  with pytest.raises(ValueError, match='m \\+ 1 <= 1024'):
    wavefront_cuda.alignment_scores(torch.zeros(1, 1024, 4),
                                    torch.zeros(1, 4), 1.0,
                                    torch.zeros(1, dtype=torch.int32))
  with pytest.raises(ValueError, match='ins_costs shape'):
    wavefront_cuda.alignment_scores(torch.zeros(2, 5, 4), torch.zeros(2, 5),
                                    1.0, torch.zeros(2, dtype=torch.int32))
  # band_width builds the banded loss (K13/K14), whose wrappers take
  # what those kernels take.
  loss = torch_train.make_loss(torch_params(band_width=4))
  assert loss.width == 4
  subs, ins, lens = (torch.from_numpy(x) for x in random_costs(1, 2, 6, 6))
  for width in (0, 512):
    with pytest.raises(ValueError, match='2 \\* width \\+ 1 <= 1024'):
      wavefront_cuda.banded_alignment_scores(subs, ins, 1.0, lens, width)
    with pytest.raises(ValueError, match='1 <= width'):
      wavefront_cuda.banded_alignment_scores_vjp(subs, ins, lens, 1.0, 0.1,
                                                 width)
  with pytest.raises(ValueError, match='m == n'):
    wavefront_cuda.banded_alignment_scores(
        torch.zeros(2, 6, 7), torch.zeros(2, 7), 1.0, lens, 2)
  with pytest.raises(ValueError, match='float32 costs'):
    wavefront_cuda.banded_alignment_scores(subs.double(), ins.double(), 1.0,
                                           lens, 2)


# ---------------------------------------------------------------------------
# The banded DP: K13's and K14's plain side.
# ---------------------------------------------------------------------------


def band_launches():
  return (wavefront_cuda.n_band_fwd_launches,
          wavefront_cuda.n_band_bwd_launches)


@pytest.mark.parametrize('loss_reg', [None, 0.1, 0.5])
@pytest.mark.parametrize('width', [1, 3, 12, 16])
def test_banded_dp_scores_match_jax_scan(loss_reg, width):
  """m = 12, widths 1, 3, m and m + 4; a batch of 5 (no tile multiple),
  lengths 0 and m included: scores rtol 1e-5, atol 1e-4."""
  subs, ins, lens = random_costs(width + 31, 5, 12, 12)
  before = band_launches()
  got = wavefront_cuda.banded_alignment_scores(
      torch.from_numpy(subs), torch.from_numpy(ins), 3.0,
      torch.from_numpy(lens), width, loss_reg)
  assert band_launches() == before  # CPU: the plain banded DP
  want = jax_wavefront.banded_alignment_scan(
      jnp.asarray(subs), jnp.asarray(ins), jnp.float32(3.0),
      jnp.asarray(lens), width, jax_minop(loss_reg))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                             atol=1e-4)
  plain = torch_wavefront.banded_alignment_scan(
      torch.from_numpy(subs), torch.from_numpy(ins), 3.0,
      torch.from_numpy(lens), width, loss_reg)
  assert torch.equal(got, plain)


@pytest.mark.parametrize('loss_reg', [None, 0.1])
def test_banded_dp_scores_match_jax_kernel(loss_reg):
  """b = 3, m = 8, W = 2 against the Pallas kernel (K13) in interpret
  mode; and width 0, which only the plain versions take."""
  subs, ins, lens = random_costs(4, 3, 8, 8)
  args = (jnp.asarray(subs), jnp.asarray(ins), 3.0, jnp.asarray(lens))
  got = wavefront_cuda.banded_alignment_scores(
      torch.from_numpy(subs), torch.from_numpy(ins), 3.0,
      torch.from_numpy(lens), 2, loss_reg)
  kernel = wavefront_pallas.banded_alignment_scores(
      *args, 2, loss_reg=loss_reg, interpret=True)
  np.testing.assert_allclose(got.numpy(), np.asarray(kernel), rtol=1e-5,
                             atol=1e-4)
  zero = torch_wavefront.banded_alignment_scan(
      torch.from_numpy(subs), torch.from_numpy(ins), 3.0,
      torch.from_numpy(lens), 0, loss_reg)
  want = jax_wavefront.banded_alignment_scan(
      args[0], args[1], jnp.float32(3.0), args[3], 0, jax_minop(loss_reg))
  np.testing.assert_allclose(zero.numpy(), np.asarray(want), rtol=1e-5,
                             atol=1e-4)


def banded_grads_port(subs, ins, lens, weights, width, loss_reg):
  s = torch.from_numpy(subs).requires_grad_(True)
  i = torch.from_numpy(ins).requires_grad_(True)
  val = (wavefront_cuda.banded_alignment_scores_vjp(
      s, i, torch.from_numpy(lens), 3.0, loss_reg, width)
         * torch.from_numpy(weights)).sum()
  val.backward()
  return val.item(), s.grad.numpy(), i.grad.numpy()


@pytest.mark.parametrize('loss_reg', [None, 0.1, 1.0])
@pytest.mark.parametrize('width', [2, 5, 10])
def test_banded_dp_gradients_match_jax_vjp_kernel(loss_reg, width):
  """Autograd through the plain banded DP vs jax.grad through the
  Pallas custom VJP (K14 in interpret mode), m = 8 (width 10 > m),
  lengths 0 and m included, hard minimum included: rtol 1e-4, atol
  1e-5. Out-of-band cells get exactly 0 and every gradient is finite."""
  subs, ins, lens = random_costs(width + 11, 4, 8, 8)
  weights = np.random.default_rng(8).uniform(0.5, 2, 4).astype(np.float32)

  def jax_loss(s, i):
    return jnp.sum(wavefront_pallas.banded_alignment_scores_vjp(
        s, i, jnp.asarray(lens), 3.0, loss_reg, width, interpret=True)
                   * weights)

  want_val, (want_ds, want_di) = jax.value_and_grad(jax_loss, (0, 1))(
      jnp.asarray(subs), jnp.asarray(ins))
  before = band_launches()
  val, d_subs, d_ins = banded_grads_port(subs, ins, lens, weights, width,
                                         loss_reg)
  assert band_launches() == before
  np.testing.assert_allclose(val, float(want_val), rtol=1e-5)
  np.testing.assert_allclose(d_subs, np.asarray(want_ds), rtol=1e-4,
                             atol=1e-5)
  np.testing.assert_allclose(d_ins, np.asarray(want_di), rtol=1e-4,
                             atol=1e-5)
  assert np.isfinite(d_subs).all() and np.isfinite(d_ins).all()
  i, j = np.indices((8, 8))
  assert (d_subs[:, np.abs(i - j) > width] == 0).all()


@pytest.mark.parametrize('loss_reg', [None, 0.1])
def test_banded_dp_gradient_at_a_score_on_row_one(loss_reg):
  """Length 0 at width 1 scores the k = 1 slot (0, 1), which holds
  ins[0]: its gradient reaches d_ins[0], as jax.grad through the
  reference's plain scan gives it. (The reference's Pallas VJP injects
  the score's cotangent only on rows k >= 2 and gives 0 there; the port
  follows the plain scan.) Elsewhere the Pallas VJP agrees."""
  subs, ins, lens = random_costs(12, 4, 8, 8)
  weights = np.random.default_rng(9).uniform(0.5, 2, 4).astype(np.float32)
  minop = jax_minop(loss_reg)

  def jax_loss(fn):
    return lambda s, i: jnp.sum(fn(s, i) * weights)

  scan = jax_loss(lambda s, i: jax_wavefront.banded_alignment_scan(
      s, i, jnp.float32(3.0), jnp.asarray(lens), 1, minop))
  kernel = jax_loss(lambda s, i: wavefront_pallas.banded_alignment_scores_vjp(
      s, i, jnp.asarray(lens), 3.0, loss_reg, 1, interpret=True))
  costs = (jnp.asarray(subs), jnp.asarray(ins))
  want_ds, want_di = jax.grad(scan, (0, 1))(*costs)
  kernel_ds, kernel_di = jax.grad(kernel, (0, 1))(*costs)
  _, d_subs, d_ins = banded_grads_port(subs, ins, lens, weights, 1, loss_reg)
  np.testing.assert_allclose(d_subs, np.asarray(want_ds), rtol=1e-4,
                             atol=1e-5)
  np.testing.assert_allclose(d_ins, np.asarray(want_di), rtol=1e-4,
                             atol=1e-5)
  assert lens[0] == 0 and d_ins[0, 0] == pytest.approx(weights[0])
  assert float(kernel_di[0, 0]) == 0.0  # the reference kernel's omission
  np.testing.assert_allclose(d_ins[1:], np.asarray(kernel_di)[1:],
                             rtol=1e-4, atol=1e-5)
  np.testing.assert_allclose(d_subs, np.asarray(kernel_ds), rtol=1e-4,
                             atol=1e-5)


# ---------------------------------------------------------------------------
# The loss and the metrics.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('loss_reg', [None, 0.1])
def test_banded_alignment_loss_matches_jax(loss_reg):
  """AlignmentLoss(width=4), value (rtol 1e-5) and gradient wrt y_pred
  (the DP gradients' rtol 1e-4, atol 1e-5), against the reference's
  AlignmentLoss(width=4)."""
  rng = np.random.default_rng(15)
  label = gapped_labels(6, 16)
  logits = rng.normal(0, 2, (6, LENGTH, 5)).astype(np.float32)
  y_pred = np.array(jax.nn.softmax(jnp.asarray(logits), -1))
  jax_loss = jax_losses.AlignmentLoss(del_cost=10.0, loss_reg=loss_reg,
                                      width=4)
  want, want_grad = jax.jit(jax.value_and_grad(
      lambda p: jax_loss(jnp.asarray(label), p)))(jnp.asarray(y_pred))
  pred = torch.from_numpy(y_pred).requires_grad_(True)
  before = band_launches()
  got = torch_losses.AlignmentLoss(del_cost=10.0, loss_reg=loss_reg,
                                   width=4)(torch.from_numpy(label), pred)
  got.backward()
  assert band_launches() == before
  np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
  np.testing.assert_allclose(pred.grad.numpy(), np.asarray(want_grad),
                             rtol=1e-4, atol=1e-5)
  plain = torch_losses.AlignmentLoss(del_cost=10.0, loss_reg=loss_reg,
                                     width=4, plain=True)
  with torch.no_grad():
    assert plain(torch.from_numpy(label), pred).item() == got.item()


@pytest.mark.parametrize('loss_reg', [None, 0.1])
def test_alignment_loss_value_and_gradient_match_jax(loss_reg):
  rng = np.random.default_rng(5)
  label = gapped_labels(6, 6)
  logits = rng.normal(0, 2, (6, LENGTH, 5)).astype(np.float32)
  y_pred = np.array(jax.nn.softmax(jnp.asarray(logits), -1))
  jax_loss = jax_losses.AlignmentLoss(del_cost=10.0, loss_reg=loss_reg)
  want, want_grad = jax.jit(jax.value_and_grad(
      lambda p: jax_loss(jnp.asarray(label), p)))(jnp.asarray(y_pred))
  pred = torch.from_numpy(y_pred).requires_grad_(True)
  got = torch_losses.AlignmentLoss(del_cost=10.0, loss_reg=loss_reg)(
      torch.from_numpy(label), pred)
  got.backward()
  np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
  np.testing.assert_allclose(pred.grad.numpy(), np.asarray(want_grad),
                             rtol=1e-4, atol=1e-6)
  shifted = torch_losses.left_shift_sequence(torch.from_numpy(label).long())
  np.testing.assert_array_equal(
      shifted.numpy(), np.asarray(jax_losses.left_shift_sequence(
          jnp.asarray(label, jnp.int32))))


def test_substitution_costs_and_gradient_match_jax():
  """The label gather equals torch.gather bit for bit (JAX's log: rtol
  1e-6), its per-class backward gives jax.vjp's gradient (rtol 1e-4,
  atol 1e-6), and two backward passes give the same bits."""
  rng = np.random.default_rng(6)
  label = gapped_labels(6, 6).astype(np.int32)
  y_pred = np.array(jax.nn.softmax(jnp.asarray(
      rng.normal(0, 2, (6, LENGTH, 5)).astype(np.float32)), -1))
  cotangent = rng.normal(0, 1, (6, label.shape[1], LENGTH)).astype(
      np.float32)
  want, vjp = jax.vjp(lambda p: jax_losses.xentropy_subs_cost(
      jnp.asarray(label), p), jnp.asarray(y_pred))
  (want_grad,) = vjp(jnp.asarray(cotangent))
  grads = []
  for _ in range(2):
    pred = torch.from_numpy(y_pred).requires_grad_(True)
    got = torch_losses.xentropy_subs_cost(torch.from_numpy(label), pred)
    got.backward(torch.from_numpy(cotangent))
    grads.append(pred.grad)
  log_p = torch.log(torch.clamp(torch.from_numpy(y_pred), 1e-7, 1 - 1e-7))
  index = torch.from_numpy(label).long()[:, :, None].expand(got.shape)
  assert torch.equal(got, -torch.gather(log_p.transpose(1, 2), 1, index))
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                             rtol=1e-6)
  np.testing.assert_allclose(grads[0].numpy(), np.asarray(want_grad),
                             rtol=1e-4, atol=1e-6)
  assert torch.equal(grads[0], grads[1])


def test_accuracy_counts_match_jax():
  from deepconsensus_tpu.models import metrics as jax_metrics
  from deepconsensus_tpu_torch.models import metrics as torch_metrics

  label = gapped_labels(8, 1)
  scores = np.random.default_rng(2).random((8, LENGTH, 5)).astype(np.float32)
  scores[:3] = np.eye(5, dtype=np.float32)[label[:3].astype(int)]
  got = torch_metrics.per_example_accuracy_counts(
      torch.from_numpy(label), torch.from_numpy(scores))
  want = jax_metrics.per_example_accuracy_counts(jnp.asarray(label),
                                                 jnp.asarray(scores))
  assert (int(got[0]), got[1]) == (int(want[0]), int(want[1])) == (3, 8)
  for cls in range(5):
    got = torch_metrics.per_class_accuracy_counts(
        torch.from_numpy(label), torch.from_numpy(scores), cls)
    want = jax_metrics.per_class_accuracy_counts(
        jnp.asarray(label), jnp.asarray(scores), cls)
    assert tuple(map(int, got)) == tuple(map(int, want))


# ---------------------------------------------------------------------------
# The training forward.
# ---------------------------------------------------------------------------


def jax_apply(flax_variables, rows, **overrides):
  model = jax_model.get_model(jax_params(**overrides))
  return model.apply({'params': flax_variables['params']}, jnp.asarray(rows),
                     train=True, rngs={'dropout': jax.random.PRNGKey(1)})


def test_training_forward_and_gradients_match_jax(flax_variables):
  """loss_reg 1.0: the soft minimum scales float32 rounding by
  1 / loss_reg, and at the config's 0.1 the two frameworks' rounding
  alone reaches ~1e-5 of the largest gradient (the DP tests above hold
  0.1 itself)."""
  rows, label = fake_rows(BATCH, 1), gapped_labels(BATCH, 2)
  loss_jax = jax_losses.AlignmentLoss(del_cost=10.0, loss_reg=1.0)

  def jax_loss(p):
    preds = jax_apply({'params': p}, rows, **NO_DROPOUT)
    return loss_jax(jnp.asarray(label), preds), preds

  (want_loss, want_preds), want_grads = jax.jit(jax.value_and_grad(
      jax_loss, has_aux=True))(flax_variables['params'])
  model = port_model(flax_variables, **NO_DROPOUT)
  preds = model.forward_train(torch.from_numpy(rows), torch.Generator())
  np.testing.assert_allclose(preds.detach().numpy(), np.asarray(want_preds),
                             atol=1e-5)
  loss = torch_losses.AlignmentLoss(del_cost=10.0, loss_reg=1.0)(
      torch.from_numpy(label), preds)
  loss.backward()
  np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
  assert_tree_close(weights_lib.gradients_to_flax(model),
                    jax.device_get(want_grads), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('rate_key', sorted(NO_DROPOUT))
def test_dropout_placement_matches_jax(flax_variables, rate_key):
  """One rate at 1.0, the others 0: Flax and the port then both drop
  every element at that site, so outputs agree without shared bits."""
  rates = {**NO_DROPOUT, rate_key: 1.0}
  rows = fake_rows(BATCH, 4)
  want = jax_apply(flax_variables, rows, **rates)
  with torch.no_grad():
    got = port_model(flax_variables, **rates).forward_train(
        torch.from_numpy(rows), torch.Generator().manual_seed(0))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
  full = jax_apply(flax_variables, rows, **NO_DROPOUT)
  assert np.abs(np.asarray(want) - np.asarray(full)).max() > 1e-3


def test_dropout_masks_follow_the_generator(flax_variables):
  model = port_model(flax_variables)  # the config's rates, 0.1 each
  rows = torch.from_numpy(fake_rows(BATCH, 5))
  with torch.no_grad():
    run = lambda seed: model.forward_train(
        rows, torch.Generator().manual_seed(seed))
    a, b, c = run(7), run(7), run(8)
    plain = model.forward_train(rows)
  assert torch.equal(a, b)
  assert not torch.equal(a, c)
  assert not torch.equal(a, plain)


# ---------------------------------------------------------------------------
# LAMB, the schedule, the decay mask, one full step.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('warmup', [0, 3])
def test_learning_rate_schedule_matches_jax(warmup):
  params = torch_params(warmup_steps=warmup)
  jparams = jax_params(warmup_steps=warmup)
  got = torch_train.create_learning_rate_fn(params, 8)
  want = jax_train.create_learning_rate_fn(jparams, 8)
  for step in range(12):
    np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)


def test_weight_decay_mask_matches_jax(flax_variables):
  want = weights_lib.flatten_tree(
      jax_train._weight_decay_mask(flax_variables['params']))
  assert want
  for path, keep in want.items():
    assert torch_train.weight_decay_mask(path.replace('/', '.')) == keep, path
  assert not torch_train.weight_decay_mask('encoder.ffn_0.filter_layer.bias')
  assert torch_train.weight_decay_mask('condenser.kernel')


def test_lamb_matches_optax(flax_variables):
  """Three updates on the same gradients through the warmup and into
  the decay."""
  params_cfg = torch_params(warmup_steps=2)
  jparams = jax_params(warmup_steps=2)
  tree = flax_variables['params']
  rng = np.random.default_rng(9)
  grads = jax.tree_util.tree_map(
      lambda x: rng.normal(0, 1, np.shape(x)).astype(np.float32), tree)
  grads['encoder']['ffn_0']['filter_layer']['bias'] *= 0  # a zero norm
  tx = jax_train.create_optimizer(jparams, 5)
  p, state = tree, tx.init(tree)
  update = jax.jit(tx.update)
  model = port_model(flax_variables)
  lamb = torch_train.Lamb(model.named_parameters(), params_cfg, 5)
  named = {k.replace('/', '.'): torch.from_numpy(np.asarray(v))
           for k, v in weights_lib.flatten_tree(grads).items()}
  for _ in range(3):
    updates, state = update(grads, state, p)
    p = optax.apply_updates(p, updates)
    lamb.step(named)
  assert_tree_close(weights_lib.to_flax_params(model.state_dict()),
                    jax.device_get(p), rtol=0, atol=1e-6)


def test_one_train_step_matches_jax(flax_variables):
  """Epsilon 1e-3 here: Adam's first update is g / (|g| + epsilon), so
  at the config's 1e-6 a gradient entry within float32 rounding of 0
  can flip sign between the frameworks and move its parameter by the
  whole step; LAMB alone is held at the config's epsilon on identical
  gradients above."""
  rows, label = fake_rows(BATCH, 11), gapped_labels(BATCH, 12)
  step_cfg = dict(warmup_steps=2, epsilon=1e-3, **NO_DROPOUT)
  jparams = jax_params(**step_cfg)
  loss_jax = jax_train.make_loss(jparams)
  tx = jax_train.create_optimizer(jparams, 10)
  tree = flax_variables['params']

  @jax.jit
  def jax_step(p):
    loss, grads = jax.value_and_grad(lambda q: loss_jax(
        jnp.asarray(label), jax_apply({'params': q}, rows, **NO_DROPOUT)))(p)
    updates, _ = tx.update(grads, tx.init(p), p)
    return loss, optax.global_norm(grads), optax.apply_updates(p, updates)

  want_loss, want_norm, want_params = jax.device_get(jax_step(tree))
  params = torch_params(**step_cfg)
  model = port_model(flax_variables, **NO_DROPOUT)
  lamb = torch_train.Lamb(model.named_parameters(), params, 10)
  batch = torch_train.batch_to_device({'rows': rows, 'label': label}, 'cpu')
  metrics = torch_train.train_step(model, lamb, torch_train.make_loss(params),
                                   batch, torch.Generator())
  np.testing.assert_allclose(float(metrics['loss']), float(want_loss),
                             rtol=1e-5)
  np.testing.assert_allclose(float(metrics['grad_norm']), float(want_norm),
                             rtol=1e-4)
  assert_tree_close(weights_lib.to_flax_params(model.state_dict()),
                    want_params, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# Loader, synthetic shards, the CLI.
# ---------------------------------------------------------------------------


def test_synthetic_shards_are_the_reference_bytes(tmp_path):
  from scripts import inject_faults

  ours = synthetic.write_synthetic_tfrecords(str(tmp_path / 'port'), seed=5)
  theirs = inject_faults.write_synthetic_tfrecords(str(tmp_path / 'ref'),
                                                   seed=5)
  assert len(ours) == len(theirs) == 2
  for a, b in zip(ours, theirs):
    with open(a, 'rb') as fa, open(b, 'rb') as fb:
      assert fa.read() == fb.read()


def test_dataset_iterator_batches_match_jax(tmp_path):
  paths = synthetic.write_synthetic_tfrecords(
      str(tmp_path), n_shards=3, n_examples=22, max_passes=MAX_PASSES,
      max_length=LENGTH, seed=8)
  pattern = str(tmp_path / '*.tfrecord.gz')
  assert len(paths) == 3
  for shuffle in (True, False):
    want = jax_data.DatasetIterator(pattern, jax_params(), batch_size=4,
                                    seed=3, shuffle=shuffle)
    got = torch_data.DatasetIterator(pattern, torch_params(), batch_size=4,
                                     seed=3, shuffle=shuffle)
    assert got.steps_per_epoch == want.steps_per_epoch == 5
    for _ in range(2):  # two epochs: the rng carries over
      pairs = list(zip(got.epoch(), want.epoch()))
      assert len(pairs) == 5
      for g, w in pairs:
        np.testing.assert_array_equal(g['rows'], w['rows'])
        np.testing.assert_array_equal(g['label'], w['label'])


def test_loaders_carry_window_ids_as_jax(tmp_path):
  """track_window_ids: the in-memory loader's batches carry the JAX
  package's window ids (and rows), and the streamed ones (serial and
  two workers) carry the ids of their own rows."""
  synthetic.write_synthetic_tfrecords(
      str(tmp_path), n_shards=2, n_examples=16, max_passes=MAX_PASSES,
      max_length=LENGTH, seed=9)
  pattern = str(tmp_path / '*.tfrecord.gz')
  want = jax_data.DatasetIterator(
      pattern, jax_params(track_window_ids=True), batch_size=4, seed=3)
  got = torch_data.DatasetIterator(
      pattern, torch_params(track_window_ids=True), batch_size=4, seed=3)
  for g, w in zip(got.epoch(), want.epoch()):
    np.testing.assert_array_equal(g['rows'], w['rows'])
    assert list(g['name']) == list(w['name'])
  by_name = {}
  for batch in got.epoch():
    for name, rows in zip(batch['name'], batch['rows']):
      by_name[name] = rows
  assert len(by_name) == 16
  for workers in (0, 2):
    ds = torch_data.StreamingDataset(
        pattern, torch_params(track_window_ids=True), batch_size=4,
        buffer_size=8, seed=5, workers=workers)
    it = iter(ds)
    try:
      for _ in range(3):
        batch = next(it)
        assert len(batch['name']) == 4
        for name, rows in zip(batch['name'], batch['rows']):
          np.testing.assert_array_equal(rows, by_name[name])
    finally:
      it.close()


@pytest.fixture(scope='module')
def train_shards(tmp_path_factory):
  root = tmp_path_factory.mktemp('shards')
  synthetic.write_synthetic_tfrecords(
      str(root / 'train'), n_shards=2, n_examples=24, max_passes=20,
      max_length=100, seed=3)
  synthetic.write_synthetic_tfrecords(
      str(root / 'eval'), n_shards=1, n_examples=8, max_passes=20,
      max_length=100, seed=4)
  return str(root / 'train' / '*'), str(root / 'eval' / '*')


TRAIN_FLAGS = ('--batch_size', '8', '--set', 'num_hidden_layers=2', '--set',
               'filter_size=64', '--set', 'dtype=float32', '--set',
               'log_every_n_steps=1')


def read_jsonl(path):
  with open(path) as f:
    return [json.loads(line) for line in f]


def test_cli_train_on_cpu_resumes_and_feeds_run(train_shards, tmp_path):
  from deepconsensus_tpu_torch import cli

  out = str(tmp_path / 'model')
  argv = ['train', '--out_dir', out, '--train_path', train_shards[0],
          '--eval_path', train_shards[1], '--device', 'cpu', *TRAIN_FLAGS]
  assert cli.main(argv + ['--num_epochs', '1']) == 0
  first = read_jsonl(os.path.join(out, 'metrics.jsonl'))
  train = [e for e in first if e['split'] == 'train']
  assert [e['step'] for e in train] == [1, 2, 3]
  assert all(np.isfinite(e['loss']) and np.isfinite(e['grad_norm'])
             for e in train)
  assert os.path.isdir(os.path.join(out, 'checkpoints', 'checkpoint-3'))
  # A second run with two epochs resumes at step 3 and runs steps 4-6.
  assert cli.main(argv + ['--num_epochs', '2']) == 0
  second = read_jsonl(os.path.join(out, 'metrics.jsonl'))[len(first):]
  assert [e['step'] for e in second if e['split'] == 'train'] == [4, 5, 6]
  evals = [e for e in second if e['split'] == 'eval']
  assert evals and np.isfinite(evals[-1]['eval/loss'])
  with open(os.path.join(out, 'checkpoint_metrics.tsv')) as f:
    assert [line.split('\t')[0] for line in f][1:] == [
        'checkpoint-3', 'checkpoint-6']

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


def test_cli_train_with_band_width_on_cpu(train_shards, tmp_path,
                                         monkeypatch):
  """`cli train --set band_width=12`: 3 steps of 8 and one eval batch
  through the plain banded DP (no kernel launch on the CPU; the full DP
  is not called), and params.json keeps the width."""
  from deepconsensus_tpu_torch import cli

  calls = {'banded': 0, 'full': 0}
  for name, key in (('banded_alignment_scan', 'banded'),
                    ('alignment_scan', 'full')):
    fn = getattr(torch_wavefront, name)

    def counted(*args, _fn=fn, _key=key, **kwargs):
      calls[_key] += 1
      return _fn(*args, **kwargs)

    monkeypatch.setattr(torch_wavefront, name, counted)
  out = str(tmp_path / 'model')
  before = (band_launches(), wavefront_cuda.n_fwd_launches,
            wavefront_cuda.n_bwd_launches)
  assert cli.main(['train', '--out_dir', out, '--train_path',
                   train_shards[0], '--eval_path', train_shards[1],
                   '--device', 'cpu', '--num_epochs', '1', *TRAIN_FLAGS,
                   '--set', 'band_width=12']) == 0
  assert (band_launches(), wavefront_cuda.n_fwd_launches,
          wavefront_cuda.n_bwd_launches) == before
  assert calls == {'banded': 3 + 1, 'full': 0}
  assert torch_config.read_params_from_json(out)['band_width'] == 12
  train = [e for e in read_jsonl(os.path.join(out, 'metrics.jsonl'))
           if e['split'] == 'train']
  assert len(train) == 3
  assert all(np.isfinite(e['loss']) and np.isfinite(e['grad_norm'])
             for e in train)


def test_cli_train_defaults_to_the_card(train_shards, tmp_path,
                                        monkeypatch):
  from deepconsensus_tpu_torch import cli

  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='no CUDA device'):
    cli.main(['train', '--out_dir', str(tmp_path), '--train_path',
              train_shards[0], '--eval_path', train_shards[1]])
  with pytest.raises(ValueError, match='unknown config override'):
    cli.main(['train', '--out_dir', str(tmp_path), '--device', 'cpu',
              '--set', 'no_such_key=1'])


# ---------------------------------------------------------------------------
# The data half of `cli train`: remat, bucketed steps, the new flags.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('use_pallas_attention', [False, True])
def test_remat_leaves_gradients_unchanged_with_dropout(flax_variables,
                                                       use_pallas_attention):
  """remat recomputes each sublayer in the backward pass; the dropout
  generator is set back for the recompute, so the gradients (f32, atol
  1e-6) and the generator's final state equal those without it. With
  use_pallas_attention the keep-masks go through K7's plain version."""
  rows, label = fake_rows(BATCH, 21), gapped_labels(BATCH, 22)
  grads, states = [], []
  for remat in (False, True):
    model = port_model(flax_variables, remat=remat,
                       use_pallas_attention=use_pallas_attention)
    gen = torch.Generator().manual_seed(9)
    preds = model.forward_train(torch.from_numpy(rows), gen)
    loss = torch_train.make_loss(model.params)(
        torch.from_numpy(label).long(), preds)
    loss.backward()
    grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    states.append(gen.get_state())
  assert torch.equal(states[0], states[1])
  for name, g in grads[0].items():
    np.testing.assert_allclose(grads[1][name].numpy(), g.numpy(), rtol=0,
                               atol=1e-6, err_msg=name)


def bucket_rows(batch, width, seed):
  rng = np.random.default_rng(seed)
  mp = MAX_PASSES
  rows = np.zeros((batch, 4 * mp + 5, width, 1), np.float32)
  rows[:, :mp] = rng.integers(0, 5, rows[:, :mp].shape)
  rows[:, mp:3 * mp] = rng.integers(0, 256, rows[:, mp:3 * mp].shape)
  rows[:, 3 * mp:4 * mp] = rng.integers(0, 3, rows[:, :mp].shape)
  rows[:, 4 * mp] = rng.integers(0, 5, rows[:, 4 * mp].shape)
  rows[:, 4 * mp + 1:] = rng.integers(0, 501, rows[:, 4 * mp + 1:].shape)
  label = rng.integers(1, 5, (batch, width)).astype(np.float32)
  label[:, -width // 4:] = 0
  return rows, label


def test_bucketed_train_steps_match_jax(flax_variables):
  """One step at width 20, then one at width 40, over one parameter set
  and one LAMB state (buckets (20, 40)), against two JAX steps that
  carry the optimizer state: each loss rtol 1e-5, the parameters after
  both atol 1e-5. Epsilon 1e-3 as in test_one_train_step_matches_jax."""
  cfg = dict(warmup_steps=2, epsilon=1e-3, window_buckets=(20, 40),
             **NO_DROPOUT)
  batches = [bucket_rows(BATCH, 20, 31), bucket_rows(BATCH, 40, 32)]
  jparams = jax_params(**cfg)
  loss_jax = jax_train.make_loss(jparams)
  tx = jax_train.create_optimizer(jparams, 10)

  def jax_step(p, state, rows, label):
    loss, grads = jax.value_and_grad(lambda q: loss_jax(
        jnp.asarray(label), jax_apply({'params': q}, rows, **NO_DROPOUT)))(p)
    updates, state = tx.update(grads, state, p)
    return loss, optax.apply_updates(p, updates), state

  p = flax_variables['params']
  state = tx.init(p)
  want_losses = []
  for rows, label in batches:
    loss, p, state = jax.jit(jax_step)(p, state, rows, label)
    want_losses.append(float(loss))
  params = torch_params(**cfg)
  model = port_model(flax_variables, **cfg)
  lamb = torch_train.Lamb(model.named_parameters(), params, 10)
  loss_fn = torch_train.make_loss(params)
  got_losses = []
  for rows, label in batches:
    batch = torch_train.batch_to_device({'rows': rows, 'label': label},
                                        'cpu')
    got_losses.append(float(torch_train.train_step(
        model, lamb, loss_fn, batch, torch.Generator())['loss']))
  np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
  assert_tree_close(weights_lib.to_flax_params(model.state_dict()),
                    jax.device_get(p), rtol=0, atol=1e-5)


@pytest.fixture(scope='module')
def bucket_shards(tmp_path_factory):
  root = tmp_path_factory.mktemp('bucket_shards')
  for width, seed in ((20, 3), (40, 4)):
    synthetic.write_synthetic_tfrecords(
        str(root / f'w{width}'), n_shards=2, n_examples=16, max_passes=20,
        max_length=width, seed=seed)
  return str(root / 'w20' / '*'), str(root / 'w40' / '*')


BUCKET_FLAGS = ('--batch_size', '4', '--num_epochs', '1', '--device', 'cpu',
                '--set', 'num_hidden_layers=1', '--set', 'filter_size=32',
                '--set', 'dtype=float32', '--set', 'log_every_n_steps=1',
                '--set', 'max_length=20')


@pytest.mark.parametrize('loader', ['in_memory', 'streaming_workers'])
def test_cli_train_buckets_stream_augment_remat(bucket_shards, tmp_path,
                                                loader):
  """`cli train --window_buckets 20,40` on shards of both widths: one
  step geometry per bucket, width-pure batches, every batch prefetched
  but the first; streamed through two loader workers with --set
  augment=true --set remat=true too. No worker is left running."""
  from deepconsensus_tpu_torch import cli

  out = str(tmp_path / 'model')
  extra = []
  if loader == 'streaming_workers':
    extra = ['--set', 'streaming=true', '--set', 'n_examples_train=16',
             '--set', 'loader_workers=2', '--set', 'buffer_size=8',
             '--set', 'augment=true', '--set', 'remat=true',
             '--on_shard_error', 'skip']
  assert cli.main(['train', '--out_dir', out, '--train_path',
                   *bucket_shards, '--eval_path', bucket_shards[0],
                   '--window_buckets', '20,40', *BUCKET_FLAGS,
                   *extra]) == 0
  assert not multiprocessing.active_children()
  entries = read_jsonl(os.path.join(out, 'metrics.jsonl'))
  train = [e for e in entries if e['split'] == 'train']
  faults = [e for e in entries if e['split'] == 'faults'][-1]
  steps = 8 if loader == 'in_memory' else 4
  assert len(train) == steps
  assert {e['window_width'] for e in train} == {20, 40}
  assert all(np.isfinite(e['loss']) for e in train)
  assert faults['n_train_forward_shapes'] == 2
  assert (faults['n_train_batches_by_bucket_20']
          + faults['n_train_batches_by_bucket_40']) == steps
  assert faults['n_batch_launches'] == steps
  assert faults['train_transfer_overlap_fraction'] == round(
      (steps - 1) / steps, 4)
  saved = torch_config.read_params_from_json(out)
  assert list(saved['window_buckets']) == [20, 40]
  if loader == 'streaming_workers':
    assert saved['remat'] and saved['augment'] and saved['streaming']
    assert saved['on_shard_error'] == 'skip'
    assert faults['n_parsed_worker_0'] > 0 or faults['n_parsed_worker_1'] > 0


def test_cli_train_rejects_bad_bucket_sets_and_budgets(bucket_shards,
                                                       tmp_path):
  from deepconsensus_tpu_torch import cli
  from deepconsensus_tpu_torch.faults import WindowBucketError

  argv = ['train', '--out_dir', str(tmp_path), '--train_path',
          bucket_shards[0], '--eval_path', bucket_shards[0], *BUCKET_FLAGS]
  with pytest.raises(WindowBucketError, match='strictly ascending'):
    cli.main(argv + ['--window_buckets', '40,20'])
  with pytest.raises(ValueError, match='n_examples_train'):
    cli.main(argv + ['--set', 'streaming=true'])
