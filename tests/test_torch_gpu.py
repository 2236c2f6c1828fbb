"""CUDA kernels of the PyTorch port against their plain versions.

Marked `gpu`: each test asks the `cuda` fixture for the card and skips
without one (decided in the fixture, never at import time). This file
imports only torch, numpy and the port, so it runs on a machine without
JAX:  python -m pytest tests/test_torch_gpu.py -m gpu
Tolerances: float32 rtol = atol = 1e-4, bfloat16 2e-2, K3 exact; the
alignment DP (K11/K12) scores rtol 1e-5, gradients rtol 1e-4, atol 1e-5.
"""
import numpy as np
import pytest
import torch

from deepconsensus_tpu_torch.calibration import lib as calibration_lib
from deepconsensus_tpu_torch.inference import runner
from deepconsensus_tpu_torch.models import config
from deepconsensus_tpu_torch.models import model as model_lib
from deepconsensus_tpu_torch.ops import fused_encoder_block as feb
from deepconsensus_tpu_torch.ops import fused_window_attention as fwa
from deepconsensus_tpu_torch.ops import output_plane
from deepconsensus_tpu_torch.ops import ragged_window_attention as rwa
from deepconsensus_tpu_torch.ops import wavefront
from deepconsensus_tpu_torch.ops import wavefront_cuda
from deepconsensus_tpu_torch.testing import synthetic

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
  """The card, or a skip."""
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device (run on the GPU machine)')
  return torch.device('cuda')


def small_params(dtype='float32', length=100, **overrides):
  params = config.get_config('transformer_learn_values+test')
  config.finalize_params(params, max_length=length)
  params.update(dtype=dtype, num_hidden_layers=2, filter_size=64,
                **overrides)
  return params


def seeded_model(params, device):
  model = model_lib.DeepConsensusModel(params, device=device)
  model.init_weights(torch.Generator().manual_seed(0), alpha_range=(0.5, 1))
  return model


def fake_rows(params, batch, seed=0, length=None):
  rng = np.random.default_rng(seed)
  mp = params.max_passes
  rows = np.zeros((batch, params.total_rows, length or params.max_length),
                  np.float32)
  rows[:, :mp] = rng.integers(0, 5, rows[:, :mp].shape)
  rows[:, mp:3 * mp] = rng.integers(0, 256, rows[:, mp:3 * mp].shape)
  rows[:, 3 * mp:4 * mp] = rng.integers(0, 3, rows[:, :mp].shape)
  rows[:, 4 * mp] = rng.integers(0, 5, rows[:, 4 * mp].shape)
  rows[:, 4 * mp + 1:] = rng.uniform(0, 520, rows[:, 4 * mp + 1:].shape)
  return torch.from_numpy(rows)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('length', [20, 100])
def test_kernels_match_plain(cuda, dtype, length):
  params = small_params(str(dtype).replace('torch.', ''), length)
  model = seeded_model(params, cuda)
  rows = fake_rows(params, 37).to(cuda)  # not a multiple of any tile
  counts = (fwa.n_launches, feb.n_launches)
  kernel = model.encode(rows)
  plain = model.encode(rows, plain=True)
  assert fwa.n_launches == counts[0] + 1
  assert feb.n_launches == counts[1] + params.num_hidden_layers
  torch.testing.assert_close(kernel, plain, rtol=TOL[dtype],
                             atol=TOL[dtype])


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_ragged_kernels_match_plain(cuda, dtype):
  """K4 and K2 with lengths (one launch each per layer) against their
  plain versions on valid positions, over every slot composition: one
  200, two 100s, a lone 100 (partial) and an empty slot."""
  params = small_params(str(dtype).replace('torch.', ''),
                        window_buckets=[100, 200])
  model = seeded_model(params, cuda)
  widths = [[200, 0], [100, 100], [100, 0], [0, 0]] * 9 + [[100, 100]]
  lengths = torch.tensor(widths, dtype=torch.int32, device=cuda)
  rows = fake_rows(params, len(widths), length=200).to(cuda)
  valid = rwa.slot_geometry(lengths, 200)[3]
  rows = rows * valid[:, None, :]  # pad positions hold zeros
  counts = (rwa.n_launches, feb.n_launches)
  kernel = model.encode(rows, window_lengths=lengths)
  plain = model.encode(rows, plain=True, window_lengths=lengths)
  assert rwa.n_launches == counts[0] + 1
  assert feb.n_launches == counts[1] + params.num_hidden_layers
  assert torch.isfinite(kernel).all()
  torch.testing.assert_close(kernel[valid], plain[valid], rtol=TOL[dtype],
                             atol=TOL[dtype])


def test_ragged_cuda_run_matches_cpu_run(cuda, tmp_path):
  bams = synthetic.write_synthetic_zmw_bams(
      str(tmp_path), n_zmws=4, n_subreads=4, seq_len=600, smart_windows=True)
  params = small_params()
  state = seeded_model(params, 'cpu').state_dict()
  outs = []
  for device in ('cpu', cuda):
    opts = runner.InferenceOptions(
        batch_size=8, min_quality=0, skip_windows_above=0,
        use_ccs_smart_windows=True, window_buckets=(100, 200),
        use_ragged_kernel=True)
    path = str(tmp_path / f'{torch.device(device).type}.fastq')
    counters = runner.run_inference(
        bams[0], bams[1], path,
        runner.ModelRunner(params, state, opts, device=device))
    assert min(counters['n_windows_by_bucket'].values()) > 0
    with open(path, 'rb') as f:
      lines = f.read().split(b'\n')
    outs.append([lines[i:i + 4] for i in range(0, len(lines) - 1, 4)])
  assert len(outs[0]) == len(outs[1]) == 4
  for (cn, cs, _, cq), (gn, gs, _, gq) in zip(*outs):
    assert (cn, cs) == (gn, gs)
    assert np.abs(np.frombuffer(cq, np.uint8).astype(int)
                  - np.frombuffer(gq, np.uint8).astype(int)).max() <= 1


def test_attention_core_fits_slot_200(cuda):
  """The tiled core's shared memory at S = 200 and S = 256 (band 12)
  stays far under the 227 KB block limit."""
  from deepconsensus_tpu_torch.ops import _kernels

  for length in (100, 200, 256):
    assert _kernels.attention_smem_bytes(length, 280, 2, 12) < 100_000


def test_phred_epilogue_exact(cuda):
  thr = output_plane.quality_thresholds(
      calibration_lib.parse_calibration_string('skip'), 93)
  rng = np.random.default_rng(1)
  preds = rng.dirichlet(np.ones(5) * 0.3, (33, 100)).astype(np.float32)
  preds[0] = 0.2
  preds[1, :, 4] = thr[rng.integers(0, len(thr), 100)]
  preds = torch.from_numpy(preds).to(cuda)
  before = output_plane.n_launches
  got = output_plane.phred_epilogue(preds, thr)
  want = output_plane.phred_epilogue_plain(preds,
                                           torch.from_numpy(thr).to(cuda))
  assert output_plane.n_launches == before + 1
  for g, w in zip(got, want):
    assert torch.equal(g, w)


def wavefront_costs(device, batch, m, n, seed):
  rng = np.random.default_rng(seed)
  lens = rng.integers(0, m + 1, batch).astype(np.int32)
  lens[:2] = (0, m)
  return (torch.from_numpy(rng.uniform(0, 5, (batch, m, n))
                           .astype(np.float32)).to(device),
          torch.from_numpy(rng.uniform(0, 5, (batch, n))
                           .astype(np.float32)).to(device),
          torch.from_numpy(lens).to(device))


@pytest.mark.parametrize('loss_reg', [None, 0.1, 1.0])
@pytest.mark.parametrize('m,n', [(100, 100), (30, 57)])
def test_wavefront_kernels_match_plain(cuda, loss_reg, m, n):
  """K11 (without and with rows) and K12 against the plain DP and its
  autograd, on one launch each: scores rtol 1e-5 (atol 1e-4),
  gradients rtol 1e-4, atol 1e-5."""
  subs, ins, lens = wavefront_costs(cuda, 37, m, n, seed=m + n)
  fwd, bwd = wavefront_cuda.n_fwd_launches, wavefront_cuda.n_bwd_launches
  got = wavefront_cuda.alignment_scores(subs, ins, 10.0, lens, loss_reg)
  want = wavefront.alignment_scan(subs, ins, 10.0, lens, loss_reg)
  torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)

  weights = torch.rand(37, device=cuda) + 0.5
  grads = []
  for fn in (wavefront_cuda.alignment_scores_vjp,
             lambda s, i, l, d, r: wavefront.alignment_scan(s, i, d, l, r)):
    s, i = subs.clone().requires_grad_(True), ins.clone().requires_grad_(True)
    value = fn(s, i, lens, 10.0, loss_reg)
    grads.append((value, *torch.autograd.grad(value, (s, i), weights)))
  torch.cuda.synchronize()
  assert wavefront_cuda.n_fwd_launches == fwd + 2
  assert wavefront_cuda.n_bwd_launches == bwd + 1
  (gv, gs, gi), (wv, ws, wi) = grads
  torch.testing.assert_close(gv, wv, rtol=1e-5, atol=1e-4)
  torch.testing.assert_close(gs, ws, rtol=1e-4, atol=1e-5)
  torch.testing.assert_close(gi, wi, rtol=1e-4, atol=1e-5)


def test_wavefront_wrapper_rejects_bad_input(cuda):
  with pytest.raises(ValueError, match='m \\+ 1 <= 1024'):
    wavefront_cuda.alignment_scores(
        torch.zeros(1, 1024, 4, device=cuda), torch.zeros(1, 4, device=cuda),
        1.0, torch.zeros(1, dtype=torch.int32, device=cuda))
  with pytest.raises(ValueError, match='seq_lens is on'):
    wavefront_cuda.alignment_scores(
        torch.zeros(1, 4, 4, device=cuda), torch.zeros(1, 4, device=cuda),
        1.0, torch.zeros(1, dtype=torch.int32))


def test_training_step_on_the_card_matches_the_cpu(cuda):
  """One float32 train step, dropout 0, the same weights: the card's
  (K11 with rows, K12, cuBLAS) loss within 1e-4 relative of the CPU's
  (plain DP)."""
  from deepconsensus_tpu_torch.models import train as train_lib

  params = small_params(attention_dropout=0.0, relu_dropout=0.0,
                        layer_postprocess_dropout=0.0)
  rows = fake_rows(params, 8, seed=3).numpy()[..., None]
  label = np.random.default_rng(4).integers(0, 5, (8, 100)).astype(
      np.float32)
  state = seeded_model(params, 'cpu').state_dict()
  losses = []
  for device in ('cpu', cuda):
    model = model_lib.DeepConsensusModel(params, device=device)
    model.load_state_dict(state)
    model.requires_grad_(True)
    lamb = train_lib.Lamb(model.named_parameters(), params, 10)
    bwd = wavefront_cuda.n_bwd_launches
    m = train_lib.train_step(
        model, lamb, train_lib.make_loss(params),
        train_lib.batch_to_device({'rows': rows, 'label': label}, device),
        torch.Generator(device=device))
    losses.append(float(m['loss']))
    assert wavefront_cuda.n_bwd_launches == bwd + (device != 'cpu')
  np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)


def test_wrapper_rejects_bad_input(cuda):
  with pytest.raises(ValueError, match='float32'):
    output_plane.phred_epilogue(torch.zeros(2, 3, 5, device=cuda,
                                            dtype=torch.float64), [0.5])


def test_cuda_run_matches_cpu_run(cuda, tmp_path):
  bams = synthetic.write_synthetic_zmw_bams(str(tmp_path), n_zmws=4,
                                            n_subreads=4, seq_len=300)
  params = small_params()
  state = seeded_model(params, 'cpu').state_dict()
  outs = []
  for device in ('cpu', cuda):
    opts = runner.InferenceOptions(batch_size=8, min_quality=0,
                                   skip_windows_above=0)
    path = str(tmp_path / f'{torch.device(device).type}.fastq')
    runner.run_inference(bams[0], bams[1], path,
                         runner.ModelRunner(params, state, opts,
                                            device=device))
    with open(path, 'rb') as f:
      lines = f.read().split(b'\n')
    outs.append([lines[i:i + 4] for i in range(0, len(lines) - 1, 4)])
  assert len(outs[0]) == len(outs[1]) == 4
  for (cn, cs, _, cq), (gn, gs, _, gq) in zip(*outs):
    assert (cn, cs) == (gn, gs)
    assert np.abs(np.frombuffer(cq, np.uint8).astype(int)
                  - np.frombuffer(gq, np.uint8).astype(int)).max() <= 1
