"""CUDA kernels of the PyTorch port against their plain versions.

Marked `gpu`: each test asks the `cuda` fixture for the card and skips
without one (decided in the fixture, never at import time). This file
imports only torch, numpy and the port, so it runs on a machine without
JAX:  python -m pytest tests/test_torch_gpu.py -m gpu
Tolerances: float32 rtol = atol = 1e-4, bfloat16 2e-2 (K2's int8
variant too), K3 exact; the
alignment DP (K11/K12) and the banded DP (K13/K14) scores rtol 1e-5
(atol 1e-4), gradients rtol 1e-4, atol 1e-5; the banded-attention
training kernels (K5-K7) and the block-banded flash kernels (K8-K10) as
K1/K2, K8's logsumexp rtol = atol = 1e-4 in both types (float32 from
the same inputs); the attention core 1e-4 with a float32 softmax and
2e-2 with the attn_softmax_dtype=bfloat16 variant, whose model-level
test takes the reference's bar for the lever (probabilities within
2e-2, calls agreeing on > 99.9%). The fault surface of `run`: the
dispatch watchdog against a pack held back by the device spin, the
half-batch packs of OOM bisection bit for bit, and a real
torch.cuda.OutOfMemoryError classified as DeviceOomError.
"""
import time

import numpy as np
import pytest
import torch

from deepconsensus_tpu_torch import faults
from deepconsensus_tpu_torch.calibration import lib as calibration_lib
from deepconsensus_tpu_torch.inference import runner
from deepconsensus_tpu_torch.models import config
from deepconsensus_tpu_torch.models import model as model_lib
from deepconsensus_tpu_torch.ops import banded_attention as ba
from deepconsensus_tpu_torch.ops import device_spin
from deepconsensus_tpu_torch.ops import flash_band_attention as fba
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
  stays far under the 227 KB block limit; without a band (a key block of
  at most 96 K/V rows) it still holds two blocks on an SM ((233,472 -
  2 x 1,024) / 2 bytes)."""
  from deepconsensus_tpu_torch.ops import _kernels

  for length in (100, 200, 256):
    assert _kernels.attention_smem_bytes(length, 280, 2, 12) < 100_000
    assert _kernels.attention_smem_bytes(length, 280, 2,
                                         length - 1) <= 115_712


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


def condenser_inputs(use_ccs_bq, dtype, batch, length, device, seed=0):
  """K1's inputs at full condenser width (85 or 86 rows, 560 or 568 ->
  280) from a seed: tables float32, or bfloat16 in bfloat16 runs with
  ccs_bq (the kernel reads either and rounds to the compute dtype),
  weights float32, pos in the compute dtype."""
  params = config.get_config(
      'transformer_learn_values+' + ('test_bq' if use_ccs_bq else 'test'))
  config.finalize_params(params, max_length=max(length, 1))
  specs, keys, cond_in = fwa.build_family_specs(params)
  gen = torch.Generator().manual_seed(seed)
  tab_dt = (torch.bfloat16 if use_ccs_bq and dtype == torch.bfloat16
            else torch.float32)
  tables = {k: (0.5 * torch.randn((
      next(s.vocab for s in specs if s.table_idx == i),
      next(s.width for s in specs if s.table_idx == i)), generator=gen))
            .to(device=device, dtype=tab_dt) for i, k in enumerate(keys)}
  h = params.hidden_size
  w = [(0.05 * torch.randn(shape, generator=gen)).to(device)
       for shape in [(cond_in, h)] + [(h, h)] * 4]
  pos = torch.randn((length, h), generator=gen).to(device=device,
                                                     dtype=dtype)
  rows = fake_rows(params, batch, seed, length=length)
  rows[:, :, ::7] = -1.5  # negative and fractional ids
  rows[:, -1, 1::5] = 1e4  # past the vocabulary
  kw = dict(specs=specs, table_keys=keys, num_heads=params.num_heads,
            attn_win_size=params.attn_win_size, compute_dtype=dtype)
  return params, rows.to(device), tables, w, pos, kw


@pytest.mark.parametrize('use_ccs_bq', [False, True])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('length', [1, 60, 100, 128])
@pytest.mark.parametrize('batch', [1, 3, 37])
def test_k1_condenser_matches_plain(cuda, batch, length, dtype, use_ccs_bq):
  """K1 (its tensor-core condenser, then the projections and the
  attention core) against its plain version: 64-token tiles that
  straddle windows (L = 60, 100), a tile past the last token (B = 1),
  K's masked tail (560 / 568 in chunks of 32), edge ids."""
  _, rows, tables, w, pos, kw = condenser_inputs(use_ccs_bq, dtype, batch,
                                                 length, cuda)
  before = fwa.n_launches
  got = fwa.fused_embed_condense_attention(rows, tables, *w, pos, **kw)
  want = fwa.fused_embed_condense_attention_plain(rows, tables, *w, pos,
                                                  **kw)
  assert fwa.n_launches == before + 1
  for g, p in zip(got, want):
    assert g.dtype == dtype and torch.isfinite(g.float()).all()
    torch.testing.assert_close(g.float(), p.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize('use_ccs_bq', [False, True])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('slot', [60, 100, 128])
@pytest.mark.parametrize('batch', [1, 3, 37])
def test_k4_condenser_matches_plain(cuda, batch, slot, dtype, use_ccs_bq):
  """K4 against its plain version on valid positions: slots holding one
  window, two, a partial one or none, so ragged windows cross the
  condenser's 64-token tiles at every offset."""
  _, rows, tables, w, pos, kw = condenser_inputs(use_ccs_bq, dtype, batch,
                                                 slot, cuda, seed=1)
  shapes = [[slot, 0], [slot // 2, slot - slot // 2], [slot // 3, 0],
            [0, 0], [slot // 4, slot // 2]]
  lengths = torch.tensor([shapes[i % len(shapes)] for i in range(batch)],
                         dtype=torch.int32, device=cuda)
  valid = rwa.slot_geometry(lengths, slot)[3]
  rows = rows * valid[:, None, :]
  before = rwa.n_launches
  got = rwa.ragged_embed_condense_attention(rows, lengths, tables, *w, pos,
                                            **kw)
  want = rwa.ragged_embed_condense_attention_plain(rows, lengths, tables,
                                                   *w, pos, **kw)
  assert rwa.n_launches == before + 1
  for g, p in zip(got, want):
    assert torch.isfinite(g.float()).all()
    torch.testing.assert_close(g[valid].float(), p[valid].float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


def test_condenser_rejects_what_it_cannot_stage(cuda):
  """Tables past the int16 offsets / shared memory, and N past one
  block's 288 columns, raise; nothing falls back."""
  from deepconsensus_tpu_torch.ops import _kernels

  _, rows, tables, w, pos, kw = condenser_inputs(False, torch.float32, 2,
                                                 100, cuda)
  big = dict(tables, sn=torch.zeros((5000, 8), device=cuda))
  specs = tuple(s._replace(vocab=5000) if s.name == 'sn' else s
                for s in kw['specs'])
  with pytest.raises(ValueError, match='fit'):
    fwa.fused_embed_condense_attention(rows, big, *w, pos,
                                       **dict(kw, specs=specs))
  x = torch.empty((2, 100, 296), device=cuda)
  ops = fwa.condense_operands(tables, w[0], None, specs=kw['specs'],
                              table_keys=kw['table_keys'],
                              compute_dtype=torch.float32, n_rows=85)
  with pytest.raises(ValueError, match='288'):
    _kernels.embed_condense(rows, ops.meta, ops.tables, ops.scales,
                            ops.bases, ops.entries,
                            torch.zeros((560, 296), device=cuda), None, x,
                            None)


def k3_inputs(n_pos, vocab, n_thr, device, seed=0):
  """[1, n_pos, vocab] softmax-like preds with five-way ties, pairs
  tied at the max, NaN rows and probabilities on thresholds, and n_thr
  non-decreasing thresholds (with repeats)."""
  rng = np.random.default_rng(seed)
  if n_thr == 93:
    thr = output_plane.quality_thresholds(
        calibration_lib.parse_calibration_string('skip'), 93)
  else:
    thr = np.sort(rng.uniform(0.1, 1.0, n_thr)).astype(np.float32)
    if n_thr:
      thr[n_thr // 2:n_thr // 2 + 3] = thr[n_thr // 2]
  preds = rng.dirichlet(np.ones(vocab) * 0.3, (1, n_pos)).astype(np.float32)
  preds[0, ::11] = 1.0 / vocab
  if vocab > 2:
    preds[0, 3::13, 1] = preds[0, 3::13, 2] = 0.45
  preds[0, 5::17, vocab // 2] = np.nan
  if n_thr:
    on = preds[0, 7::19]
    on[:, 0] = thr[rng.integers(0, n_thr, on.shape[0])]
    preds[0, 7::19] = on
  return (torch.from_numpy(preds).to(device), thr,
          torch.from_numpy(thr).to(device))


@pytest.mark.parametrize('n_thr', [0, 1, 93, 255])
@pytest.mark.parametrize('n_pos', [1, 255, 257, 102403])
def test_k3_binary_search_exact(cuda, n_pos, n_thr):
  preds, thr_np, thr = k3_inputs(n_pos, 5, n_thr, cuda)
  before = output_plane.n_launches
  for table in (thr_np, thr):
    got = output_plane.phred_epilogue(preds, table)
    want = output_plane.phred_epilogue_plain(preds, thr)
    for g, p in zip(got, want):
      assert torch.equal(g, p)
  assert output_plane.n_launches == before + 2


@pytest.mark.parametrize('vocab', [1, 7, 50])
def test_k3_any_vocab(cuda, vocab):
  """Rows of any width stage through shared memory (50: one position a
  thread and 51 KB of dynamic shared memory)."""
  preds, _, thr = k3_inputs(3001, vocab, 93, cuda, seed=vocab)
  got = output_plane.phred_epilogue(preds, thr)
  want = output_plane.phred_epilogue_plain(preds, thr)
  for g, p in zip(got, want):
    assert torch.equal(g, p)


def test_k3_refuses_unsorted_numpy_thresholds(cuda):
  preds = torch.full((1, 4, 5), 0.2, device=cuda)
  before = output_plane.n_launches
  with pytest.raises(ValueError, match='non-decreasing'):
    output_plane.phred_epilogue(preds, np.float32([0.3, 0.2]))
  assert output_plane.n_launches == before


def wavefront_costs(device, batch, m, n, seed):
  rng = np.random.default_rng(seed)
  lens = rng.integers(0, m + 1, batch).astype(np.int32)
  lens[:2] = (0, m)[:batch]
  return (torch.from_numpy(rng.uniform(0, 5, (batch, m, n))
                           .astype(np.float32)).to(device),
          torch.from_numpy(rng.uniform(0, 5, (batch, n))
                           .astype(np.float32)).to(device),
          torch.from_numpy(lens).to(device))


@pytest.mark.parametrize('loss_reg', [None, 0.1, 1.0])
@pytest.mark.parametrize('m,n', [(100, 100), (30, 57), (200, 200), (1, 1),
                                 (500, 500), (1023, 40)])
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


@pytest.mark.parametrize('loss_reg', [None, 0.1])
@pytest.mark.parametrize('m', [100, 200])
def test_wavefront_kernels_repeat_bit_for_bit(cuda, loss_reg, m):
  """K11 and K12 at the train paths' shapes (256 rows, m = n = 100 and
  200): two launches give the same scores, rows and gradients bit for
  bit (K12 sums d_ins without atomics), and K11's scores equal the plain
  DP's bit for bit (it repeats the plain version's roundings)."""
  subs, ins, lens = wavefront_costs(cuda, 256, m, m, seed=m)
  grad = torch.rand(256, device=cuda) + 0.5
  runs = []
  for _ in range(2):
    scores, rows = wavefront_cuda.alignment_scores_with_rows(
        subs, ins, 10.0, lens, loss_reg)
    d_subs, d_ins = wavefront_cuda.launch_bwd(
        subs, ins, lens, rows, grad, 10.0, loss_reg)
    runs.append((scores, rows, d_subs, d_ins))
  torch.cuda.synchronize()
  for first, second in zip(*runs):
    assert torch.equal(first, second)
  want = wavefront.alignment_scan(subs, ins, 10.0, lens, loss_reg)
  assert torch.equal(runs[0][0], want)


def test_band_kernels_unchanged_at_train_band_shape(cuda):
  """K13 and K14 at train_band's shape (256 x 100, band 12, loss_reg
  0.1): K13's scores equal the plain banded DP's bit for bit (it repeats
  the plain version's roundings), K14's gradients match its autograd
  (rtol 1e-4, atol 1e-5)."""
  subs, ins, lens = wavefront_costs(cuda, 256, 100, 100, seed=12)
  weights = torch.rand(256, device=cuda) + 0.5
  got = wavefront_cuda.banded_alignment_scores(subs, ins, 10.0, lens, 12,
                                               0.1)
  want = wavefront.banded_alignment_scan(subs, ins, 10.0, lens, 12, 0.1)
  assert torch.equal(got, want)
  grads = []
  for fn in (wavefront_cuda.banded_alignment_scores_vjp,
             lambda s, i, l, d, r, w: wavefront.banded_alignment_scan(
                 s, i, d, l, w, r)):
    s, i = subs.clone().requires_grad_(True), ins.clone().requires_grad_(True)
    value = fn(s, i, lens, 10.0, 0.1, 12)
    grads.append(torch.autograd.grad(value, (s, i), weights))
  torch.cuda.synchronize()
  for got_grad, want_grad in zip(*grads):
    torch.testing.assert_close(got_grad, want_grad, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('loss_reg', [None, 0.1])
@pytest.mark.parametrize('width', [12, 100])
def test_band_kernels_repeat_bit_for_bit(cuda, loss_reg, width):
  """K13 and K14 at train_band's shape (256 rows, m = 100) with band 12
  (one slot a lane) and 100 (eight): two launches give the same scores,
  rows and gradients bit for bit (K14 sums d_ins without atomics)."""
  subs, ins, lens = wavefront_costs(cuda, 256, 100, 100, seed=width)
  grad = torch.rand(256, device=cuda) + 0.5
  runs = []
  for _ in range(2):
    scores, rows = wavefront_cuda.banded_alignment_scores_with_rows(
        subs, ins, 10.0, lens, width, loss_reg)
    d_subs, d_ins = wavefront_cuda.launch_band_bwd(
        subs, ins, lens, rows, grad, width, 10.0, loss_reg)
    runs.append((scores, rows, d_subs, d_ins))
  torch.cuda.synchronize()
  for first, second in zip(*runs):
    assert torch.equal(first, second)


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


@pytest.mark.parametrize('loss_reg', [None, 0.1])
@pytest.mark.parametrize('b', [1, 5, 256])
@pytest.mark.parametrize('m', [8, 100])
@pytest.mark.parametrize('width_of_m',
                         [1, 12, 'm', 'm+7', 15, 16, 40, 200, 511])
def test_band_kernels_match_plain(cuda, loss_reg, b, m, width_of_m):
  """K13 (without and with rows) and K14 against the plain banded DP
  and its autograd, lengths 0 and m included; at W >= m, K13 against
  K11 as well (the band then holds the whole DP). Widths 15 and 16 are
  the edge of one slot a lane (31 and 33 slots), 40, 100, 200 and 511
  take 4, 8, 16 and 32 slots a lane; at m = 100, W = 511 K14 stores its
  d_subs cells directly (its rows do not fit in shared memory)."""
  width = {'m': m, 'm+7': m + 7}.get(width_of_m, width_of_m)
  subs, ins, lens = wavefront_costs(cuda, b, m, m, seed=b + m + width)
  fwd = wavefront_cuda.n_band_fwd_launches
  bwd = wavefront_cuda.n_band_bwd_launches
  got = wavefront_cuda.banded_alignment_scores(subs, ins, 10.0, lens, width,
                                               loss_reg)
  want = wavefront.banded_alignment_scan(subs, ins, 10.0, lens, width,
                                         loss_reg)
  torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
  if width >= m:
    full = wavefront_cuda.alignment_scores(subs, ins, 10.0, lens, loss_reg)
    torch.testing.assert_close(got, full, rtol=1e-5, atol=1e-4)

  weights = torch.rand(b, device=cuda) + 0.5
  grads = []
  for fn in (wavefront_cuda.banded_alignment_scores_vjp,
             lambda s, i, l, d, r, w: wavefront.banded_alignment_scan(
                 s, i, d, l, w, r)):
    s, i = subs.clone().requires_grad_(True), ins.clone().requires_grad_(True)
    value = fn(s, i, lens, 10.0, loss_reg, width)
    grads.append((value, *torch.autograd.grad(value, (s, i), weights)))
  torch.cuda.synchronize()
  assert wavefront_cuda.n_band_fwd_launches == fwd + 2
  assert wavefront_cuda.n_band_bwd_launches == bwd + 1
  (gv, gs, gi), (wv, ws, wi) = grads
  torch.testing.assert_close(gv, wv, rtol=1e-5, atol=1e-4)
  torch.testing.assert_close(gs, ws, rtol=1e-4, atol=1e-5)
  torch.testing.assert_close(gi, wi, rtol=1e-4, atol=1e-5)
  assert torch.isfinite(gs).all() and torch.isfinite(gi).all()
  i, j = torch.meshgrid(torch.arange(m, device=cuda),
                        torch.arange(m, device=cuda), indexing="ij")
  assert (gs[:, (i - j).abs() > width] == 0).all()


def test_band_wrappers_reject_bad_input(cuda):
  subs, ins, lens = wavefront_costs(cuda, 2, 6, 6, seed=1)
  for width in (0, 512):
    with pytest.raises(ValueError, match='1 <= width'):
      wavefront_cuda.banded_alignment_scores(subs, ins, 1.0, lens, width)
    with pytest.raises(ValueError, match='1 <= width'):
      wavefront_cuda.banded_alignment_scores_vjp(subs, ins, lens, 1.0, 0.1,
                                                 width)
  with pytest.raises(ValueError, match='m == n'):
    wavefront_cuda.banded_alignment_scores(
        torch.zeros(2, 6, 7, device=cuda), torch.zeros(2, 7, device=cuda),
        1.0, lens, 2)
  with pytest.raises(ValueError, match='float32 costs'):
    wavefront_cuda.banded_alignment_scores(subs.double(), ins.double(), 1.0,
                                           lens, 2)
  with pytest.raises(ValueError, match='seq_lens is on'):
    wavefront_cuda.banded_alignment_scores(subs, ins, 1.0, lens.cpu(), 2)


def test_banded_training_step_on_the_card_matches_the_cpu(cuda):
  """One float32 train step with band_width 12, dropout 0, the same
  weights: the card's (K13 with rows, K14) loss within 1e-4 relative of
  the CPU's (the plain banded DP)."""
  from deepconsensus_tpu_torch.models import train as train_lib

  params = small_params(attention_dropout=0.0, relu_dropout=0.0,
                        layer_postprocess_dropout=0.0, band_width=12)
  rows = fake_rows(params, 8, seed=5).numpy()[..., None]
  label = np.random.default_rng(6).integers(0, 5, (8, 100)).astype(
      np.float32)
  state = seeded_model(params, 'cpu').state_dict()
  losses = []
  for device in ('cpu', cuda):
    model = model_lib.DeepConsensusModel(params, device=device)
    model.load_state_dict(state)
    model.requires_grad_(True)
    lamb = train_lib.Lamb(model.named_parameters(), params, 10)
    counts = (wavefront_cuda.n_band_bwd_launches,
              wavefront_cuda.n_bwd_launches)
    m = train_lib.train_step(
        model, lamb, train_lib.make_loss(params),
        train_lib.batch_to_device({'rows': rows, 'label': label}, device),
        torch.Generator(device=device))
    losses.append(float(m['loss']))
    assert (wavefront_cuda.n_band_bwd_launches,
            wavefront_cuda.n_bwd_launches) == (
                counts[0] + (device != 'cpu'), counts[1])
  np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)


def int8_model(params, device):
  """seeded_model's weights loaded as `run --quantize_matmuls int8`
  loads them (in bfloat16 also --inference_dtype bfloat16)."""
  from deepconsensus_tpu_torch.models import quantize

  qparams = config.Params(params, quantize_matmuls='int8')
  if params.dtype == 'bfloat16':
    qparams.inference_dtype = 'bfloat16'
  state, n = quantize.prepare_inference_variables(
      seeded_model(params, 'cpu').state_dict(), qparams)
  assert n == 6 * params.num_hidden_layers
  return model_lib.inference_model(qparams, state, device)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b', [1, 1024])
@pytest.mark.parametrize('with_lengths', [False, True])
def test_k2_int8_kernel_matches_plain(cuda, dtype, b, with_lengths):
  """K2's int8 variant (a full block, then the FFN-only block) against
  its plain version, one int8 launch per block and none of the float
  K2; with lengths at 200-position slots, on valid positions."""
  name = str(dtype).replace('torch.', '')
  length = 200 if with_lengths else 100
  params = small_params(name)
  blocks = int8_model(params, cuda).encoder.kernel_blocks()
  assert blocks[1].wq.values.dtype == torch.int8
  gen = torch.Generator().manual_seed(b + length)
  x = torch.randn((b, length, params.hidden_size), generator=gen).to(
      device=cuda, dtype=dtype)
  lengths = valid = None
  if with_lengths:
    widths = ([[100, 100], [200, 0], [100, 0], [0, 0]] * b)[:b]
    lengths = torch.tensor(widths, dtype=torch.int32, device=cuda)
    valid = rwa.slot_geometry(lengths, length)[3]
  kw = dict(num_heads=params.num_heads, attn_win_size=params.attn_win_size,
            compute_dtype=dtype, lengths=lengths)
  before = (feb.n_launches, feb.n_launches_int8)
  for block in (blocks[1], blocks[0]):
    got = feb.fused_encoder_stack(x, [block], **kw)
    want = feb.fused_encoder_stack_plain(x, [block], **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.isfinite(got).all()
    if valid is not None:
      got, want = got[valid], want[valid]
    torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype])
  assert (feb.n_launches, feb.n_launches_int8) == (before[0], before[1] + 2)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_int8_model_kernels_match_plain(cuda, dtype):
  """The int8 model's encode: K1 on the dequantized layer-0 weights,
  K2 int8 per layer, against the plain versions."""
  params = small_params(str(dtype).replace('torch.', ''))
  model = int8_model(params, cuda)
  rows = fake_rows(params, 37).to(cuda)
  counts = (fwa.n_launches, feb.n_launches, feb.n_launches_int8)
  kernel = model.encode(rows)
  plain = model.encode(rows, plain=True)
  assert (fwa.n_launches, feb.n_launches, feb.n_launches_int8) == (
      counts[0] + 1, counts[1], counts[2] + params.num_hidden_layers)
  torch.testing.assert_close(kernel, plain, rtol=TOL[dtype], atol=TOL[dtype])


def test_k2_int8_wrappers_reject_bad_input(cuda):
  from deepconsensus_tpu_torch.ops import _kernels

  params = small_params()
  block = int8_model(params, cuda).encoder.kernel_blocks()[1]
  x = torch.zeros((2, 100, params.hidden_size), device=cuda)
  kw = dict(num_heads=params.num_heads, attn_win_size=params.attn_win_size)
  with pytest.raises(ValueError, match='scale'):
    feb.fused_encoder_stack(
        x, [block._replace(wk=feb.QuantizedWeight(block.wk.values))], **kw)
  with pytest.raises(ValueError, match='scale shape'):
    feb.fused_encoder_stack(x, [block._replace(w_output=feb.QuantizedWeight(
        block.w_output.values, block.w_output.scale[:-1]))], **kw)
  a = torch.zeros((4, 8), device=cuda)
  b = torch.zeros((8, 3), dtype=torch.int8, device=cuda)
  out = torch.empty((4, 3), device=cuda)
  with pytest.raises(ValueError, match='col_scale'):
    _kernels.gemm(a, b, out)
  with pytest.raises(ValueError, match='col_scale has'):
    _kernels.gemm(a, b, out, col_scale=torch.ones(2, device=cuda))


def _gemm_operands(m, n, k, a_dt, b_dt, gen):
  """Seeded A [m, k] and B [k, n] in the given types, scaled so that the
  product is O(1); an int8 B comes with its float32 column scale."""
  a = torch.randn((m, k), generator=gen).to(a_dt)
  if b_dt == torch.int8:
    b = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
    scale = torch.rand((n,), generator=gen) / (127 * k ** 0.5)
    return a, b, scale
  return a, (torch.randn((k, n), generator=gen) / k ** 0.5).to(b_dt), None


@pytest.mark.parametrize('m', [1, 127, 4097])
@pytest.mark.parametrize('n', [280, 840, 2048])
@pytest.mark.parametrize('k', [280, 2048])
def test_gemm_sweep_matches_plain(cuda, m, n, k):
  """The tensor-core GEMM (_kernels.gemm) against fwa.matmul_plain and
  the epilogue in torch, for A float32 / bfloat16 x B float32 /
  bfloat16 / int8 (with its col_scale), both compute dtypes, with no
  epilogue and with all of it (q scale on the first third, bias, ReLU,
  residual; out and res then in the compute dtype). Tolerance: TOL of
  the output's type (the kernel's pieces reproduce the float32 product
  up to the order of its sums, 2-piece A to 2^-17 of |A| @ |B|)."""
  from deepconsensus_tpu_torch.ops import _kernels

  gen = torch.Generator().manual_seed(m * 7 + n * 3 + k)
  for a_dt in (torch.float32, torch.bfloat16):
    for b_dt in (torch.float32, torch.bfloat16, torch.int8):
      a, b, col_scale = (t if t is None else t.to(cuda)
                         for t in _gemm_operands(m, n, k, a_dt, b_dt, gen))
      w = b if col_scale is None else fwa.QuantizedWeight(b, col_scale)
      y = fwa.matmul_plain(a.float(), w)
      bias = torch.randn((n,), generator=gen).to(cuda)
      alpha = torch.rand((1,), generator=gen).to(cuda)
      for compute in (torch.float32, torch.bfloat16):
        res = torch.randn((m, n), generator=gen).to(device=cuda,
                                                    dtype=compute)
        for full in (False, True):
          out_dt = compute if full else torch.float32
          out = torch.empty((m, n), dtype=out_dt, device=cuda)
          want = y.clone()
          kw = dict(compute_dtype=compute, col_scale=col_scale)
          if full:
            kw.update(scale=0.125, scale_cols=n // 3, bias=bias, relu=True,
                      res=res, alpha=alpha)
            want[:, :n // 3] *= 0.125
            want = res.float() + alpha * torch.relu(want + bias)
          _kernels.gemm(a, b, out, **kw)
          torch.cuda.synchronize()
          torch.testing.assert_close(
              out.float(), want.to(out_dt).float(), rtol=TOL[out_dt],
              atol=TOL[out_dt],
              msg=lambda e: f'{a_dt} x {b_dt}, {compute}, full={full}: {e}')


@pytest.mark.parametrize('m', [1, 127, 4097])
@pytest.mark.parametrize('hidden,filt', [(280, 2048), (280, 64), (136, 96)])
def test_fused_ffn_matches_plain(cuda, m, hidden, filt):
  """The fused FFN (_kernels.ffn) against the two products, bias, ReLU
  and residual in torch, for float32 / bfloat16 weights in their own
  compute dtype and int8 weights in both, with x in float32 and (a
  bfloat16 run's FFN-only block) in bfloat16; H below the kernel's 288
  and M off every tile."""
  from deepconsensus_tpu_torch.ops import _kernels

  gen = torch.Generator().manual_seed(m + hidden + filt)
  cases = [(torch.float32, torch.float32, torch.float32),
           (torch.float32, torch.bfloat16, torch.bfloat16),
           (torch.bfloat16, torch.bfloat16, torch.bfloat16),
           (torch.float32, torch.int8, torch.float32),
           (torch.float32, torch.int8, torch.bfloat16),
           (torch.bfloat16, torch.int8, torch.bfloat16)]
  for x_dt, w_dt, compute in cases:
    x = torch.randn((m, hidden), generator=gen).to(device=cuda, dtype=x_dt)
    wf, fs = (t if t is None else t.to(cuda) for t in _gemm_operands(
        1, filt, hidden, x_dt, w_dt, gen)[1:])
    wo, os_ = (t if t is None else t.to(cuda) for t in _gemm_operands(
        1, hidden, filt, x_dt, w_dt, gen)[1:])
    b_f = torch.randn((filt,), generator=gen).to(cuda)
    b_o = torch.randn((hidden,), generator=gen).to(cuda)
    alpha = torch.rand((1,), generator=gen).to(cuda)
    qf = wf if fs is None else fwa.QuantizedWeight(wf, fs)
    qo = wo if os_ is None else fwa.QuantizedWeight(wo, os_)
    h = torch.relu(fwa.matmul_plain(x.float(), qf) + b_f)
    want = (x.float() + alpha * (fwa.matmul_plain(h, qo) + b_o)).to(compute)
    out = torch.empty((m, hidden), dtype=compute, device=cuda)
    _kernels.ffn(x, wf, wo, out, b_filter=b_f, b_output=b_o, alpha=alpha,
                 compute_dtype=compute, filter_scale=fs, output_scale=os_)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        out.float(), want.float(), rtol=TOL[compute], atol=TOL[compute],
        msg=lambda e: f'{x_dt} x {w_dt}, {compute}: {e}')


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('int8', [False, True])
@pytest.mark.parametrize('with_lengths', [False, True])
def test_k2_ffn_block_matches_plain(cuda, dtype, int8, with_lengths):
  """K2's FFN-only (layer-0 remainder) block, now one fused launch,
  against encoder_block_plain's FFN half, float and int8 weights, with
  and without ragged lengths (position-wise: the same arithmetic)."""
  name = str(dtype).replace('torch.', '')
  params = small_params(name)
  params.filter_size = 2048
  model = int8_model(params, cuda) if int8 else seeded_model(params, cuda)
  block = model.encoder.kernel_blocks()[0]
  assert block.wq is None
  length = 200 if with_lengths else 100
  b = 37
  gen = torch.Generator().manual_seed(length + int8)
  x = torch.randn((b, length, params.hidden_size), generator=gen).to(
      device=cuda, dtype=dtype)
  lengths = None
  if with_lengths:
    widths = ([[100, 100], [200, 0], [100, 0], [0, 0]] * b)[:b]
    lengths = torch.tensor(widths, dtype=torch.int32, device=cuda)
  kw = dict(num_heads=params.num_heads, attn_win_size=params.attn_win_size,
            compute_dtype=dtype, lengths=lengths)
  got = feb.fused_encoder_stack(x, [block], **kw)
  want = feb.fused_encoder_stack_plain(x, [block], **kw)
  torch.cuda.synchronize()
  torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype])


def test_gemm_past_65535_row_tiles(cuda):
  """An A longer than gridDim.y's 65,535 tiles of 128 rows goes through
  the GEMM in row slices; every row, in each slice and across the cut,
  matches the plain product and its residual epilogue."""
  from deepconsensus_tpu_torch.ops import _kernels

  m = 65535 * 128 + 300
  gen = torch.Generator(device=cuda).manual_seed(5)
  a = torch.randn((m, 8), device=cuda, generator=gen).to(torch.bfloat16)
  b = torch.randn((8, 8), device=cuda, generator=gen).to(torch.bfloat16)
  res = torch.randn((m, 8), device=cuda, generator=gen)
  alpha = torch.full((1,), 0.5, device=cuda)
  out = torch.empty((m, 8), device=cuda)
  _kernels.gemm(a, b, out, compute_dtype=torch.bfloat16, res=res,
                alpha=alpha)
  torch.cuda.synchronize()
  want = res + alpha * fwa.matmul_plain(a.float(), b)
  torch.testing.assert_close(out, want, rtol=TOL[torch.float32],
                             atol=TOL[torch.float32])


def test_gemm_and_ffn_reject_bad_shapes(cuda):
  from deepconsensus_tpu_torch.ops import _kernels

  a = torch.zeros((4, 12), device=cuda)
  with pytest.raises(ValueError, match='multiples of 8'):
    _kernels.gemm(a, torch.zeros((12, 8), device=cuda),
                  torch.empty((4, 8), device=cuda))
  x = torch.zeros((4, 296), device=cuda)
  kw = dict(b_filter=torch.zeros(64, device=cuda),
            b_output=torch.zeros(296, device=cuda),
            alpha=torch.zeros(1, device=cuda), compute_dtype=torch.float32)
  with pytest.raises(ValueError, match='H <= 288'):
    _kernels.ffn(x, torch.zeros((296, 64), device=cuda),
                 torch.zeros((64, 296), device=cuda), torch.empty_like(x),
                 **kw)
  x = torch.zeros((4, 280), device=cuda)
  with pytest.raises(ValueError, match='scales'):
    _kernels.ffn(x, torch.zeros((280, 64), dtype=torch.int8, device=cuda),
                 torch.zeros((64, 280), dtype=torch.int8, device=cuda),
                 torch.empty_like(x),
                 **{**kw, 'b_output': torch.zeros(280, device=cuda)})


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


def attention_inputs(device, b, l, h, d, dtype, seed):
  rng = np.random.default_rng(seed)
  q, k, v, do = (torch.from_numpy(rng.normal(size=(b, l, h, d)).astype(
      np.float32)).to(device=device, dtype=dtype) for _ in range(4))
  mask = torch.from_numpy((rng.random((b, h, l, l)) < 0.9).astype(
      np.uint8)).to(device)
  return (q * d ** -0.5).contiguous(), k, v, do, mask


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b,l,h,d,win', [(8, 100, 2, 140, 12),
                                         (5, 57, 3, 40, 12),
                                         (3, 57, 1, 40, None)])
def test_banded_attention_kernels_match_plain(cuda, dtype, b, l, h, d, win):
  """K5, K7 and K6 (with and without the mask), one launch each."""
  q, k, v, do, mask = attention_inputs(cuda, b, l, h, d, dtype, seed=l + d)
  tol = TOL[dtype]
  before = (ba.n_fwd_launches, ba.n_dropout_fwd_launches, ba.n_bwd_launches)
  pairs = [
      (ba.banded_attention(q, k, v, win),
       ba.banded_attention_plain(q, k, v, win)),
      (ba.banded_attention_dropout(q, k, v, mask, win, 0.9),
       ba.banded_attention_dropout_plain(q, k, v, mask, win, 0.9)),
  ]
  for m, keep in ((None, 1.0), (mask, 0.9)):
    pairs += zip(ba.banded_attention_bwd(q, k, v, m, do, win, keep),
                 ba.banded_attention_bwd_plain(q, k, v, m, do, win, keep))
  torch.cuda.synchronize()
  assert (ba.n_fwd_launches, ba.n_dropout_fwd_launches,
          ba.n_bwd_launches) == (before[0] + 1, before[1] + 1, before[2] + 2)
  for got, want in pairs:
    assert got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_banded_attention_wrappers_reject_bad_input(cuda):
  q, k, v, do, mask = attention_inputs(cuda, 2, 16, 2, 8, torch.float32, 0)
  with pytest.raises(ValueError, match='one of'):
    ba.banded_attention(q.half(), k.half(), v.half(), 4)
  with pytest.raises(ValueError, match='contiguous'):
    ba.banded_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k,
                        v, 4)
  with pytest.raises(ValueError, match='mask is on'):
    ba.banded_attention_dropout(q, k, v, mask.cpu(), 4, 0.9)
  with pytest.raises(ValueError, match='mask must be uint8'):
    ba.banded_attention_bwd(q, k, v, mask.bool(), do, 4, 0.9)
  with pytest.raises(ValueError, match='head width'):
    big = torch.zeros(1, 128, 1, 280, device=cuda)
    ba.banded_attention(big, big, big, None)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b', [1, 256])
@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('win', [0, 12, None])
@pytest.mark.parametrize('length', [17, 57, 64, 65, 100, 128])
@pytest.mark.parametrize('d', [8, 35, 140, 256])
def test_k5_k7_tensor_cores_match_plain(cuda, d, length, win, masked, b,
                                        dtype):
  """K5 (masked False) and K7 (keep 0.9), one launch, vs plain on the
  tensor-core tiles' edges, as K6's sweep: odd lengths (mask rows 1-byte
  aligned), one and two 64-row blocks, the train path's 100 and 128 (no
  band: 8 chunks a row); band 0, 12 and none; head widths 8, 35, 140 and
  256 (two column groups); one window and 256."""
  q, k, v, _, mask = attention_inputs(cuda, b, length, 2, d, dtype,
                                      seed=d + length + b)
  if masked:
    before = ba.n_dropout_fwd_launches
    got = ba.banded_attention_dropout(q, k, v, mask, win, 0.9)
    want = ba.banded_attention_dropout_plain(q, k, v, mask, win, 0.9)
    torch.cuda.synchronize()
    assert ba.n_dropout_fwd_launches == before + 1
  else:
    before = ba.n_fwd_launches
    got = ba.banded_attention(q, k, v, win)
    want = ba.banded_attention_plain(q, k, v, win)
    torch.cuda.synchronize()
    assert ba.n_fwd_launches == before + 1
  assert got.dtype == dtype and torch.isfinite(got.float()).all()
  torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('length,win', [(100, 12), (128, None), (57, 12)])
def test_k5_k7_repeat_bit_for_bit(cuda, dtype, length, win):
  """K5 and K7 twice on the same inputs: the same bits (no atomics;
  every output element written once)."""
  q, k, v, _, mask = attention_inputs(cuda, 64, length, 2, 140, dtype, 4)
  for fn in (lambda: ba.banded_attention(q, k, v, win),
             lambda: ba.banded_attention_dropout(q, k, v, mask, win, 0.9)):
    first, second = fn(), fn()
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_k5_k7_blocks_an_sm(cuda):
  """At the main path's head width (140) the forward (K5 and K7) holds
  at least two float32 blocks an SM and three bf16 ones, registers and
  shared memory counted, and refuses a width it does not have."""
  from deepconsensus_tpu_torch.ops import _build

  lib = _build.load('banded_attention')
  assert lib.dc_banded_attention_blocks_per_sm(0, 0, 140) >= 2
  assert lib.dc_banded_attention_blocks_per_sm(0, 1, 140) >= 3
  assert lib.dc_banded_attention_blocks_per_sm(0, 1, 264) < 0
  assert lib.dc_banded_attention_blocks_per_sm(-1, 1, 140) < 0


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b', [1, 256])
@pytest.mark.parametrize('masked', [False, True])
@pytest.mark.parametrize('win', [0, 12, None])
@pytest.mark.parametrize('length', [17, 57, 64, 65, 100, 128])
@pytest.mark.parametrize('d', [8, 35, 140, 256])
def test_k6_tensor_cores_match_plain(cuda, d, length, win, masked, b, dtype):
  """K6 (dq, dk, dv), one launch, vs plain on the tensor-core tiles'
  edges: odd lengths (17, 57: mask rows 1-byte aligned), one and two
  64-row blocks (64, 65), the train path's 100 and the fused route's
  longest, 128 (no band: 8 chunks a row); the diagonal alone, band 12
  and none; narrow (8), odd (35), the main path's 140 and two column
  groups (256); one window and 256."""
  q, k, v, do, mask = attention_inputs(cuda, b, length, 2, d, dtype,
                                       seed=d + length + b)
  m, keep = (mask, 0.9) if masked else (None, 1.0)
  before = ba.n_bwd_launches
  got = ba.banded_attention_bwd(q, k, v, m, do, win, keep)
  want = ba.banded_attention_bwd_plain(q, k, v, m, do, win, keep)
  torch.cuda.synchronize()
  assert ba.n_bwd_launches == before + 1
  for g, w in zip(got, want):
    assert g.dtype == dtype and torch.isfinite(g.float()).all()
    torch.testing.assert_close(g, w, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('length,win', [(100, 12), (128, None), (57, 12)])
def test_k6_repeats_bit_for_bit(cuda, dtype, length, win):
  """K6 with the mask twice on the same inputs: the same bits (no
  atomics; every output element and statistic written once)."""
  q, k, v, do, mask = attention_inputs(cuda, 64, length, 2, 140, dtype, 3)
  runs = [ba.banded_attention_bwd(q, k, v, mask, do, win, 0.9)
          for _ in range(2)]
  torch.cuda.synchronize()
  for first, second in zip(*runs):
    assert torch.equal(first, second)


def test_k6_passes_fit_two_blocks_an_sm(cuda):
  """At the main path's head width (140) both K6 passes hold at least
  two blocks an SM in both dtypes, registers and shared memory counted,
  and refuse a pass or width they do not have."""
  from deepconsensus_tpu_torch.ops import _build

  lib = _build.load('banded_attention')
  for n in (1, 2):
    for is_bf16 in (0, 1):
      assert lib.dc_banded_attention_blocks_per_sm(n, is_bf16, 140) >= 2
  assert lib.dc_banded_attention_blocks_per_sm(3, 0, 140) < 0
  assert lib.dc_banded_attention_blocks_per_sm(1, 0, 264) < 0
  q, k, v, do, _ = attention_inputs(cuda, 1, 16, 1, 264, torch.float32, 0)
  with pytest.raises(ValueError, match='head width'):
    ba.banded_attention_bwd(q, k, v, None, do, 4, 1.0)


def test_training_step_with_attention_kernels_matches_the_cpu(cuda):
  """One float32 train step with use_pallas_attention, dropout 0: the
  card's (K5 forward and K6 backward per layer, K11/K12) loss within
  1e-4 relative of the CPU's (plain versions)."""
  from deepconsensus_tpu_torch.models import train as train_lib

  params = small_params(attention_dropout=0.0, relu_dropout=0.0,
                        layer_postprocess_dropout=0.0,
                        use_pallas_attention=True)
  rows = fake_rows(params, 8, seed=5).numpy()[..., None]
  label = np.random.default_rng(6).integers(0, 5, (8, 100)).astype(
      np.float32)
  state = seeded_model(params, 'cpu').state_dict()
  losses = []
  for device in ('cpu', cuda):
    model = model_lib.DeepConsensusModel(params, device=device)
    model.load_state_dict(state)
    model.requires_grad_(True)
    lamb = train_lib.Lamb(model.named_parameters(), params, 10)
    before = (ba.n_fwd_launches, ba.n_bwd_launches)
    m = train_lib.train_step(
        model, lamb, train_lib.make_loss(params),
        train_lib.batch_to_device({'rows': rows, 'label': label}, device),
        torch.Generator(device=device))
    losses.append(float(m['loss']))
    n = params.num_hidden_layers * (device != 'cpu')
    assert (ba.n_fwd_launches, ba.n_bwd_launches) == (before[0] + n,
                                                      before[1] + n)
  np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)


def flash_inputs(device, b, length, dtype, seed, h=2, d=140):
  """q (scaled by d^-1/2), k, v, do [b, length, h, d] from a seeded
  generator on the card."""
  gen = torch.Generator(device=device).manual_seed(seed)
  q, k, v, do = (torch.randn((b, length, h, d), generator=gen, device=device)
                 .to(dtype) for _ in range(4))
  return (q * d ** -0.5).contiguous(), k, v, do


def flash_launches():
  return (fba.n_fwd_launches, fba.n_fwd_lse_launches, fba.n_dq_launches,
          fba.n_dkdv_launches)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b', [1, 256])
@pytest.mark.parametrize('length', [129, 200, 255, 257, 384])
@pytest.mark.parametrize('win', [0, 12, 130, None])
def test_flash_band_kernels_match_plain(cuda, dtype, b, length, win):
  """K8 without and with lse, K9 and K10 (on the plain lse and delta),
  one launch each, at full head width: past any tile multiple (129,
  200, 255), past 256 (257, 384), with the diagonal alone (win 0), a band
  wider than a tile (130) and no band."""
  q, k, v, do = flash_inputs(cuda, b, length, dtype, seed=length + b)
  tol = TOL[dtype]
  before = flash_launches()
  o = fba.flash_band_attention(q, k, v, win)
  o_lse, lse = fba.flash_band_attention(q, k, v, win, with_lse=True)
  want_o, want_lse = fba.flash_band_attention_plain(q, k, v, win,
                                                    with_lse=True)
  delta = fba.row_delta(do, want_o)
  dq = fba.flash_band_dq(q, k, v, do, want_lse, delta, win)
  dk, dv = fba.flash_band_dkdv(q, k, v, do, want_lse, delta, win)
  want_dq = fba.flash_band_dq_plain(q, k, v, do, want_lse, delta, win)
  want_dk, want_dv = fba.flash_band_dkdv_plain(q, k, v, do, want_lse, delta,
                                               win)
  torch.cuda.synchronize()
  assert flash_launches() == tuple(n + 1 for n in before)
  assert torch.equal(o, o_lse)
  torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
  for got, want in ((o, want_o), (dq, want_dq), (dk, want_dk),
                    (dv, want_dv)):
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_flash_band_wrappers_reject_bad_input(cuda):
  q, k, v, do = flash_inputs(cuda, 2, 140, torch.float32, 0, d=8)
  lse = torch.zeros(2, 2, 140, device=cuda)
  with pytest.raises(ValueError, match='one of'):
    fba.flash_band_attention(q.half(), k.half(), v.half(), 4)
  with pytest.raises(ValueError, match='contiguous'):
    fba.flash_band_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                             k, v, 4)
  with pytest.raises(ValueError, match='k is on'):
    fba.flash_band_attention(q, k.cpu(), v, 4)
  with pytest.raises(ValueError, match='lse is on'):
    fba.flash_band_dq(q, k, v, do, lse.cpu(), lse, 4)
  with pytest.raises(ValueError, match='delta shape'):
    fba.flash_band_dkdv(q, k, v, do, lse, lse[:, :1].contiguous(), 4)
  with pytest.raises(ValueError, match='head width'):
    wide = torch.zeros(1, 140, 1, 264, device=cuda)
    fba.flash_band_attention(wide, wide, wide, 4)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('d', [8, 35, 72, 140, 256])
@pytest.mark.parametrize('length', [129, 200])
@pytest.mark.parametrize('win', [0, 12, None])
def test_flash_tensor_core_kernels_across_head_widths(cuda, dtype, d, length,
                                                      win):
  """K8 without and with lse, K9 and K10 (on the plain lse and delta) vs
  plain at narrow heads (8, 72), an odd width (35: bf16 rows copied 2
  bytes at a time, unpaired stores), the main path's 140 (padded to 144)
  and the widest, 256 (two column groups of output tiles)."""
  q, k, v, do = flash_inputs(cuda, 3, length, dtype, seed=d + length, d=d)
  tol = TOL[dtype]
  o = fba.flash_band_attention(q, k, v, win)
  o_lse, lse = fba.flash_band_attention(q, k, v, win, with_lse=True)
  want_o, want_lse = fba.flash_band_attention_plain(q, k, v, win,
                                                    with_lse=True)
  delta = fba.row_delta(do, want_o)
  dq = fba.flash_band_dq(q, k, v, do, want_lse, delta, win)
  dk, dv = fba.flash_band_dkdv(q, k, v, do, want_lse, delta, win)
  want_dq = fba.flash_band_dq_plain(q, k, v, do, want_lse, delta, win)
  want_dk, want_dv = fba.flash_band_dkdv_plain(q, k, v, do, want_lse, delta,
                                               win)
  torch.cuda.synchronize()
  assert torch.equal(o, o_lse)
  torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
  for got, want in ((o, want_o), (dq, want_dq), (dk, want_dk),
                    (dv, want_dv)):
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('length,win', [(200, 12), (384, None)])
def test_flash_tensor_core_kernels_repeat_bit_for_bit(cuda, dtype, length,
                                                      win):
  """K8 with lse, K9 and K10 twice on the same inputs: the same bits (no
  atomics; every output element written once)."""
  q, k, v, do = flash_inputs(cuda, 32, length, dtype, seed=11)
  runs = []
  for _ in range(2):
    o, lse = fba.flash_band_attention(q, k, v, win, with_lse=True)
    delta = fba.row_delta(do, o)
    runs.append((o, lse, fba.flash_band_dq(q, k, v, do, lse, delta, win),
                 *fba.flash_band_dkdv(q, k, v, do, lse, delta, win)))
  torch.cuda.synchronize()
  for first, second in zip(*runs):
    assert torch.equal(first, second)


def test_flash_tensor_core_kernels_fit_two_blocks_an_sm(cuda):
  """At the main path's head width (140) the largest shared memory of
  the three flash kernels, either dtype, leaves room for two blocks an SM
  ((233,472 - 2 x 1,024) / 2 bytes), and K8, K10 and K9 hold at least
  two blocks an SM in both dtypes, registers and shared memory counted
  (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
  from deepconsensus_tpu_torch.ops import _build

  lib = _build.load('flash_band_attention')
  assert lib.dc_flash_band_smem_bytes(140) <= 115_712
  for kernel in (0, 1, 2):  # K8, K10, K9
    for is_bf16 in (0, 1):
      assert lib.dc_flash_band_blocks_per_sm(kernel, is_bf16, 140) >= 2


def test_training_step_with_flash_kernels_matches_the_cpu(cuda):
  """One float32 train step at L = 200 with use_pallas_attention and
  dropout 0: the card's (K8 with lse, K9 and K10 per layer, K11/K12 at
  m = 200) loss within 1e-4 relative of the CPU's (plain versions)."""
  from deepconsensus_tpu_torch.models import train as train_lib

  params = small_params(length=200, attention_dropout=0.0, relu_dropout=0.0,
                        layer_postprocess_dropout=0.0,
                        use_pallas_attention=True)
  rows = fake_rows(params, 8, seed=7).numpy()[..., None]
  label = np.random.default_rng(8).integers(0, 5, (8, 200)).astype(
      np.float32)
  state = seeded_model(params, 'cpu').state_dict()
  losses = []
  for device in ('cpu', cuda):
    model = model_lib.DeepConsensusModel(params, device=device)
    model.load_state_dict(state)
    model.requires_grad_(True)
    lamb = train_lib.Lamb(model.named_parameters(), params, 10)
    before = flash_launches()
    m = train_lib.train_step(
        model, lamb, train_lib.make_loss(params),
        train_lib.batch_to_device({'rows': rows, 'label': label}, device),
        torch.Generator(device=device))
    losses.append(float(m['loss']))
    n = params.num_hidden_layers * (device != 'cpu')
    assert flash_launches() == (before[0], before[1] + n, before[2] + n,
                                before[3] + n)
  np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4)


def slot_lengths(length, n, device):
  """[n, 2] int32 window widths cycling through one full window, two
  halves, a lone half and an empty slot."""
  half = length // 2
  widths = [[length, 0], [half, length - half], [half, 0], [0, 0]]
  return torch.tensor((widths * n)[:n], dtype=torch.int32, device=device)


@pytest.mark.parametrize('softmax_dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('length', [100, 128, 200])
@pytest.mark.parametrize('win', ['12', 'L-1', 'none'])
@pytest.mark.parametrize('ragged', [False, True])
def test_attention_core_sweep(cuda, softmax_dtype, length, win, ragged):
  """The tensor-core attention core against attention_core_plain on
  valid positions, in both softmax dtypes: one key block (band 12) or
  several in two passes (L - 1, and no band, whose wrapper passes a
  band wider than the slot), with and without ragged slots; 37 rows,
  one 64-query tile short at L = 100 and 200. Tolerance: 1e-4 for a
  float32 softmax, 2e-2 for bfloat16."""
  from deepconsensus_tpu_torch.ops import _kernels

  batch, hidden, heads = 37, 280, 2
  w = {'12': 12, 'L-1': length - 1, 'none': None}[win]
  kernel_win = length - 1 if w is None else w
  gen = torch.Generator().manual_seed(length)
  qkv = torch.randn(batch * length, 3 * hidden, generator=gen).to(cuda)
  qkv[:, :hidden] *= (hidden // heads) ** -0.5  # q pre-scaled, as K1/K2's
  lengths = slot_lengths(length, batch, cuda) if ragged else None
  mask = (rwa.ragged_attention_mask(lengths, length, w) if ragged
          else None)
  valid = (rwa.slot_geometry(lengths, length)[3].reshape(-1) if ragged
           else torch.ones(batch * length, dtype=torch.bool, device=cuda))
  out = torch.full((batch * length, hidden), float('nan'), device=cuda)
  before = (_kernels.n_attention_launches,
            _kernels.n_attention_bf16_softmax_launches)
  _kernels.attention(qkv, out, batch=batch, length=length, num_heads=heads,
                     win=kernel_win, lengths=lengths,
                     softmax_dtype=softmax_dtype)
  want = fwa.attention_core_plain(
      qkv, batch=batch, length=length, num_heads=heads, attn_win_size=w,
      mask=mask, softmax_dtype=softmax_dtype)
  torch.cuda.synchronize()
  bf = softmax_dtype == torch.bfloat16
  assert (_kernels.n_attention_launches - before[0],
          _kernels.n_attention_bf16_softmax_launches - before[1]) == (
              (0, 1) if bf else (1, 0))
  assert torch.isfinite(out).all()
  assert (out[~valid] == 0).all()
  tol = TOL[softmax_dtype]
  torch.testing.assert_close(out[valid], want[valid], rtol=tol, atol=tol)


@pytest.mark.parametrize('heads', [4, 8])
@pytest.mark.parametrize('softmax_dtype', [torch.float32, torch.bfloat16])
def test_attention_core_narrow_heads(cuda, heads, softmax_dtype):
  """head_dim 70 and 35 (hidden 280): 4-byte copies and scalar q loads,
  zero padding to 80 and 48 columns."""
  from deepconsensus_tpu_torch.ops import _kernels

  batch, length, hidden = 9, 100, 280
  gen = torch.Generator().manual_seed(heads)
  qkv = torch.randn(batch * length, 3 * hidden, generator=gen).to(cuda)
  out = torch.empty((batch * length, hidden), device=cuda)
  _kernels.attention(qkv, out, batch=batch, length=length, num_heads=heads,
                     win=12, softmax_dtype=softmax_dtype)
  want = fwa.attention_core_plain(
      qkv, batch=batch, length=length, num_heads=heads, attn_win_size=12,
      softmax_dtype=softmax_dtype)
  tol = TOL[softmax_dtype]
  torch.testing.assert_close(out, want, rtol=tol, atol=tol)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('ragged', [False, True])
def test_bf16_softmax_model_kernels_match_plain(cuda, dtype, ragged):
  """attn_softmax_dtype=bfloat16 through K1 or K4 and K2 (one launch of
  each per layer, counted apart from the float32 softmax's), against
  the plain versions: the model's probabilities within 2e-2 and its
  calls agreeing on > 99.9% of the positions in float32 (the
  reference's bar for the lever, tests/test_model.py). A logit on a bf16 rounding edge
  rounds either way in the two versions' float32 sums, so the encoder's
  LayerNorm output is no place for an elementwise bound."""
  params = small_params(str(dtype).replace('torch.', ''),
                        window_buckets=[100, 200],
                        attn_softmax_dtype='bfloat16')
  model = seeded_model(params, cuda)
  lengths = slot_lengths(200, 37, cuda) if ragged else None
  rows = fake_rows(params, 37, length=200 if ragged else 100).to(cuda)
  valid = torch.ones(rows.shape[0], rows.shape[2], dtype=torch.bool,
                     device=cuda)
  if ragged:
    valid = rwa.slot_geometry(lengths, 200)[3]
    rows = rows * valid[:, None, :]
  first = rwa if ragged else fwa
  counts = (first.n_launches, first.n_launches_bf16_softmax,
            feb.n_launches, feb.n_launches_bf16_softmax)
  kernel = model(rows, window_lengths=lengths)
  plain = model(rows, plain=True, window_lengths=lengths)
  layers = params.num_hidden_layers
  assert (first.n_launches, first.n_launches_bf16_softmax, feb.n_launches,
          feb.n_launches_bf16_softmax) == (
              counts[0], counts[1] + 1, counts[2], counts[3] + layers)
  torch.testing.assert_close(kernel[valid], plain[valid], rtol=0, atol=2e-2)
  agree = (kernel[valid].argmax(-1) == plain[valid].argmax(-1)).float()
  # bfloat16 activations take the port's bf16 bar (PERF.md): >= 99%.
  assert agree.mean() > 0.999 if dtype == torch.float32 else (
      agree.mean() >= 0.99)


def test_k1_on_a_second_card_launches_there(cuda):
  """The launch helper makes the operands' card current: one K1 launch
  on cuda:1 gives the plain version's result on cuda:1 and cuda:0's
  kernel result."""
  if torch.cuda.device_count() < 2:
    pytest.skip('needs a second CUDA device')
  params = small_params()
  results = []
  for device in (torch.device('cuda:0'), torch.device('cuda:1')):
    model = seeded_model(params, device)
    rows = fake_rows(params, 5).to(device)
    results.append(model.encode(rows))
    torch.testing.assert_close(results[-1], model.encode(rows, plain=True),
                               rtol=1e-4, atol=1e-4)
  assert results[1].device == torch.device('cuda:1')
  torch.testing.assert_close(results[1].cpu(), results[0].cpu(), rtol=0,
                             atol=0)


def _as_window_rows(rows):
  """[B, R, L] model rows -> the [B, R, L, 1] formatted rows a pack
  carries (the SN rows constant across each window)."""
  rows = rows.clone()
  rows[:, -4:] = rows[:, -4:, :1]
  return rows[..., None].numpy()


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_runner_pipeline_matches_synchronous_packs(cuda, dtype):
  """ModelRunner on the card with two packs in flight a ring of two
  pinned input and three output slots: seven packs dispatched before
  any finalize (output slots reused before their pack's finalize are
  drained first) give the same bits as the same packs run one at a
  time, and every pack's copies and forward show in the CUDA-event
  times."""
  params = small_params(dtype)
  state = seeded_model(params, 'cpu').state_dict()
  run = runner.ModelRunner(
      params, state, runner.InferenceOptions(batch_size=8,
                                             dispatch_depth=2), cuda)
  packs = [_as_window_rows(fake_rows(params, n, seed=n))
           for n in (8, 3, 8, 1, 8, 5, 8)]
  want = [run.predict(p) for p in packs]
  run.reset_timing()
  handles = [run.dispatch(p) for p in packs]
  for (wid, wq), handle, pack in zip(want, handles, packs):
    ids, quals = run.finalize(handle)
    assert ids.shape == quals.shape == (len(pack), 100)
    np.testing.assert_array_equal(ids, wid)
    np.testing.assert_array_equal(quals, wq)
  times = run.device_seconds()
  assert times['h2d_seconds'] > 0 and times['device_forward_seconds'] > 0
  # Busy time is the union of the intervals: forwards share one stream,
  # and an H2D copy that overlaps a forward counts once.
  parts = (times['h2d_seconds'] + times['device_forward_seconds']
           + times['d2h_seconds'])
  assert (times['device_forward_seconds'] - 1e-5
          <= times['model_device_seconds'] <= parts + 1e-5)
  assert 0 <= times['model_idle_share'] < 1
  stats = run.dispatch_stats()
  assert stats['n_transfer_overlapped'] + stats['n_transfer_direct'] == 7


def test_ragged_window_bits_depend_only_on_its_offset(cuda):
  """What the ragged packer's dummy windows rely on: a window's outputs
  are the same bits at the same slot offset whatever shares its slot (a
  neighbour, a zero dummy window, or nothing), in float32 and bfloat16."""
  for dtype in ('float32', 'bfloat16'):
    params = small_params(dtype, window_buckets=[100, 200])
    model = seeded_model(params, cuda)
    a, b = fake_rows(params, 2, seed=3)
    zero = torch.zeros_like(a)
    rows = torch.stack([torch.cat([a, b], 1), torch.cat([a, zero], 1),
                        torch.cat([zero, b], 1)]).to(cuda)
    lengths = torch.tensor([[100, 100], [100, 0], [100, 100]],
                           dtype=torch.int32, device=cuda)
    out = model(rows, window_lengths=lengths)
    assert torch.equal(out[0, :100], out[1, :100])
    assert torch.equal(out[0, 100:], out[2, 100:])


def test_watchdog_gives_up_on_a_spun_pack_and_retires_its_slots(
    cuda, monkeypatch):
  """A hang injected at pack 1 spins the card 3 s behind that pack's
  output copy: finalize raises DispatchTimeoutError after the 0.5 s
  timeout while the card has not reached the pack's event; the pack's
  pinned input and output buffers are set aside and no later pack gets
  them until the event completes; later packs keep running beside the
  spin and give the bits they give without it."""
  params = small_params()
  state = seeded_model(params, 'cpu').state_dict()
  packs = [_as_window_rows(fake_rows(params, 8, seed=n)) for n in range(7)]
  want = [runner.ModelRunner(
      params, state, runner.InferenceOptions(batch_size=8),
      cuda).predict(p) for p in packs]
  monkeypatch.setenv(faults.ENV_DEVICE_HANG_AT_PACK, '1')
  monkeypatch.setenv(faults.ENV_DEVICE_HANG_S, '3')
  faults._fired.clear()
  run = runner.ModelRunner(
      params, state, runner.InferenceOptions(
          batch_size=8, dispatch_depth=2, dispatch_timeout=0.5), cuda)
  spins = device_spin.n_launches
  hung = run.dispatch(packs[0])
  assert device_spin.n_launches == spins + 1
  t0 = time.monotonic()
  with pytest.raises(faults.DispatchTimeoutError, match='watchdog'):
    run.finalize(hung)
  assert time.monotonic() - t0 < 2
  assert not hung.events[-1].query()
  retired = {t.data_ptr() for ring in (hung.in_ring, hung.ring)
             for bufs, _ in ring.retired for t in bufs.values()}
  assert len(retired) == 4  # main, sn; ids, quals
  for pack, (wid, wq) in zip(packs[1:], want[1:]):
    handle = run.dispatch(pack)
    taken = [t.data_ptr() for t in handle.in_ring._slots[
        handle.in_slot].values()] + [t.data_ptr() for t in handle.host_out]
    if not hung.events[-1].query():
      assert not retired & set(taken)
    ids, quals = run.finalize(handle)
    np.testing.assert_array_equal(ids, wid)
    np.testing.assert_array_equal(quals, wq)
  faults._fired.clear()
  hung.events[-1].synchronize()
  run.finalize(run.dispatch(packs[0]))
  assert not hung.in_ring.retired and not hung.ring.retired


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_half_batch_packs_give_the_full_packs_bits(cuda, dtype):
  """OOM bisection's halves: the same rows at batch 8 instead of 16 go
  through K1, K2 and K3 again and give the same ids and qualities, and
  K1 and K2 the same encodings, bit for bit."""
  params = small_params(dtype)
  state = seeded_model(params, 'cpu').state_dict()
  run = runner.ModelRunner(params, state,
                           runner.InferenceOptions(batch_size=16), cuda)
  rows = _as_window_rows(fake_rows(params, 16, seed=9))
  full_ids, full_quals = run.predict(rows)
  before = (fwa.n_launches, feb.n_launches, output_plane.n_launches)
  halves = [run.finalize(run.dispatch(rows[lo:lo + 8], batch_size=8))
            for lo in (0, 8)]
  assert (fwa.n_launches - before[0], feb.n_launches - before[1],
          output_plane.n_launches - before[2]) == (
              2, 2 * params.num_hidden_layers, 2)
  np.testing.assert_array_equal(
      np.concatenate([h[0] for h in halves]), full_ids)
  np.testing.assert_array_equal(
      np.concatenate([h[1] for h in halves]), full_quals)
  # K1 and K2 (the model's encode) give each window the same bits at
  # either batch.
  model_rows = fake_rows(params, 16, seed=9).to(cuda)
  with torch.no_grad():
    full = run.model.encode(model_rows)
    halves = torch.cat([run.model.encode(model_rows[:8]),
                        run.model.encode(model_rows[8:])])
  assert torch.equal(halves, full)


def test_cuda_out_of_memory_is_a_device_oom_error(cuda):
  with pytest.raises(torch.cuda.OutOfMemoryError) as info:
    torch.empty(1 << 48, dtype=torch.uint8, device=cuda)
  error = faults.classify_device_error(info.value)
  assert isinstance(error, faults.DeviceOomError)
  assert error.__cause__ is info.value and error.kind == 'transient'
