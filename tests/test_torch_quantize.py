"""The port's inference levers (int8 matmuls, bfloat16 weights), K2's
int8 variant, the alignment identity metric and `run_evaluation`
against the JAX package, on the CPU.

The same seeded inputs go through both packages (2 layers, filter 64,
as tests/test_quantized_inference.py). Tolerances:

* quantization and the bfloat16 cast: bit-equal (int8 values, float32
  scales, dequantized and cast leaves);
* K2 int8 plain vs the reference's Pallas kernel (interpret mode) and
  its pure-jnp oracle: float32 atol 1e-5;
* the int8 model vs Flax: float32 atol 1e-5; bfloat16 + int8 atol 5e-2
  with argmax agreement >= 0.98 (bfloat16 rounds at other places in the
  two frameworks);
* AlignmentMetric and run_evaluation: every value within 1e-5;
* `cli run` with the levers vs the reference's run_inference: float32
  ids identical and qualities within 1; bfloat16 ids on >= 99% of bases
  and qualities within BF16_QV_GATE where the read agrees.
"""
import json

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepconsensus_tpu.inference import runner as jax_runner
from deepconsensus_tpu.io import Example, TFRecordWriter
from deepconsensus_tpu.models import config as jax_config
from deepconsensus_tpu.models import evaluate as jax_evaluate
from deepconsensus_tpu.models import metrics as jax_metrics
from deepconsensus_tpu.models import model as jax_model
from deepconsensus_tpu.models import quantize as jax_quantize
from deepconsensus_tpu.ops import fused_encoder_block as jax_feb
from deepconsensus_tpu_torch import cli
from deepconsensus_tpu_torch.models import config as torch_config
from deepconsensus_tpu_torch.models import evaluate as torch_evaluate
from deepconsensus_tpu_torch.models import metrics as torch_metrics
from deepconsensus_tpu_torch.models import model as torch_model
from deepconsensus_tpu_torch.models import quantize
from deepconsensus_tpu_torch.models import weights as weights_lib
from deepconsensus_tpu_torch.ops import fused_encoder_block as feb
from deepconsensus_tpu_torch.testing import synthetic

SMALL = dict(dtype='float32', num_hidden_layers=2, filter_size=64,
             batch_size=4)


def jax_params(**kw):
  params = jax_config.get_config('transformer_learn_values+test')
  jax_config.finalize_params(params, is_training=False)
  with params.unlocked():
    for k, v in {**SMALL, **kw}.items():
      params[k] = v
  return params


def torch_params(**kw):
  params = torch_config.get_config('transformer_learn_values+test')
  torch_config.finalize_params(params)
  params.update({**SMALL, **kw})
  return params


@pytest.fixture(scope='module')
def variables():
  """One Flax init with non-zero ReZero alphas."""
  params = jax_params()
  variables = jax_model.get_model(params).init(
      jax.random.PRNGKey(0), jnp.zeros((1, params.total_rows, 100, 1)))
  flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(variables))
  rng = np.random.default_rng(1)
  for key in flat:
    if key[-1] == 'alpha':
      flat[key] = jnp.asarray(rng.uniform(0.5, 1.0), jnp.float32)
  return flax.traverse_util.unflatten_dict(flat)


def port_state(variables, params):
  """The Flax tree as the port's state dict, levers applied."""
  state = weights_lib.from_flax_params(
      jax.device_get(variables['params']), params)
  return quantize.prepare_inference_variables(state, params)


def bits(a) -> np.ndarray:
  """The raw bits of a float32 or bfloat16 array or tensor."""
  if isinstance(a, torch.Tensor):
    a = a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32)
    return a.numpy()
  a = np.asarray(a)
  return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def fake_rows(params, batch, seed):
  rng = np.random.default_rng(seed)
  mp = params.max_passes
  rows = np.zeros((batch, params.total_rows, params.max_length, 1),
                  np.float32)
  rows[:, :mp] = rng.integers(0, 5, rows[:, :mp].shape)
  rows[:, mp:3 * mp] = rng.integers(0, 256, rows[:, mp:3 * mp].shape)
  rows[:, 3 * mp:4 * mp] = rng.integers(0, 3, rows[:, :mp].shape)
  rows[:, 4 * mp] = rng.integers(0, 5, rows[:, 4 * mp].shape)
  rows[:, 4 * mp + 1:] = rng.integers(0, 501, rows[:, 4 * mp + 1:].shape)
  return rows


# ---------------------------------------------------------------------------
# The levers: bit-equal to JAX's.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('inference_dtype', [None, 'bfloat16'])
def test_prepare_inference_variables_bit_equal_to_jax(variables,
                                                      inference_dtype):
  levers = dict(quantize_matmuls='int8', inference_dtype=inference_dtype)
  want, n_want = jax_quantize.prepare_inference_variables(
      variables, jax_params(**levers))
  got, n_got = port_state(variables, torch_params(**levers))
  assert n_got == n_want == 12
  expected = set()
  for path, leaf in weights_lib.flatten_tree(want['params']).items():
    name = path.replace('/', '.')
    expected.add(name)
    assert str(got[name].dtype) == f'torch.{np.asarray(leaf).dtype}', name
    np.testing.assert_array_equal(bits(got[name]), bits(leaf), err_msg=name)
  for path, leaf in weights_lib.flatten_tree(
      want['quant']['encoder']).items():
    module, sub, kind = path.split('/')
    name = f'encoder.{module}.{sub}.quant_{kind}'
    expected.add(name)
    # The bfloat16 cast leaves the int8 values and float32 scales alone.
    assert got[name].dtype == (torch.int8 if kind == 'values'
                               else torch.float32)
    np.testing.assert_array_equal(got[name].numpy(), np.asarray(leaf))
  assert set(got) == expected


def test_levers_off_and_unknown_values():
  state = {'encoder.ffn_0.filter_layer.kernel': torch.ones(3, 2)}
  out, n = quantize.prepare_inference_variables(
      state, torch_params(quantize_matmuls='none'))
  assert n == 0 and out is state
  values, scale = quantize._quantize_2d(torch.zeros(4, 3))
  assert torch.equal(scale, torch.ones(3)) and not values.any()
  with pytest.raises(NotImplementedError, match='int4'):
    quantize.prepare_inference_variables(
        state, torch_params(quantize_matmuls='int4'))


# ---------------------------------------------------------------------------
# K2 int8: plain vs the reference's Pallas kernel and jnp oracle.
# ---------------------------------------------------------------------------

HIDDEN, HEADS, LENGTH, FILTER = 32, 4, 16, 48


def random_block(rng, has_attn=True, quantized=True):
  """(JAX block, port block) from one set of numpy weights; quantized
  weights go through the reference's _quantize_2d."""
  jw, tw = [], []

  def weight(*shape):
    w = rng.normal(0, 0.2, shape).astype(np.float32)
    if quantized:
      values, scale = jax_quantize._quantize_2d(jnp.asarray(w))
      jw.append(jax_feb.QuantizedWeight(values, scale))
      tw.append(feb.QuantizedWeight(
          torch.from_numpy(np.array(values)),
          torch.from_numpy(np.array(scale))))
    else:
      jw.append(jax_feb.QuantizedWeight(jnp.asarray(w), None))
      tw.append(torch.from_numpy(w))

  vec = lambda n: rng.normal(0, 0.1, n).astype(np.float32)
  if has_attn:
    for _ in range(4):
      weight(HIDDEN, HIDDEN)
    attn_alpha = np.float32(0.7)
  else:
    jw += [None] * 4
    tw += [None] * 4
    attn_alpha = None
  weight(HIDDEN, FILTER)
  weight(FILTER, HIDDEN)
  b_filter, b_output = vec(FILTER), vec(HIDDEN)
  ffn_alpha = np.float32(0.9)
  to_t = lambda a: None if a is None else torch.from_numpy(np.array(a))
  to_j = lambda a: None if a is None else jnp.asarray(a)
  jblock = jax_feb.EncoderBlockWeights(
      *jw[:4], to_j(attn_alpha), jw[4], to_j(b_filter), jw[5],
      to_j(b_output), to_j(ffn_alpha))
  tblock = feb.EncoderBlockWeights(
      *tw[:4], to_t(attn_alpha), tw[4], to_t(b_filter), tw[5],
      to_t(b_output), to_t(ffn_alpha))
  return jblock, tblock


# Ragged slots of LENGTH positions holding windows of 8 or 16.
SLOT_LENGTHS = np.array([[8, 8], [16, 0], [8, 0], [0, 0], [16, 0]],
                        np.int32)


@pytest.mark.parametrize('attn_win_size', [None, 5])
@pytest.mark.parametrize('with_lengths', [False, True])
def test_k2_int8_plain_matches_jax(attn_win_size, with_lengths):
  rng = np.random.default_rng(11)
  jblock, tblock = random_block(rng)
  x = rng.normal(0, 1, (5, LENGTH, HIDDEN)).astype(np.float32)
  lengths = SLOT_LENGTHS if with_lengths else None
  kw = dict(num_heads=HEADS, attn_win_size=attn_win_size)
  got = feb.fused_encoder_stack(
      torch.from_numpy(x), [tblock], **kw,
      lengths=None if lengths is None else torch.from_numpy(lengths))
  jl = None if lengths is None else jnp.asarray(lengths)
  pallas = jax_feb.fused_encoder_stack(jnp.asarray(x), [jblock], **kw,
                                       lengths=jl, tile_windows=2,
                                       interpret=True)
  ref = jax_feb.reference_encoder_stack(jnp.asarray(x), [jblock], **kw,
                                        lengths=jl)
  np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=1e-5)
  np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_k2_mixed_quantized_and_float_stack_matches_jax():
  """The FFN-only remainder (int8), a full int8 block and a full float
  block in one stack, as the reference's mixed block list."""
  rng = np.random.default_rng(12)
  pairs = [random_block(rng, has_attn=False), random_block(rng),
           random_block(rng, quantized=False)]
  x = rng.normal(0, 1, (7, LENGTH, HIDDEN)).astype(np.float32)
  kw = dict(num_heads=HEADS, attn_win_size=5)
  got = feb.fused_encoder_stack(torch.from_numpy(x), [t for _, t in pairs],
                                **kw)
  jblocks = [j for j, _ in pairs]
  pallas = jax_feb.fused_encoder_stack(jnp.asarray(x), jblocks, **kw,
                                       tile_windows=4, interpret=True)
  ref = jax_feb.reference_encoder_stack(jnp.asarray(x), jblocks, **kw)
  # Three chained blocks grow the activations to ~10 and accumulate
  # float32 summation-order differences: the reference's own chained
  # stack test holds its kernel at rtol 1e-4 on top of atol 1e-5.
  np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-4,
                             atol=1e-5)
  np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                             atol=1e-5)


def test_k2_rejects_bad_quantized_weights():
  _, block = random_block(np.random.default_rng(13))
  x = torch.zeros(1, LENGTH, HIDDEN)
  kw = dict(num_heads=HEADS, attn_win_size=5)
  no_scale = block._replace(wq=feb.QuantizedWeight(block.wq.values))
  with pytest.raises(ValueError, match='scale'):
    feb.fused_encoder_stack(x, [no_scale], **kw)
  short = block._replace(w_filter=feb.QuantizedWeight(
      block.w_filter.values, block.w_filter.scale[:-1]))
  with pytest.raises(ValueError, match='scale shape'):
    feb.fused_encoder_stack(x, [short], **kw)
  assert not feb.is_int8(random_block(np.random.default_rng(14),
                                      quantized=False)[1])
  assert feb.is_int8(block)


# ---------------------------------------------------------------------------
# The model with the levers vs Flax.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('fused', [False, True])
def test_int8_model_matches_flax(variables, fused):
  """The fused route (K1 on the dequantized layer-0 weights, K2 int8 on
  the buffers) and the module route (dequantized parameters) against
  the reference's same route."""
  levers = dict(quantize_matmuls='int8', use_fused_hotpath=fused)
  jp = jax_params(**levers)
  jv, _ = jax_quantize.prepare_inference_variables(variables, jp)
  rows = fake_rows(jp, 3, seed=2)
  want = np.asarray(jax_model.get_model(jp).apply(jv, jnp.asarray(rows)))
  tp = torch_params(**levers)
  state, n = port_state(variables, tp)
  assert n == 12
  model = torch_model.inference_model(tp, state, 'cpu')
  assert model.encoder.ffn_0.output_layer.quant_values.dtype == torch.int8
  assert isinstance(model.encoder.kernel_blocks()[1].wq, feb.QuantizedWeight)
  got = model(torch.from_numpy(rows)).numpy()
  np.testing.assert_allclose(got, want, atol=1e-5)


def test_bf16_int8_model_matches_flax(variables):
  levers = dict(quantize_matmuls='int8', inference_dtype='bfloat16',
                dtype='bfloat16', use_fused_hotpath=True)
  jp = jax_params(**levers)
  jv, _ = jax_quantize.prepare_inference_variables(variables, jp)
  rows = fake_rows(jp, 4, seed=3)
  want = np.asarray(jax_model.get_model(jp).apply(jv, jnp.asarray(rows)),
                    np.float32)
  tp = torch_params(**levers)
  model = torch_model.inference_model(tp, port_state(variables, tp)[0],
                                      'cpu')
  assert model.condenser.kernel.dtype == torch.bfloat16
  got = model(torch.from_numpy(rows)).numpy()
  assert np.isfinite(got).all()
  np.testing.assert_allclose(got, want, atol=5e-2)
  assert np.mean(got.argmax(-1) == want.argmax(-1)) >= 0.98


# ---------------------------------------------------------------------------
# AlignmentMetric and the eval metrics.
# ---------------------------------------------------------------------------


def alignment_inputs(seed, b, m, n):
  """Labels with internal gaps and trailing padding, scores with gap
  argmaxes and tied maxima."""
  rng = np.random.default_rng(seed)
  y_true = rng.integers(0, 5, (b, m))
  y_true[0] = 0
  y_true[1, m // 2:] = 0
  scores = rng.random((b, n, 5)).astype(np.float32)
  scores[2, :, 0] = 2.0
  scores[3, :n // 3, 1] = scores[3, :n // 3, 2] = 3.0
  return y_true, scores


@pytest.mark.parametrize('b,m,n', [(6, 30, 30), (5, 20, 32)])
def test_alignment_metric_matches_jax(b, m, n):
  y_true, scores = alignment_inputs(b + m, b, m, n)
  v_want, paths_want, mv_want = jax_metrics.AlignmentMetric().alignment(
      jnp.asarray(y_true), jnp.asarray(scores))
  v_got, paths_got, mv_got = torch_metrics.AlignmentMetric().alignment(
      torch.from_numpy(y_true), torch.from_numpy(scores))
  np.testing.assert_allclose(v_got.numpy(), np.asarray(v_want), atol=1e-5)
  np.testing.assert_array_equal(paths_got.numpy(), np.asarray(paths_want))
  assert set(mv_got) == set(mv_want)
  for k in mv_want:
    np.testing.assert_allclose(mv_got[k].numpy(), np.asarray(mv_want[k]),
                               atol=1e-5, err_msg=k)
  np.testing.assert_allclose(
      float(torch_metrics.per_batch_identity(mv_got)),
      float(jax_metrics.per_batch_identity(mv_want)), atol=1e-5)


def test_batch_identity_and_yield_match_jax():
  y_true, scores = alignment_inputs(7, 6, 24, 24)
  ccs = np.random.default_rng(8).integers(0, 5, (6, 24))
  ccs[0, :3] = 7  # outside the vocabulary: a zero one-hot row
  want = jax_metrics.batch_identity_ccs_pred(
      jnp.asarray(ccs), jnp.asarray(scores), jnp.asarray(y_true),
      jax_metrics.AlignmentMetric())
  got = torch_metrics.batch_identity_ccs_pred(
      torch.from_numpy(ccs), torch.from_numpy(scores),
      torch.from_numpy(y_true), torch_metrics.AlignmentMetric())
  for g, w in zip(got, want):
    np.testing.assert_allclose(float(g), float(w), atol=1e-5)
  j_yield, t_yield = jax_metrics.YieldOverCCS(), torch_metrics.YieldOverCCS()
  for id_ccs, id_pred in [(0.999, 0.998), (0.99, 0.9975), (0.998, 0.9),
                          (float(got[0]), float(got[1]))]:
    j_yield.update(id_ccs, id_pred)
    t_yield.update(id_ccs, id_pred)
  assert t_yield.result() == j_yield.result() == 1.0


def write_labeled_tfrecord(path, params, n_examples=8, seed=5):
  """Synthetic labeled examples in the reference layout
  (subreads/encoded [total_rows, L, 1] + label/encoded [L]), as
  tests/test_quantized_inference.py writes them."""
  rng = np.random.default_rng(seed)
  h, length = params.total_rows, params.max_length
  mp = params.max_passes
  with TFRecordWriter(str(path)) as w:
    for i in range(n_examples):
      sub = np.zeros((h, length, 1), np.float32)
      sub[:mp] = rng.integers(0, 5, size=sub[:mp].shape)
      sub[mp:2 * mp] = rng.integers(0, 256, size=sub[:mp].shape)
      sub[2 * mp:3 * mp] = rng.integers(0, 256, size=sub[:mp].shape)
      sub[3 * mp:4 * mp] = rng.integers(0, 3, size=sub[:mp].shape)
      sub[4 * mp] = rng.integers(0, 5, size=sub[4 * mp].shape)
      sub[4 * mp + 1:] = rng.integers(0, 501, size=sub[4 * mp + 1:].shape)
      label = rng.integers(0, 5, size=(length,)).astype(np.float32)
      ex = Example()
      ex.add_bytes('subreads/encoded', [sub.tobytes()])
      ex.add_int64('subreads/shape', list(sub.shape))
      ex.add_bytes('label/encoded', [label.tobytes()])
      ex.add_int64('label/shape', [length])
      ex.add_bytes('name', [f'm0/{i}/ccs'.encode()])
      w.write(ex.serialize())
  return str(path)


@pytest.fixture(scope='module')
def eval_runs(variables, tmp_path_factory):
  """run_evaluation of both packages on one shard, without levers and
  with int8: {lever: (JAX metrics, port metrics)}."""
  tmp = tmp_path_factory.mktemp('eval')
  shard = write_labeled_tfrecord(tmp / 'eval.tfrecord.gz', jax_params())
  runs = {}
  for lever in ('none', 'int8'):
    jp = jax_params(quantize_matmuls=lever)
    jv, _ = jax_quantize.prepare_inference_variables(variables, jp)
    want = jax_evaluate.run_evaluation(
        params=jp, checkpoint_path=None, eval_patterns=[shard],
        out_dir=str(tmp / f'jax_{lever}'), variables=jv)
    tp = torch_params(quantize_matmuls=lever)
    got = torch_evaluate.run_evaluation(
        tp, None, [shard], str(tmp / f'port_{lever}'),
        state=port_state(variables, tp)[0], device='cpu')
    runs[lever] = (want, got)
  return shard, runs


@pytest.mark.parametrize('lever', ['none', 'int8'])
def test_run_evaluation_matches_jax(eval_runs, lever):
  """Every metric within 1e-5; the loss (~150 on a random model) within
  1e-5 of its value."""
  want, got = eval_runs[1][lever]
  assert set(got) == set(want)
  for k in want:
    np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                               err_msg=k)
  assert 0.0 < got['alignment_identity'] < 1.0


@pytest.mark.parametrize('alphas', ['flax_init', 'nonzero'])
def test_int8_identity_within_gate(eval_runs, tmp_path, alphas):
  """The reference's int8 gate: |int8 - f32| alignment identity within
  INT8_IDENTITY_GATE on the shard. 'flax_init' is the reference's own
  setting (tests/test_quantized_inference.py: a fresh Flax init, whose
  ReZero alphas are 0); 'nonzero' the module's init with alphas in
  U(0.5, 1), where int8 reaches the predictions."""
  if alphas == 'nonzero':
    runs = eval_runs[1]
    identity = {k: runs[k][1]['alignment_identity'] for k in runs}
  else:
    params = jax_params()
    variables = jax_model.get_model(params).init(
        jax.random.PRNGKey(0), jnp.zeros((1, params.total_rows, 100, 1)))
    identity = {}
    for lever in ('none', 'int8'):
      tp = torch_params(quantize_matmuls=lever)
      identity[lever] = torch_evaluate.run_evaluation(
          tp, None, [eval_runs[0]], str(tmp_path / lever),
          state=port_state(variables, tp)[0],
          device='cpu')['alignment_identity']
  assert abs(identity['int8'] - identity['none']) <= (
      torch_config.INT8_IDENTITY_GATE)


# ---------------------------------------------------------------------------
# cli run / cli evaluate with the levers.
# ---------------------------------------------------------------------------


@pytest.fixture(scope='module')
def bams(tmp_path_factory):
  return synthetic.write_synthetic_zmw_bams(
      str(tmp_path_factory.mktemp('bams')), n_zmws=5, n_subreads=4,
      seq_len=260, seed=11)


def read_fastq(path):
  with open(path, 'rb') as f:
    lines = f.read().split(b'\n')
  return [(lines[i], lines[i + 1], lines[i + 3])
          for i in range(0, len(lines) - 1, 4)]


@pytest.mark.parametrize('inference_dtype', [None, 'bfloat16'])
def test_cli_run_levers_match_jax(bams, variables, tmp_path,
                                  inference_dtype):
  kw = dict(batch_size=8, batch_zmws=3, min_quality=0, skip_windows_above=0)
  jopts = jax_runner.InferenceOptions(
      **kw, inference_dtype=inference_dtype, quantize_matmuls='int8')
  jp = jax_params(use_fused_hotpath=True)
  jax_runner._apply_quant_levers(jp, jopts)
  jax_out = str(tmp_path / 'jax.fastq')
  jax_runner.run_inference(bams[0], bams[1], None, jax_out, options=jopts,
                           runner=jax_runner.ModelRunner(jp, variables,
                                                         jopts))
  tp = torch_params(use_fused_hotpath=True)
  weights = str(tmp_path / 'w.npz')
  weights_lib.save_npz(weights, jax.device_get(variables['params']))
  params_json = str(tmp_path / 'params.json')
  with open(params_json, 'w') as f:
    json.dump(tp.to_dict(), f)
  out = str(tmp_path / 'port.fastq')
  argv = ['run', '--subreads_to_ccs', bams[0], '--ccs_bam', bams[1],
          '--weights', weights, '--params', params_json, '--output', out,
          '--batch_size', '8', '--batch_zmws', '3', '--min_quality', '0',
          '--skip_windows_above', '0', '--device', 'cpu',
          '--quantize_matmuls', 'int8']
  if inference_dtype:
    argv += ['--inference_dtype', inference_dtype]
  assert cli.main(argv) == 0
  with open(out + '.inference.json') as f:
    counters = json.load(f)
  assert counters['inference_dtype'] == (inference_dtype or 'float32')
  assert counters['n_quantized_matmuls'] == 12
  assert counters['dtype'] == (inference_dtype or 'float32')
  want, got = read_fastq(jax_out), read_fastq(out)
  assert len(got) == len(want) == 5
  n_bases = n_same = 0
  for (jn, js, jq), (tn, ts, tq) in zip(want, got):
    assert jn == tn
    if inference_dtype is None:
      assert js == ts
    if js == ts:
      dq = np.abs(np.frombuffer(jq, np.uint8).astype(int)
                  - np.frombuffer(tq, np.uint8).astype(int))
      assert dq.max() <= (1 if inference_dtype is None
                          else torch_config.BF16_QV_GATE)
    n_bases += len(js)
    n_same += sum(a == b for a, b in zip(js, ts))
  assert n_same >= 0.99 * n_bases


def test_cli_evaluate_on_cpu(eval_runs, variables, tmp_path):
  """`cli evaluate` from a train checkpoint (int8) and from run's
  --weights/--params pair (no lever): rc 0, and the CSV row is
  run_evaluation's."""
  shard, runs = eval_runs
  tp = torch_params()
  out_dir = tmp_path / 'model_out'
  torch_config.save_params_as_json(str(out_dir), tp)
  (out_dir / 'checkpoints').mkdir()
  ckpt = str(out_dir / 'checkpoints' / 'checkpoint-3.pt')
  state = weights_lib.from_flax_params(
      jax.device_get(variables['params']), tp)
  torch.save({'model': state, 'step': 3}, ckpt)
  weights = str(tmp_path / 'w.npz')
  weights_lib.save_npz(weights, jax.device_get(variables['params']))
  for lever, source in (('int8', ['--checkpoint', ckpt]),
                        ('none', ['--weights', weights, '--params',
                                  str(out_dir / 'params.json')])):
    eval_dir = tmp_path / f'eval_{lever}'
    assert cli.main(['evaluate', *source, '--eval_path', shard,
                     '--out_dir', str(eval_dir), '--device', 'cpu',
                     '--quantize_matmuls', lever]) == 0
    with open(eval_dir / 'inference.csv') as f:
      header, row = [line.strip().split(',') for line in f]
    got = dict(zip(header, map(float, row)))
    want = runs[lever][1]
    assert set(got) == set(want)
    for k in want:
      np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
  with pytest.raises(RuntimeError, match='no CUDA device'):
    with pytest.MonkeyPatch.context() as mp:
      mp.setattr(torch.cuda, 'is_available', lambda: False)
      cli.main(['evaluate', '--checkpoint', ckpt, '--eval_path', shard,
                '--out_dir', str(tmp_path / 'x')])
