"""The PyTorch port's model forward and weight bridge vs the JAX model.

One Flax init (with every ReZero alpha set to a non-zero value from a
numpy seed) feeds both models through `weights.from_flax_params`. The
port's forward (its fused route through the kernels' plain versions,
and its module route) is held against `model.apply` with
use_fused_hotpath both off and on, float32, atol 1e-5 (the bar of
tests/test_fused_hotpath.py), at a small size: 2 layers, hidden 280,
2 heads, band 12, filter 64.
"""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepconsensus_tpu.models import config as jax_config
from deepconsensus_tpu.models import model as jax_model
from deepconsensus_tpu_torch.inference import runner as runner_lib
from deepconsensus_tpu_torch.models import config as torch_config
from deepconsensus_tpu_torch.models import model as torch_model
from deepconsensus_tpu_torch.models import weights as weights_lib

SMALL = dict(dtype='float32', num_hidden_layers=2, filter_size=64)


def jax_params(length=100, **overrides):
  params = jax_config.get_config('transformer_learn_values+test')
  jax_config.finalize_params(params, max_length=length, is_training=False)
  with params.unlocked():
    for k, v in {**SMALL, **overrides}.items():
      params[k] = v
  return params


def torch_params(length=100, **overrides):
  params = torch_config.get_config('transformer_learn_values+test')
  torch_config.finalize_params(params, max_length=length)
  params.update({**SMALL, **overrides})
  return params


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


def flax_tree(params, rows, seed=3):
  variables = jax_model.get_model(params).init(
      jax.random.PRNGKey(0), jnp.asarray(rows))
  flat = flax.traverse_util.flatten_dict(
      flax.core.unfreeze(variables['params']))
  rng = np.random.default_rng(seed)
  for key in flat:
    if key[-1] == 'alpha':
      flat[key] = np.float32(rng.uniform(0.5, 1.0))
  return jax.device_get(flax.traverse_util.unflatten_dict(flat))


def port_forward(tree, rows, **overrides):
  params = torch_params(rows.shape[2], **overrides)
  model = torch_model.DeepConsensusModel(params, device='cpu')
  model.load_state_dict(weights_lib.from_flax_params(tree, params))
  return model(torch.from_numpy(rows)).numpy()


@pytest.mark.parametrize('length', [20, 100])
@pytest.mark.parametrize('jax_fused', [False, True])
def test_forward_matches_jax_apply(length, jax_fused):
  params = jax_params(length, use_fused_hotpath=jax_fused)
  rows = fake_rows(params, batch=2, seed=length)
  tree = flax_tree(params, rows)
  want = np.asarray(jax_model.get_model(params).apply(
      {'params': tree}, jnp.asarray(rows)))
  for port_fused in (False, True):
    got = port_forward(tree, rows, use_fused_hotpath=port_fused)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_from_flax_params_layout_with_asymmetric_heads():
  """Head 1's q/k/v columns and output rows are rescaled so the heads
  differ; a bridge that mixed up the [H, heads, head_dim] layout (or
  transposed a kernel) would then change the output. Swapping the two
  heads' value weights must change it too."""
  params = jax_params(20)
  rows = fake_rows(params, batch=2, seed=5)
  tree = flax_tree(params, rows)
  attn = tree['encoder']['self_attention_1']
  for name in ('query', 'key', 'value'):
    attn[name]['kernel'] = attn[name]['kernel'] * np.array(
        [1.0, 1.5], np.float32)[None, :, None]
  attn['output_transform']['kernel'] = (
      attn['output_transform']['kernel']
      * np.array([0.8, 1.25], np.float32)[:, None, None])
  state = weights_lib.from_flax_params(tree, torch_params(20))
  assert tuple(state['encoder.self_attention_1.query.kernel'].shape) == (
      280, 2, 140)
  assert tuple(state['encoder.self_attention_1.output_transform.kernel']
               .shape) == (2, 140, 280)
  want = np.asarray(jax_model.get_model(params).apply(
      {'params': tree}, jnp.asarray(rows)))
  got = port_forward(tree, rows, use_fused_hotpath=True)
  np.testing.assert_allclose(got, want, atol=1e-5)
  attn['value']['kernel'] = attn['value']['kernel'][:, ::-1].copy()
  swapped = port_forward(tree, rows, use_fused_hotpath=True)
  assert np.abs(swapped - got).max() > 1e-3


def test_from_flax_params_rejects_bad_trees():
  params = jax_params(20)
  tree = flax_tree(params, fake_rows(params, 1, 0))
  tparams = torch_params(20)
  tree['logits']['kernel'] = tree['logits']['kernel'].T
  with pytest.raises(ValueError, match='logits/kernel'):
    weights_lib.from_flax_params(tree, tparams)
  del tree['logits']
  with pytest.raises(KeyError, match='logits'):
    weights_lib.from_flax_params(tree, tparams)


def test_npz_round_trip(tmp_path):
  params = jax_params(20)
  tree = flax_tree(params, fake_rows(params, 1, 0))
  path = str(tmp_path / 'w.npz')
  weights_lib.save_npz(path, tree)
  back = weights_lib.load_npz(path)
  flat, flat_back = (weights_lib.flatten_tree(t) for t in (tree, back))
  assert flat.keys() == flat_back.keys()
  for key in flat:
    np.testing.assert_array_equal(np.asarray(flat[key]), flat_back[key])


def test_seeded_init_is_reproducible_with_nonzero_alphas():
  params = torch_params(20)
  models = []
  for _ in range(2):
    m = torch_model.DeepConsensusModel(params, device='cpu')
    m.init_weights(torch.Generator().manual_seed(0))
    models.append(m.state_dict())
  for name, t in models[0].items():
    assert torch.equal(t, models[1][name])
    if name.endswith('alpha'):
      assert 0.1 <= float(t) <= 0.3


def test_unported_configs_raise():
  """A quantization other than int8 and a non-float32 softmax stay
  unported (int8 is ported: tests/test_torch_quantize.py). Several
  buckets without ragged slots are served per bucket: the runner and the
  model take any set normalize_window_buckets accepts (no divisibility
  chain needed), and only an invalid set raises."""
  with pytest.raises(NotImplementedError, match='int4'):
    torch_model.DeepConsensusModel(
        torch_params(20, quantize_matmuls='int4'), device='cpu')
  torch_model.DeepConsensusModel(torch_params(20, quantize_matmuls='int8'),
                                 device='cpu')
  params = torch_params(20, window_buckets='20,40')
  state = torch_model.DeepConsensusModel(params, device='cpu').state_dict()
  runner = runner_lib.ModelRunner(params, state,
                                  runner_lib.InferenceOptions(), device='cpu')
  assert runner.window_buckets == (20, 40)
  torch_model.DeepConsensusModel(torch_params(20, window_buckets='20,30'),
                                 device='cpu')
  with pytest.raises(ValueError, match='ascending'):
    torch_model.DeepConsensusModel(
        torch_params(20, window_buckets='20,30,25'), device='cpu')
  with pytest.raises(NotImplementedError, match='float32'):
    torch_model.DeepConsensusModel(
        torch_params(20, attn_softmax_dtype='bfloat16'), device='cpu')
