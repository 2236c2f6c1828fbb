"""The PyTorch port's `run` inference path vs the JAX package's.

Synthetic BAM pairs (the port's copy of the synthetic writer, seeded)
go through both packages: the featurized windows must be identical,
and `run_inference` (port: CPU, float32; JAX: CPU, its fused hot path
with the Pallas kernels in interpret mode) must write the same FASTQ:
base ids identical everywhere, qualities within 1 (the two frameworks
sum in different orders, so a probability on a quality threshold could
land on either side). Also: import hygiene (the port loads neither jax
nor the JAX package) and the card-by-default entry points.
"""
import collections
import json
import os
import re
import subprocess
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepconsensus_tpu.calibration import lib as jax_calibration
from deepconsensus_tpu.inference import runner as jax_runner
from deepconsensus_tpu.models import config as jax_config
from deepconsensus_tpu.models import model as jax_model
from deepconsensus_tpu.preprocess import FeatureLayout as JaxLayout
from deepconsensus_tpu.preprocess import create_proc_feeder as jax_feeder
from deepconsensus_tpu_torch.calibration import lib as torch_calibration
from deepconsensus_tpu_torch.inference import runner as torch_runner
from deepconsensus_tpu_torch.models import config as torch_config
from deepconsensus_tpu_torch.models import weights as weights_lib
from deepconsensus_tpu_torch.preprocess import feeder as torch_feeder
from deepconsensus_tpu_torch.preprocess.pileup import FeatureLayout
from deepconsensus_tpu_torch.testing import synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, 'deepconsensus_tpu_torch')
SMALL = dict(dtype='float32', num_hidden_layers=2, filter_size=64)


@pytest.fixture(scope='module')
def bams(tmp_path_factory):
  return synthetic.write_synthetic_zmw_bams(
      str(tmp_path_factory.mktemp('bams')), n_zmws=5, n_subreads=4,
      seq_len=260, seed=11)


@pytest.fixture(scope='module')
def model_pair():
  """(JAX params, JAX variables, port params, port state): one Flax
  init with non-zero ReZero alphas, bridged to the port."""
  params = jax_config.get_config('transformer_learn_values+test')
  jax_config.finalize_params(params, is_training=False)
  with params.unlocked():
    params.update(SMALL)
    params.use_fused_hotpath = True
  variables = jax_model.get_model(params).init(
      jax.random.PRNGKey(0), jnp.zeros((1, params.total_rows, 100, 1)))
  flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(variables))
  rng = np.random.default_rng(1)
  for key in flat:
    if key[-1] == 'alpha':
      flat[key] = jnp.asarray(rng.uniform(0.5, 1.0), jnp.float32)
  variables = flax.traverse_util.unflatten_dict(flat)
  tparams = torch_config.get_config('transformer_learn_values+test')
  torch_config.finalize_params(tparams)
  tparams.update(SMALL)
  state = weights_lib.from_flax_params(
      jax.device_get(variables['params']), tparams)
  return params, variables, tparams, state


def test_featurized_windows_identical(bams):
  jax_feed, _ = jax_feeder(bams[0], bams[1], layout=JaxLayout(20, 100),
                           ins_trim=5)
  torch_feed, _ = torch_feeder.create_proc_feeder(
      bams[0], bams[1], layout=FeatureLayout(20, 100), ins_trim=5)
  options = jax_runner.InferenceOptions()
  n = 0
  for jz, tz in zip(jax_feed(), torch_feed()):
    jwins, jcount = jax_runner.preprocess_zmw(jz, options)
    twins, tcount = torch_runner.preprocess_zmw(tz)
    assert jcount == tcount and len(jwins) == len(twins)
    for jw, tw in zip(jwins, twins):
      assert jw.keys() == tw.keys()
      for key in jw:
        assert np.array_equal(np.asarray(jw[key]), np.asarray(tw[key])), key
      n += 1
  assert n > 5


def read_fastq(path):
  with open(path, 'rb') as f:
    lines = f.read().split(b'\n')
  return [(lines[i], lines[i + 1], lines[i + 3])
          for i in range(0, len(lines) - 1, 4)]


@pytest.mark.parametrize('skip_windows_above,calibration', [
    (0, 'skip'),
    (1, 'skip'),
    # Non-monotone: no threshold table, so both take the host Phred math.
    (0, '20,0.5,0'),
])
def test_run_inference_matches_jax(bams, model_pair, tmp_path,
                                   skip_windows_above, calibration):
  params, variables, tparams, state = model_pair
  kw = dict(batch_size=8, batch_zmws=3, min_quality=0,
            skip_windows_above=skip_windows_above)
  jax_out, port_out = str(tmp_path / 'jax.fastq'), str(tmp_path / 'port.fastq')
  jopts = jax_runner.InferenceOptions(
      **kw, dc_calibration_values=jax_calibration.parse_calibration_string(
          calibration))
  jax_runner.run_inference(bams[0], bams[1], None, jax_out, options=jopts,
                           runner=jax_runner.ModelRunner(params, variables,
                                                         jopts))
  topts = torch_runner.InferenceOptions(
      **kw, dc_calibration_values=torch_calibration.parse_calibration_string(
          calibration))
  runner = torch_runner.ModelRunner(tparams, state, topts, device='cpu')
  assert runner.device_epilogue == (calibration == 'skip')
  counters = torch_runner.run_inference(
      bams[0], bams[1], port_out, runner)
  want, got = read_fastq(jax_out), read_fastq(port_out)
  assert counters['success'] == len(got) == len(want) == 5
  with open(jax_out, 'rb') as a, open(port_out, 'rb') as b:
    jax_bytes, port_bytes = a.read(), b.read()
  n_diff = sum(x != y for x, y in zip(jax_bytes, port_bytes)) + abs(
      len(jax_bytes) - len(port_bytes))
  for (jn, js, jq), (tn, ts, tq) in zip(want, got):
    assert (jn, js) == (tn, ts), f'base ids differ ({n_diff} bytes differ)'
    dq = np.abs(np.frombuffer(jq, np.uint8).astype(int)
                - np.frombuffer(tq, np.uint8).astype(int))
    assert dq.max() <= 1, f'qualities differ by {dq.max()} ({n_diff} bytes)'
  if skip_windows_above:
    assert counters['n_windows_quality_skipped'] > 0
    assert counters.get('n_windows_to_model', 0) == 0
    assert port_bytes == jax_bytes  # CCS adoption is pure host code


def test_port_imports_no_jax():
  """A fresh interpreter imports every port module (the native library's
  bindings, the featurization pool's module and the fault surface's
  modules among them: inference/faults.py, obs/, io/fastx.py,
  io/validate.py, testing/faults.py, ops/device_spin.py; the data
  half of `train`: preprocess/driver.py, models/data.py,
  testing/synthetic.py; and `serve` and the fleet tier: serve/,
  fleet/, obs/profiler.py); neither jax nor any deepconsensus_tpu
  module may load. A source scan backs it up."""
  code = (
      'import pkgutil, sys, deepconsensus_tpu_torch as p\n'
      'import deepconsensus_tpu_torch.cli\n'
      'for m in pkgutil.walk_packages(p.__path__, p.__name__ + "."):\n'
      '  __import__(m.name)\n'
      'bad = [m for m in sys.modules if m.split(".")[0] in '
      '("jax", "jaxlib", "flax", "ml_collections", "orbax", '
      '"deepconsensus_tpu")]\n'
      'bad += [m for m in ("deepconsensus_tpu_torch.native", '
      '"deepconsensus_tpu_torch.inference.featurize", '
      '"deepconsensus_tpu_torch.inference.faults", '
      '"deepconsensus_tpu_torch.obs", "deepconsensus_tpu_torch.obs.metrics", '
      '"deepconsensus_tpu_torch.obs.trace", '
      '"deepconsensus_tpu_torch.obs.summarize", '
      '"deepconsensus_tpu_torch.io.fastx", '
      '"deepconsensus_tpu_torch.io.validate", '
      '"deepconsensus_tpu_torch.testing.faults", '
      '"deepconsensus_tpu_torch.ops.device_spin", '
      '"deepconsensus_tpu_torch.preprocess.driver", '
      '"deepconsensus_tpu_torch.models.data", '
      '"deepconsensus_tpu_torch.testing.synthetic", '
      '"deepconsensus_tpu_torch.serve.protocol", '
      '"deepconsensus_tpu_torch.serve.client", '
      '"deepconsensus_tpu_torch.serve.service", '
      '"deepconsensus_tpu_torch.serve.server", '
      '"deepconsensus_tpu_torch.fleet.registry", '
      '"deepconsensus_tpu_torch.fleet.balancer", '
      '"deepconsensus_tpu_torch.fleet.router", '
      '"deepconsensus_tpu_torch.fleet.featurize_worker", '
      '"deepconsensus_tpu_torch.obs.profiler") '
      'if m not in sys.modules]\n'
      'print(bad)\n'
      'sys.exit(1 if bad else 0)\n')
  env = dict(os.environ, PYTHONPATH=REPO)
  proc = subprocess.run([sys.executable, '-c', code], env=env, cwd=REPO,
                        capture_output=True, text=True, timeout=120)
  assert proc.returncode == 0, proc.stdout + proc.stderr
  pattern = re.compile(
      r'^\s*(import|from)\s+(jax|flax|ml_collections|orbax|'
      r'deepconsensus_tpu)(\.|\s|$)', re.M)
  offenders = collections.defaultdict(list)
  for root, _, files in os.walk(PORT):
    for name in files:
      if name.endswith('.py'):
        path = os.path.join(root, name)
        with open(path) as f:
          for match in pattern.finditer(f.read()):
            offenders[path].append(match.group(0).strip())
  assert not offenders, dict(offenders)


def test_entry_points_default_to_the_card(model_pair, monkeypatch):
  _, _, tparams, state = model_pair
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='no CUDA device'):
    torch_runner.ModelRunner(tparams, state)
  from deepconsensus_tpu_torch import cli

  with pytest.raises(RuntimeError, match='no CUDA device'):
    cli.main(['run', '--subreads_to_ccs', 'a.bam', '--ccs_bam', 'b.bam',
              '--weights', 'w.npz', '--params', 'p.json', '--output',
              'o.fastq'])


def test_cli_run_on_cpu(bams, model_pair, tmp_path):
  _, _, tparams, state = model_pair
  weights = str(tmp_path / 'w.npz')
  weights_lib.save_npz(weights, weights_lib.to_flax_params(state))
  params_json = str(tmp_path / 'params.json')
  with open(params_json, 'w') as f:
    json.dump(tparams.to_dict(), f)
  from deepconsensus_tpu_torch import cli

  out = str(tmp_path / 'cli.fastq')
  assert cli.main(['run', '--subreads_to_ccs', bams[0], '--ccs_bam', bams[1],
                   '--weights', weights, '--params', params_json,
                   '--output', out, '--batch_size', '8', '--min_quality',
                   '0', '--skip_windows_above', '0', '--device', 'cpu']) == 0
  assert len(read_fastq(out)) == 5
