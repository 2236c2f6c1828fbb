"""The port's fault surface of `run` vs the JAX package's, on the CPU.

Seeded 6-ZMW synthetic BAMs and one Flax init bridged to the port
(2 layers, filter 64, non-zero ReZero alphas) go through both packages'
`run_inference` with the same fault injected:

* a corrupt ZMW (its `pw` tags dropped) under --on_zmw_error skip,
  ccs-fallback and fail;
* a poisoned window (the JAX package reads DCTPU_FAULT_POISON_WINDOW
  only in its service, so its engine is poisoned by the test the same
  way the port's runner poisons its own);
* an injected OOM at pack 2 under --on_device_error degrade (FASTQ
  byte-identical to a clean run) and fail;
* an injected hang at pack 2 under --dispatch_timeout (bounded,
  dead-lettered);
* a crash after one emitted batch and --resume, to FASTQ and to .bam,
  and a resume against another source (manifest mismatch);
* --shard partitions and CCS drafts from a FASTA (`ccs_fasta`).

A resumed ragged stream, told the committed windows of each width,
places every window at the uninterrupted stream's slot offset (on the
card a ragged window's bits depend on its offset).

FASTQ must be identical; dead letters equal but for their timestamps
and trace ids; the counters both sidecars carry equal. Also: device
error classification (torch's own OOM and dead-context errors and the
reference's markers), the quarantine, manifest and dead-letter writer
against the JAX versions, the pool watchdog's respawn, and every new
`cli run` flag reaching InferenceOptions.
"""
import collections
import dataclasses
import json
import multiprocessing.pool
import os
import time
import types

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepconsensus_tpu import faults as jax_shared_faults
from deepconsensus_tpu.calibration import lib as jax_calibration
from deepconsensus_tpu.inference import engine as jax_engine
from deepconsensus_tpu.inference import faults as jax_faults
from deepconsensus_tpu.inference import runner as jax_runner
from deepconsensus_tpu.models import config as jax_config
from deepconsensus_tpu.models import model as jax_model
from deepconsensus_tpu_torch import cli
from deepconsensus_tpu_torch import faults as torch_shared_faults
from deepconsensus_tpu_torch.inference import engine as torch_engine
from deepconsensus_tpu_torch.inference import faults as torch_faults
from deepconsensus_tpu_torch.inference import runner as torch_runner
from deepconsensus_tpu_torch.io import bam as torch_bam
from deepconsensus_tpu_torch.models import config as torch_config
from deepconsensus_tpu_torch.models import weights as weights_lib
from deepconsensus_tpu_torch.testing import faults as fault_files
from deepconsensus_tpu_torch.testing import synthetic

SMALL = dict(dtype='float32', num_hidden_layers=2, filter_size=64)
# 6 ZMWs x 3 windows in 3 featurize batches and 5 packs of 4.
KW = dict(batch_size=4, batch_zmws=2, min_quality=0, skip_windows_above=0)
CORRUPT_ZMW = 102
CORRUPT_NAME = f'm00001_000000_000000/{CORRUPT_ZMW}/ccs'
# Counters both packages' sidecars carry.
SHARED_COUNTERS = (
    'success', 'n_zmw_pass', 'n_zmw_processed', 'n_zmw_quarantined',
    'n_fault_decode', 'n_fault_featurize', 'n_fault_model', 'n_fault_stitch',
    'n_zmw_ccs_fallback', 'n_zmw_skipped_on_error', 'n_fallback_emitted',
    'n_zmw_sharded_out', 'n_zmw_resume_skipped', 'n_windows_to_model',
    'n_model_packs', 'n_oom_bisections', 'n_device_faults',
    'n_dispatch_timeouts', 'partial')


@pytest.fixture(scope='module')
def bams(tmp_path_factory):
  return synthetic.write_synthetic_zmw_bams(
      str(tmp_path_factory.mktemp('bams')), n_zmws=6, n_subreads=4,
      seq_len=260, seed=11)


@pytest.fixture(scope='module')
def corrupt_bams(bams, tmp_path_factory):
  out = str(tmp_path_factory.mktemp('corrupt') / 'subreads_to_ccs.bam')
  assert fault_files.corrupt_zmw(bams[0], out, CORRUPT_ZMW) == 4
  return out, bams[1]


@pytest.fixture(scope='module')
def model_pair():
  """(JAX params, JAX variables, port params, port state)."""
  params = jax_config.get_config('transformer_learn_values+test')
  jax_config.finalize_params(params, is_training=False)
  with params.unlocked():
    params.update(SMALL, use_fused_hotpath=True)
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


@pytest.fixture(autouse=True)
def fresh_hooks():
  """The injection hooks fire once per process: re-arm both packages'."""
  jax_shared_faults._fired.clear()
  torch_shared_faults._fired.clear()
  yield
  jax_shared_faults._fired.clear()
  torch_shared_faults._fired.clear()


def _jax_run(inputs, pair, out, ccs_fasta=None, **kw):
  params, variables, _, _ = pair
  opts = jax_runner.InferenceOptions(
      **kw, dc_calibration_values=jax_calibration.parse_calibration_string(
          'skip'))
  return jax_runner.run_inference(
      inputs[0], inputs[1], None, out, options=opts,
      runner=jax_runner.ModelRunner(params, variables, opts),
      ccs_fasta=ccs_fasta)


def _port_run(inputs, pair, out, ccs_fasta=None, **kw):
  _, _, tparams, state = pair
  runner = torch_runner.ModelRunner(
      torch_config.Params(tparams), state,
      torch_runner.InferenceOptions(**kw), device='cpu')
  return torch_runner.run_inference(inputs[0], inputs[1], out, runner,
                                    ccs_fasta=ccs_fasta)


def _both(inputs, pair, tmp_path, tag='', **kw):
  """Runs both packages; returns {'jax': (counters, out), 'port': ...}."""
  result = {}
  for name, run in (('jax', _jax_run), ('port', _port_run)):
    out = str(tmp_path / f'{name}{tag}.fastq')
    result[name] = run(inputs, pair, out, **dict(KW, **kw)), out
  return result


def _read(path):
  with open(path, 'rb') as f:
    return f.read()


def _reads(data: bytes):
  lines = data.split(b'\n')
  return [tuple(lines[i:i + 4]) for i in range(0, len(lines) - 1, 4)]


def _letters(out):
  return [{k: v for k, v in entry.items() if k not in ('time', 'trace_id')}
          for entry in torch_shared_faults.read_dead_letters(
              out + '.failed.jsonl')]


def _assert_same_run(result):
  (jc, jout), (pc, pout) = result['jax'], result['port']
  assert _read(pout) == _read(jout)
  for key in SHARED_COUNTERS:
    assert pc.get(key, 0) == jc.get(key, 0), key
  if os.path.exists(jout + '.failed.jsonl'):
    assert _letters(pout) == _letters(jout)
    for entry in torch_shared_faults.read_dead_letters(
        pout + '.failed.jsonl'):
      assert entry['trace_id']
  else:
    assert not os.path.exists(pout + '.failed.jsonl')


@pytest.fixture(scope='module')
def clean_fastq(bams, model_pair, tmp_path_factory):
  out = str(tmp_path_factory.mktemp('clean') / 'clean.fastq')
  counters = _port_run(bams, model_pair, out, **KW)
  assert counters['success'] == 6
  return _read(out)


@pytest.mark.parametrize('policy', ['skip', 'ccs-fallback'])
def test_corrupt_zmw_is_quarantined_as_jax_does(corrupt_bams, model_pair,
                                                clean_fastq, tmp_path,
                                                policy):
  result = _both(corrupt_bams, model_pair, tmp_path, on_zmw_error=policy)
  _assert_same_run(result)
  counters, out = result['port']
  letters = _letters(out)
  assert [(e['zmw'], e['stage'], e['kind']) for e in letters] == [
      (CORRUPT_NAME, 'featurize', 'permanent')]
  assert "KeyError: 'pw'" in letters[0]['error']
  clean = _reads(clean_fastq)
  got = _reads(_read(out))
  others = [r for r in clean if r[0] != b'@' + CORRUPT_NAME.encode()]
  if policy == 'skip':
    assert got == others and counters['n_zmw_skipped_on_error'] == 1
  else:
    # The draft CCS read follows its featurize batch's polished reads.
    (fallback,) = [r for r in got if r[0] == b'@' + CORRUPT_NAME.encode()]
    assert [r for r in got if r is not fallback] == others
    with torch_bam.BamReader(corrupt_bams[1]) as reader:
      draft = next(r for r in reader if r.qname == CORRUPT_NAME)
    assert fallback[1] == draft.seq.encode()
    assert fallback[3] == bytes((np.asarray(draft.quals) + 33).astype(np.uint8))
    assert counters['n_fallback_emitted'] == 1


def test_corrupt_zmw_fails_the_run_under_fail(corrupt_bams, model_pair,
                                              tmp_path):
  for run in (_jax_run, _port_run):
    with pytest.raises(KeyError, match='pw'):
      run(corrupt_bams, model_pair, str(tmp_path / f'{run.__name__}.fastq'),
          **KW)
  counters = json.load(open(str(tmp_path / '_port_run.fastq.inference.json')))
  assert counters['partial'] is True
  assert not os.path.exists(str(tmp_path / '_port_run.fastq'))


@pytest.mark.parametrize('policy', ['skip', 'ccs-fallback'])
def test_poisoned_window_quarantines_its_pack(bams, model_pair, clean_fastq,
                                              tmp_path, monkeypatch, policy):
  """The first model window of ZMW 103 poisons its pack; only that
  pack's molecules are quarantined."""
  target = '/103/'
  monkeypatch.setenv(torch_shared_faults.ENV_POISON_WINDOW, target)
  submit = jax_engine.ConsensusEngine.submit
  armed = [True]

  def poisoning_submit(self, raw_windows, tickets):
    hit = next((t for t in tickets if target in t[0].name), None)
    if armed[0] and hit is not None:
      self.poison_ticket(hit)
      armed[0] = False
    return submit(self, raw_windows, tickets)

  monkeypatch.setattr(jax_engine.ConsensusEngine, 'submit', poisoning_submit)
  result = _both(bams, model_pair, tmp_path, on_zmw_error=policy)
  _assert_same_run(result)
  counters, out = result['port']
  letters = _letters(out)
  members = {e['zmw'] for e in letters}
  assert any(target in m for m in members)
  assert {e['stage'] for e in letters} == {'model'}
  assert all('injected poison window payload' in e['error'] for e in letters)
  assert counters['n_fault_model'] == len(members)
  untouched = [r for r in _reads(clean_fastq)
               if r[0][1:].decode() not in members]
  got = _reads(_read(out))
  assert [r for r in got if r[0][1:].decode() not in members] == untouched
  assert len(got) == 6 - (len(members) if policy == 'skip' else 0)


def test_oom_at_pack_2_degrades_to_the_same_bytes(bams, model_pair,
                                                  clean_fastq, tmp_path,
                                                  monkeypatch):
  monkeypatch.setenv(torch_shared_faults.ENV_DEVICE_OOM_AT_PACK, '2')
  result = _both(bams, model_pair, tmp_path, on_device_error='degrade')
  _assert_same_run(result)
  counters, out = result['port']
  assert _read(out) == clean_fastq
  assert counters['n_oom_bisections'] == 1
  assert counters['n_device_faults'] == 1


def test_oom_at_pack_2_fails_under_fail(bams, model_pair, tmp_path,
                                        monkeypatch):
  monkeypatch.setenv(torch_shared_faults.ENV_DEVICE_OOM_AT_PACK, '2')
  with pytest.raises(jax_shared_faults.DeviceOomError):
    _jax_run(bams, model_pair, str(tmp_path / 'j.fastq'), **KW)
  with pytest.raises(torch_shared_faults.DeviceOomError,
                     match='RESOURCE_EXHAUSTED: injected device OOM at pack 2'):
    _port_run(bams, model_pair, str(tmp_path / 'p.fastq'), **KW)


def test_hung_pack_times_out_and_is_dead_lettered(bams, model_pair,
                                                  clean_fastq, tmp_path,
                                                  monkeypatch):
  monkeypatch.setenv(torch_shared_faults.ENV_DEVICE_HANG_AT_PACK, '2')
  # The JAX package's abandoned watchdog thread sleeps out its hang (and
  # is joined at exit), so its hang is short; the port's is long, so a
  # run bounded by the timeout stands out from one that waits it out.
  monkeypatch.setenv(torch_shared_faults.ENV_DEVICE_HANG_S, '4')
  kw = dict(KW, on_zmw_error='skip', dispatch_timeout=0.5)
  result = {'jax': (_jax_run(bams, model_pair, str(tmp_path / 'j.fastq'),
                             **kw), str(tmp_path / 'j.fastq'))}
  monkeypatch.setenv(torch_shared_faults.ENV_DEVICE_HANG_S, '120')
  out = str(tmp_path / 'p.fastq')
  t0 = time.monotonic()
  result['port'] = _port_run(bams, model_pair, out, **kw), out
  assert time.monotonic() - t0 < 60  # bounded by the timeout, not the hang
  _assert_same_run(result)
  counters = result['port'][0]
  letters = _letters(out)
  assert letters and {e['stage'] for e in letters} == {'model'}
  assert all(e['error'].startswith('DispatchTimeoutError') and
             e['kind'] == 'transient' for e in letters)
  assert counters['n_dispatch_timeouts'] == 1
  members = {e['zmw'] for e in letters}
  assert [r for r in _reads(_read(out))] == [
      r for r in _reads(clean_fastq) if r[0][1:].decode() not in members]


@pytest.mark.parametrize('ext', ['fastq', 'bam'])
def test_crash_then_resume_matches_jax(bams, model_pair, clean_fastq,
                                       tmp_path, monkeypatch, ext):
  outs = {}
  for name, run in (('jax', _jax_run), ('port', _port_run)):
    out = str(tmp_path / f'{name}.{ext}')
    monkeypatch.setenv(torch_shared_faults.ENV_CRASH_AFTER_BATCHES, '1')
    with pytest.raises(RuntimeError, match='injected crash after 1'):
      run(bams, model_pair, out, **KW)
    assert not os.path.exists(out)
    assert os.path.exists(out + '.tmp')
    with open(out + '.progress.json') as f:
      state = json.load(f)
    with open(out + '.inference.json') as f:
      assert json.load(f)['partial'] is True
    assert state['groups_done'] == 2
    monkeypatch.delenv(torch_shared_faults.ENV_CRASH_AFTER_BATCHES)
    counters = run(bams, model_pair, out, **KW, resume=True)
    assert counters['n_zmw_resume_skipped'] == state['groups_done']
    assert 'partial' not in counters
    assert not os.path.exists(out + '.tmp')
    assert not os.path.exists(out + '.progress.json')
    outs[name] = out
  assert _read(outs['port']) == _read(outs['jax'])
  if ext == 'fastq':
    assert _read(outs['port']) == clean_fastq
  else:
    with torch_bam.BamReader(outs['port']) as reader:
      names = [r.qname for r in reader]
    assert names == [r[0][1:].decode() for r in _reads(clean_fastq)]


def test_resume_against_another_source_is_refused(bams, corrupt_bams,
                                                  model_pair, tmp_path,
                                                  monkeypatch):
  for name, run in (('jax', _jax_run), ('port', _port_run)):
    out = str(tmp_path / f'{name}.fastq')
    monkeypatch.setenv(torch_shared_faults.ENV_CRASH_AFTER_BATCHES, '1')
    with pytest.raises(RuntimeError):
      run(bams, model_pair, out, **KW)
    monkeypatch.delenv(torch_shared_faults.ENV_CRASH_AFTER_BATCHES)
    with pytest.raises(ValueError, match='manifest mismatch'):
      run(corrupt_bams, model_pair, out, **KW, resume=True)


def test_shards_partition_the_reads(bams, model_pair, clean_fastq, tmp_path):
  reads = []
  for i in range(2):
    result = _both(bams, model_pair, tmp_path, tag=f'_{i}', shard=(i, 2))
    _assert_same_run(result)
    counters, out = result['port']
    assert counters['n_zmw_sharded_out'] == 3
    got = _reads(_read(out))
    assert all(int(r[0].split(b'/')[1]) % 2 == i for r in got)
    reads += got
  assert sorted(reads) == sorted(_reads(clean_fastq))


def test_ccs_fasta_drafts_match_jax(bams, model_pair, tmp_path):
  fasta = str(tmp_path / 'ccs.fasta')
  with torch_bam.BamReader(bams[1]) as reader, open(fasta, 'w') as f:
    for record in reader:
      f.write(f'>{record.qname}\n{record.seq}\n')
  result = {}
  for name, run in (('jax', _jax_run), ('port', _port_run)):
    out = str(tmp_path / f'{name}.fastq')
    result[name] = run((bams[0], None), model_pair, out, ccs_fasta=fasta,
                       **KW), out
  _assert_same_run(result)
  assert result['port'][0]['success'] == 6


@pytest.mark.parametrize('text', [
    'RESOURCE_EXHAUSTED: out of memory while trying to allocate',
    'INTERNAL: device halted', 'DATA_LOSS: chip reset',
    'UNAVAILABLE: try again', 'ValueError: a host bug'])
def test_marker_strings_classify_as_jax_does(text):
  error = RuntimeError(text)
  want = jax_shared_faults.classify_device_error(error)
  got = torch_shared_faults.classify_device_error(error)
  assert type(got).__name__ == type(want).__name__
  assert str(got) == str(want)
  assert torch_shared_faults.classify_error(text) == (
      jax_shared_faults.classify_error(text))


@pytest.mark.parametrize('error, kind', [
    (torch.OutOfMemoryError('CUDA out of memory. Tried to allocate 80 GiB'),
     'DeviceOomError'),
    (torch.OutOfMemoryError('allocation failed'), 'DeviceOomError'),
    (RuntimeError('CUDA error: an illegal memory access was encountered'),
     'DeviceLostError'),
    (RuntimeError('CUDA error: device-side assert triggered'),
     'DeviceLostError'),
    (RuntimeError('dc_gemm: CUDA launch failed (cudaErrorLaunchFailure)'),
     'DeviceLostError'),
    (RuntimeError('CUDA error: unspecified launch failure'),
     'DeviceLostError'),
    (ValueError('shape mismatch'), 'ValueError')])
def test_torch_device_errors_are_classified(error, kind):
  got = torch_shared_faults.classify_device_error(error)
  assert type(got).__name__ == kind
  if kind != 'ValueError':
    assert got.__cause__ is error
  if kind == 'DeviceOomError':
    assert got.kind == 'transient'


def test_quarantine_and_dead_letters_match_jax(tmp_path):
  draft = torch_faults.CcsFallback('m/1/ccs', 'ACGT', np.array([30] * 4))
  for policy in ('skip', 'ccs-fallback'):
    records, counters, payloads = {}, {}, {}
    for name, lib in (('jax', jax_faults), ('port', torch_faults)):
      path = str(tmp_path / f'{name}_{policy}.jsonl')
      writer = (jax_shared_faults if name == 'jax'
                else torch_shared_faults).DeadLetterWriter(path)
      q = lib.Quarantine(policy, writer)
      payloads[name] = [
          q.handle('m/1/ccs', 'featurize', KeyError('pw'),
                   fallback=lambda: draft),
          q.handle('m/2/ccs', 'model', 'watchdog fired', fallback=None,
                   extra={'model_pack': 3, 'n_windows_in_pack': 2}),
          q.handle('m/3/ccs', 'stitch', ValueError('bad'))]
      q.bump('n_pool_respawns')
      writer.close()
      records[name] = [
          {k: v for k, v in e.items() if k not in ('time', 'trace_id')}
          for e in jax_shared_faults.read_dead_letters(path)]
      counters[name] = dict(q.counters)
    assert records['port'] == records['jax']
    assert counters['port'] == counters['jax']
    assert [p is not None for p in payloads['port']] == [
        p is not None for p in payloads['jax']]
  with pytest.raises(KeyError):
    torch_faults.Quarantine('fail', None).handle('z', 'decode', KeyError('x'))
  with pytest.raises(torch_faults.ZmwFault, match=r'\[decode/transient\]'):
    torch_faults.Quarantine('fail', None).handle('z', 'decode', 'timed out')
  with pytest.raises(ValueError, match='on_zmw_error'):
    torch_faults.Quarantine('ignore', None)


def test_manifest_round_trips_with_jax(tmp_path):
  source = {'subreads_to_ccs': 'a.bam', 'ccs_bam': 'b.bam', 'shard': [0, 2]}
  port = torch_faults.ProgressManifest(str(tmp_path / 'p.progress.json'))
  port.commit(groups_done=4, tmp_size=1234, source=source, last_zmw='m/4/ccs')
  state = jax_faults.ProgressManifest(port.path).load()
  assert {k: v for k, v in state.items() if k != 'time'} == {
      'version': 1, 'groups_done': 4, 'tmp_size': 1234,
      'last_zmw': 'm/4/ccs', 'source': source}
  jax_faults.ProgressManifest(port.path).commit(
      groups_done=5, tmp_size=99, source=source)
  assert port.load()['groups_done'] == 5
  torch_faults.validate_resume_source(port.load(), source)
  other = dict(source, ccs_bam='c.bam')
  for lib in (torch_faults, jax_faults):
    with pytest.raises(ValueError, match="manifest mismatch for 'ccs_bam'"):
      lib.validate_resume_source(port.load(), other)
  with open(port.path, 'w') as f:
    json.dump({'version': 9}, f)
  assert port.load() is None
  port.delete()
  assert not os.path.exists(port.path)


def _sleepy(x):
  if x == 2 and not os.path.exists(_sleepy.token):
    open(_sleepy.token, 'w').close()
    time.sleep(1)
  return x * x


def test_pool_watchdog_respawns_and_retries(tmp_path):
  """A task that hangs once: the watchdog times the batch out,
  reclaims the batch's segments by prefix, re-spawns the pool and the
  retry succeeds; a pool that never answers raises WatchdogTimeout."""
  _sleepy.token = str(tmp_path / 'token')
  quarantine = torch_faults.Quarantine('skip', None)
  made = []

  def make_pool():
    made.append(multiprocessing.pool.ThreadPool(2))
    return made[-1]

  prefix = f'dctorch_test_{os.getpid()}_'
  segment = f'/dev/shm/{prefix}orphan'
  if os.path.isdir('/dev/shm'):
    open(segment, 'wb').close()
  watchdog = torch_faults.PoolWatchdog(make_pool, timeout=0.3, retries=1,
                                       backoff=0.0, quarantine=quarantine)
  try:
    got = watchdog.run_batch(_sleepy, [(i,) for i in range(4)], chunksize=1,
                             shm_prefix=prefix)
  finally:
    watchdog.close()
  assert got == [0, 1, 4, 9]
  assert len(made) == 2
  assert dict(quarantine.counters) == {
      'n_watchdog_timeouts': 1, 'n_pool_respawns': 1,
      'n_watchdog_retries': 1}
  assert not os.path.exists(segment)
  os.unlink(_sleepy.token)
  watchdog = torch_faults.PoolWatchdog(make_pool, timeout=0.2, retries=0)
  try:
    with pytest.raises(torch_faults.WatchdogTimeout):
      watchdog.run_batch(_sleepy, [(2,)], chunksize=1)
  finally:
    watchdog.close()


def test_cli_run_flags_reach_the_options(bams, model_pair, tmp_path,
                                         monkeypatch):
  _, _, tparams, state = model_pair
  weights = str(tmp_path / 'w.npz')
  weights_lib.save_npz(weights, weights_lib.to_flax_params(state))
  params_json = str(tmp_path / 'params.json')
  with open(params_json, 'w') as f:
    json.dump(tparams.to_dict(), f)
  seen = {}

  def capture(subreads, ccs, out, runner, ccs_fasta=None):
    seen['options'] = runner.options
    seen['trace'] = os.environ.get('DCTPU_TRACE')
    return {'success': 1}

  monkeypatch.setattr(torch_runner, 'run_inference', capture)
  monkeypatch.delenv('DCTPU_TRACE', raising=False)
  trace = str(tmp_path / 't.jsonl')
  assert cli.main([
      'run', '--subreads_to_ccs', bams[0], '--ccs_bam', bams[1],
      '--weights', weights, '--params', params_json,
      '--output', str(tmp_path / 'o.fastq'), '--device', 'cpu',
      '--shard', '1/3', '--on_zmw_error', 'ccs-fallback',
      '--batch_timeout', '7.5', '--batch_retries', '4', '--resume',
      '--max_record_bytes', '1024', '--on_device_error', 'degrade',
      '--dispatch_timeout', '2', '--trace', trace]) == 0
  options = seen['options']
  assert (options.shard, options.on_zmw_error, options.batch_timeout,
          options.batch_retries, options.resume, options.max_record_bytes,
          options.on_device_error, options.dispatch_timeout) == (
              (1, 3), 'ccs-fallback', 7.5, 4, True, 1024, 'degrade', 2.0)
  assert seen['trace'] == trace
  monkeypatch.delenv('DCTPU_TRACE')
  defaults = torch_runner.InferenceOptions()
  reference = jax_runner.InferenceOptions()
  for field in ('shard', 'on_zmw_error', 'max_record_bytes',
                'batch_timeout', 'batch_retries', 'on_device_error',
                'dispatch_timeout', 'resume'):
    assert getattr(defaults, field) == getattr(reference, field), field
  for bad in (['--shard', '3/3'], ['--on_zmw_error', 'ignore'],
              ['--on_device_error', 'retry']):
    with pytest.raises(SystemExit):
      cli.main(['run', '--subreads_to_ccs', 'a', '--ccs_bam', 'b',
                '--weights', weights, '--params', params_json,
                '--output', 'o', *bad])
  assert {f.name for f in dataclasses.fields(defaults)} >= {
      'shard', 'on_zmw_error', 'resume'}


def _ragged_offsets(batches, placed=None):
  """{window id: slot offset} as the ragged packer places a stream of
  featurize batches of (id, width) windows, each window's rows holding
  its id + 1 (dummy windows hold zeros)."""
  offsets = {}

  class Stub:

    def dispatch_ragged(self, pack, lengths):
      for slot, widths in enumerate(lengths):
        off = 0
        for width in widths[widths > 0]:
          value = int(pack[slot, 0, off, 0])
          if value:
            offsets[value - 1] = off
          off += width
      return pack

    def finalize(self, pack):
      zeros = np.zeros(pack.shape[::2][:2], np.uint8)
      return zeros, zeros

  packer = torch_engine._RaggedPacker(
      Stub(), types.SimpleNamespace(batch_size=8, dispatch_depth=2),
      (100, 200), deliver=lambda *_: None, placed=placed)
  for batch in batches:
    for wid, width in batch:
      packer.add(np.full((1, 1, width, 1), wid + 1, np.float32), [wid])
  packer.flush()
  return offsets


def test_resumed_ragged_stream_keeps_the_uninterrupted_offsets():
  rng = np.random.default_rng(7)
  widths = rng.choice([100, 200], size=90, p=[0.6, 0.4])
  batches = [list(zip(range(i, i + 9), widths[i:i + 9]))
             for i in range(0, 90, 9)]
  whole = _ragged_offsets(batches)
  assert len(whole) == 90
  shifted = 0
  for k in range(1, len(batches)):
    placed = collections.Counter(int(w) for b in batches[:k] for _, w in b)
    resumed = _ragged_offsets(batches[k:], placed=dict(placed))
    assert resumed == {wid: whole[wid] for wid in resumed}
    shifted += _ragged_offsets(batches[k:]) != resumed
  assert shifted  # without the counts, some resume points move windows
