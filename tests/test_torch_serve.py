"""The port's `serve` (deepconsensus_tpu_torch/serve) against the JAX
package's.

* Protocol: every encoder gives the JAX package's bytes (npz zip
  members stamped with one fixed time), and every malformed body the
  same typed rejection: class, HTTP status and message.
* Stubbed service: both packages' ConsensusService run a weightless
  stub runner (ids from the draft CCS row, quality 40, as the JAX
  package's tests/test_serve.py does) behind their own HTTP server; one
  scripted sequence of requests gives the same statuses, messages,
  counters and dead letters (minus time and ids): 400, 413 on the
  header and on the window cap, 429, 504, the poison quarantine under
  both policies, 503 while draining. The stub's dispatch blocks on an
  event where a request must be held in flight, so nothing waits on a
  sleep.
* Real model: transformer_learn_values+test at 2 layers with JAX
  weights carried across by models/weights.py, on the CPU. A served
  molecule is byte-identical to the port's `run_inference` record and
  to the JAX package's served answer (tolerance 0), from 8 concurrent
  clients, at one width and with mixed-width clients (buckets 100,200).
* `cli serve` refuses what the port does not run: --dp/--tp, exported
  artifacts, and a missing card without --device cpu.

Servers bind port 0 on 127.0.0.1 and are shut down and drained at the
end of each test; serve_main runs off the main thread, so it installs no
signal handler.
"""
import io
import json
import os
import threading
import time
import types
import zipfile

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepconsensus_tpu import faults as jax_faults
from deepconsensus_tpu.inference import runner as jax_runner
from deepconsensus_tpu.models import config as jax_config
from deepconsensus_tpu.models import model as jax_model
from deepconsensus_tpu.serve import client as jax_client
from deepconsensus_tpu.serve import protocol as jax_protocol
from deepconsensus_tpu.serve import server as jax_server
from deepconsensus_tpu.serve import service as jax_service
from deepconsensus_tpu_torch import cli
from deepconsensus_tpu_torch import faults as torch_faults
from deepconsensus_tpu_torch.inference import runner as torch_runner
from deepconsensus_tpu_torch.models import config as torch_config
from deepconsensus_tpu_torch.models import weights as weights_lib
from deepconsensus_tpu_torch.postprocess import stitch
from deepconsensus_tpu_torch.preprocess import feeder as torch_feeder
from deepconsensus_tpu_torch.preprocess.pileup import FeatureLayout
from deepconsensus_tpu_torch.serve import client as torch_client
from deepconsensus_tpu_torch.serve import protocol as torch_protocol
from deepconsensus_tpu_torch.serve import server as torch_server
from deepconsensus_tpu_torch.serve import service as torch_service
from deepconsensus_tpu_torch.testing import synthetic

BATCH = 8
STUB_QUAL = 40
SMALL = dict(dtype='float32', num_hidden_layers=2, filter_size=64)
IO_TIMEOUT_S = 2.0


@pytest.fixture(autouse=True)
def one_torch_thread():
  """One intra-op thread: this file shares the machine with the other
  test files' workers. Restored after each test."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.fixture
def fixed_zip_time(monkeypatch):
  """np.savez stamps each zip member with the current local time; one
  fixed clock for zipfile makes two encodings comparable byte for
  byte."""
  monkeypatch.setattr(zipfile, 'time', types.SimpleNamespace(
      time=lambda: 1.7e9, localtime=time.localtime))


def jax_params():
  p = jax_config.get_config('transformer_learn_values+test')
  jax_config.finalize_params(p, is_training=False)
  return p


def torch_params():
  p = torch_config.get_config('transformer_learn_values+test')
  torch_config.finalize_params(p)
  return p


def molecule(params, name, n=4, seed=0, width=None):
  width = width or params.max_length
  rng = np.random.default_rng(seed)
  subreads = rng.integers(
      0, 5, size=(n, params.total_rows, width, 1)).astype(np.float32)
  # The 4 SN rows hold one value per window, as the pileup writes them.
  subreads[:, -4:] = rng.integers(0, 9, size=(n, 4, 1, 1))
  return dict(
      name=name,
      subreads=subreads,
      window_pos=np.arange(n, dtype=np.int64) * width,
      ccs_bq=np.full((n, width), 30, dtype=np.int32),
      overflow=np.zeros(n, dtype=np.uint8),
  )


def features_of(mol):
  return [dict(name=mol['name'], subreads=mol['subreads'][i],
               window_pos=int(mol['window_pos'][i]),
               ccs_base_quality_scores=mol['ccs_bq'][i],
               overflow=bool(mol['overflow'][i]), ec=12.5, np_num_passes=7,
               rq=0.99, rg=None)
          for i in range(len(mol['subreads']))]


# ----------------------------------------------------------------------
# Protocol


ENCODERS = {
    'encode_request': lambda pr, mol: pr.encode_request(
        **mol, meta={'ec': 3.5, 'rq': 0.9, 'rg': 'x'}),
    'request_from_features': lambda pr, mol: pr.request_from_features(
        features_of(mol)),
    'features_pack_from_features': lambda pr, mol: (
        pr.features_pack_from_features(features_of(mol))),
    'encode_features_pack_lossy': lambda pr, mol: pr.encode_features_pack(
        **dict(mol, subreads=mol['subreads'] + 0.5)),
    'encode_bam_request': lambda pr, mol: pr.encode_bam_request(
        mol['subreads'].tobytes()[:999], b'ccs bytes', name=mol['name'],
        meta={'np_num_passes': 4}),
    'encode_response': lambda pr, mol: pr.encode_response(
        'ok', b'ACGT', np.array([1, 2, 3, 93]), {'n_windows_to_model': 4},
        error='e' * 5000),
}


@pytest.mark.parametrize('encoder', sorted(ENCODERS))
def test_encoders_give_the_jax_packages_bytes(encoder, fixed_zip_time):
  mol = molecule(torch_params(), 'm/1/ccs', n=3, seed=1)
  want = ENCODERS[encoder](jax_protocol, mol)
  got = ENCODERS[encoder](torch_protocol, mol)
  assert got == want
  if encoder == 'encode_features_pack_lossy':
    assert got is None  # non-integral values do not pack
  else:
    assert got and len(got) > 100


def npz_body(**arrays):
  buf = io.BytesIO()
  np.savez(buf, **arrays)
  return buf.getvalue()


def malformed_bodies(params):
  mol = molecule(params, 'm/2/ccs', n=3, seed=2)
  good = jax_protocol.encode_request(**mol)
  pack = jax_protocol.features_pack_from_features(features_of(mol))
  bam = jax_protocol.encode_bam_request(b'\x01', b'\x02', name='b')
  return {
      'garbage': b'not an npz at all',
      'truncated': good[:len(good) // 2],
      'too_many_windows': jax_protocol.encode_request(
          **molecule(params, 'm/3/ccs', n=7)),
      'zero_windows': jax_protocol.encode_request(
          **molecule(params, 'm/4/ccs', n=0)),
      'wrong_width': jax_protocol.encode_request(
          **molecule(params, 'm/5/ccs', width=150)),
      'wrong_rows': jax_protocol.encode_request(**dict(
          mol, subreads=mol['subreads'][:, :-1])),
      'misaligned_pos': jax_protocol.encode_request(**dict(
          mol, window_pos=mol['window_pos'][:2])),
      'bad_ccs_bq': jax_protocol.encode_request(**dict(
          mol, ccs_bq=mol['ccs_bq'][:, :50])),
      'non_finite': jax_protocol.encode_request(**dict(
          mol, subreads=np.where(mol['subreads'] > 3, np.nan,
                                 mol['subreads']))),
      'bam_to_replica': bam,
      'missing_field': good.replace(b'subreads', b'subreadz'),
      'unknown_frame': npz_body(frame=np.array('features/9'),
                                name=np.array('u')),
      'features_missing_sn': pack.replace(b'sn.npy', b'xx.npy'),
      'ok_legacy': good,
      'ok_features': pack,
  }


@pytest.mark.parametrize('case', sorted(malformed_bodies(jax_params())))
def test_decode_request_rejects_as_the_jax_package(case):
  params = torch_params()
  body = malformed_bodies(params)[case]
  kw = dict(total_rows=params.total_rows, max_length=params.max_length,
            max_windows=6, window_buckets=(100, 200))

  def outcome(protocol, faults):
    try:
      req = protocol.decode_request(body, **kw)
    except faults.ServeRejection as e:
      return type(e).__name__, e.http_status, e.kind, str(e)
    return {k: (np.asarray(v).tobytes() if isinstance(v, np.ndarray) else v)
            for k, v in req.items()}

  want = outcome(jax_protocol, jax_faults)
  got = outcome(torch_protocol, torch_faults)
  assert got == want
  assert isinstance(got, dict) == case.startswith('ok_')


@pytest.mark.parametrize('body', [b'junk', None, 'legacy'])
def test_bam_frame_and_sniff_reject_as_the_jax_package(body):
  params = torch_params()
  if body is None:
    body = jax_protocol.encode_bam_request(b'S' * 40, b'C' * 30, name='z',
                                           meta={'rq': 0.5})
  elif body == 'legacy':
    body = jax_protocol.encode_request(**molecule(params, 'm/6/ccs'))

  def outcome(protocol, faults):
    out = []
    for fn in (protocol.decode_bam_request, protocol.sniff_frame):
      try:
        out.append(fn(body))
      except faults.ServeRejection as e:
        out.append((type(e).__name__, e.http_status, str(e)))
    return out

  assert outcome(torch_protocol, torch_faults) == outcome(jax_protocol,
                                                          jax_faults)


def test_fault_types_match_the_jax_package():
  for name in ('ServeRejection', 'BackpressureError', 'DrainingError',
               'DeadlineExceededError', 'BadRequestError',
               'RequestTooLargeError', 'FleetRejection', 'ReplicaLostError',
               'QuotaExceededError'):
    jcls, tcls = getattr(jax_faults, name), getattr(torch_faults, name)
    assert tcls.http_status == jcls.http_status, name
    for args in ((), ('detail',)):
      try:
        j, t = jcls(*args), tcls(*args)
      except TypeError:
        continue
      assert (str(t), t.kind) == (str(j), j.kind), name
    assert [c.__name__ for c in tcls.__mro__[:-2]] == [
        c.__name__ for c in jcls.__mro__[:-2]], name


@pytest.mark.parametrize('value', ['', '2.5', '-3', 'soon'])
def test_preempt_notice_hook_reads_as_the_jax_package(value, monkeypatch):
  monkeypatch.setenv(jax_faults.ENV_PREEMPT_AT_S, value)
  assert torch_faults.ENV_PREEMPT_AT_S == jax_faults.ENV_PREEMPT_AT_S
  assert (torch_faults.preempt_notice_after_s()
          == jax_faults.preempt_notice_after_s())


# ----------------------------------------------------------------------
# The stubbed service, both packages on one script


class Gate:
  """Holds the stub's dispatch: cleared, a dispatch blocks until set;
  `entered` fires when a dispatch is waiting."""

  def __init__(self):
    self.open = threading.Event()
    self.open.set()
    self.entered = threading.Event()

  def wait(self):
    if not self.open.is_set():
      self.entered.set()
      self.open.wait(30)


def stub_finalize(max_passes):
  def finalize(rows):
    ids = rows[:, 4 * max_passes, :, 0].astype(np.int32)
    return ids, np.full(ids.shape, STUB_QUAL, np.int32)
  return finalize


class PortStubRunner:
  """The port's stand-in for ModelRunner: no weights, no card."""

  obs = None

  def __init__(self, params, options, gate):
    self.params = params
    self.options = options
    self.window_buckets = tuple(options.window_buckets
                                or (params.max_length,))
    self._gate = gate
    self.finalize = stub_finalize(params.max_passes)

  def dispatch(self, rows, batch_size=None):
    del batch_size
    self._gate.wait()
    return rows

  def predict(self, rows):
    return self.finalize(self.dispatch(rows))


def port_stub(gate, buckets=None):
  params = torch_params()
  options = torch_runner.InferenceOptions(batch_size=BATCH,
                                          window_buckets=buckets)
  options.max_passes = params.max_passes
  options.max_length = params.max_length
  options.use_ccs_bq = params.use_ccs_bq
  return PortStubRunner(params, options, gate), options


def jax_stub(gate, buckets=None):
  params = jax_params()
  options = jax_runner.InferenceOptions(batch_size=BATCH)
  if buckets:
    options.window_buckets = buckets
  options.max_passes = params.max_passes
  options.max_length = params.max_length
  options.use_ccs_bq = params.use_ccs_bq
  runner = jax_runner.ModelRunner(params, {}, options)

  def dispatch(rows):
    gate.wait()
    return rows

  runner.dispatch = dispatch
  runner.finalize = stub_finalize(params.max_passes)
  return runner, options


PACKAGES = {
    'jax': (jax_stub, jax_service, jax_server, jax_client, jax_faults),
    'port': (port_stub, torch_service, torch_server, torch_client,
             torch_faults),
}


class Served:
  """One in-process service behind its HTTP server."""

  def __init__(self, package, runner, options, **serve_kw):
    _, service_lib, server_lib, client_lib, _ = PACKAGES[package]
    self.client_lib = client_lib
    self.service = service_lib.ConsensusService(
        runner, options, service_lib.ServeOptions(**serve_kw))
    self.warmup_s = self.service.warmup()
    self.service.start()
    self.httpd = server_lib.build_server(self.service, '127.0.0.1', 0)
    self.port = self.httpd.server_address[1]
    self.thread = threading.Thread(target=self.httpd.serve_forever,
                                   daemon=True)
    self.thread.start()

  def client(self, timeout=30):
    return self.client_lib.ServeClient(port=self.port, timeout=timeout)

  def close(self):
    self.service.begin_drain()
    self.httpd.shutdown()
    self.httpd.server_close()
    self.thread.join(10)
    assert self.service.drain(timeout=10)


@pytest.fixture
def served():
  made = []

  def make(*args, **kw):
    made.append(Served(*args, **kw))
    return made[-1]

  yield make
  for s in made:
    s.close()


def response_view(resp):
  return (resp['status'], resp['seq'], np.asarray(resp['quals']).tolist(),
          resp['counters'], resp['error'])


def rejection_view(client_lib, fn):
  try:
    return ('answered', response_view(fn()))
  except client_lib.ServeClientError as e:
    return (e.status, e.kind, e.payload.get('error'))


def stub_script(package, served, tmp_path, policy, monkeypatch):
  """One request sequence; returns what a client saw at each step, the
  service's counters and its dead letters without time and ids."""
  make_runner, _, _, client_lib, faults = PACKAGES[package]
  gate = Gate()
  runner, options = make_runner(gate)
  dead = str(tmp_path / f'{package}.failed.jsonl')
  s = served(package, runner, options, max_windows_per_request=6,
             io_timeout_s=IO_TIMEOUT_S, default_deadline_s=20.0,
             on_request_error=policy, dead_letter_path=dead)
  params = runner.params
  c = s.client()
  seen = [('ready', c.readyz()['_status'], c.healthz()['_status'])]
  seen.append(rejection_view(client_lib, lambda: c.polish(
      **molecule(params, 'm/10/ccs', seed=10))))
  seen.append(('garbage', client_lib.send_garbage('127.0.0.1', s.port)))
  seen.append(('oversized', client_lib.send_oversized('127.0.0.1', s.port)))
  seen.append(rejection_view(client_lib, lambda: c.polish(
      **molecule(params, 'm/11/ccs', n=7))))
  seen.append(rejection_view(client_lib, lambda: c.polish(
      **molecule(params, 'm/12/ccs', width=150))))
  # 429: one request held in the model loop's dispatch, max_pending 1.
  s.service.serve_options.max_pending = 1
  gate.open.clear()
  held = {}
  t = threading.Thread(target=lambda: held.update(
      r=c.polish(**molecule(params, 'm/13/ccs', seed=13))))
  t.start()
  assert gate.entered.wait(30)
  seen.append(rejection_view(client_lib, lambda: s.client().polish(
      **molecule(params, 'm/14/ccs'))))
  gate.open.set()
  t.join(30)
  s.service.serve_options.max_pending = 64
  seen.append(response_view(held['r']))
  # 504: the deadline passes while the dispatch is held.
  gate.entered.clear()
  gate.open.clear()
  seen.append(rejection_view(client_lib, lambda: c.polish(
      **molecule(params, 'm/15/ccs', seed=15), deadline_s=0.2)))
  gate.open.set()
  seen.append(rejection_view(client_lib, lambda: c.polish(
      **molecule(params, 'm/16/ccs', seed=16))))
  # The poisoned request: its pack and its isolation retry fail.
  monkeypatch.setenv(faults.ENV_POISON_WINDOW, 'm/666/')
  seen.append(rejection_view(client_lib, lambda: c.polish(
      **molecule(params, 'm/666/ccs', n=3, seed=66))))
  monkeypatch.delenv(faults.ENV_POISON_WINDOW)
  seen.append(rejection_view(client_lib, lambda: c.polish(
      **molecule(params, 'm/17/ccs', seed=17))))
  # Draining: no new admissions, alive, not ready.
  s.service.begin_drain()
  seen.append(('drain', c.readyz()['_status'], c.healthz()['_status']))
  seen.append(rejection_view(client_lib, lambda: c.polish(
      **molecule(params, 'm/18/ccs'))))
  stats = s.service.stats()
  letters = []
  if os.path.exists(dead):
    with open(dead) as f:
      for line in f:
        rec = json.loads(line)
        for key in ('time', 'trace_id', 'request_id'):
          assert key in rec or key == 'time'
          rec.pop(key, None)
        letters.append(rec)
  # device_epilogue is the runner's own flag: the JAX package's stub is
  # a ModelRunner with its epilogue on; the port's stub reports none.
  counters = {k: v for k, v in stats['counters'].items()
              if not k.startswith('stage_') and k != 'device_epilogue'}
  return seen, counters, stats['outcomes'], letters


@pytest.mark.parametrize('policy', ['ccs-fallback', 'skip'])
def test_stub_service_statuses_and_counters_match_jax(
    policy, served, tmp_path, monkeypatch):
  want = stub_script('jax', served, tmp_path, policy, monkeypatch)
  got = stub_script('port', served, tmp_path, policy, monkeypatch)
  seen = got[0]
  codes = [step[0] for step in seen]
  assert codes == ['ready', 'answered', 'garbage', 'oversized', 413, 400,
                   429, 'ok', 504, 'answered', 'answered', 'answered',
                   'drain', 503]
  assert seen[2][1] == 400 and seen[3][1] == 413
  assert seen[10][1][0] == ('fallback' if policy == 'ccs-fallback'
                           else 'quarantined')
  assert got[1]['n_quarantined_by_request'] == 1
  assert got[1]['n_deadline_cancelled'] == 1
  assert got[1]['n_rejected_backpressure'] == 1
  assert got[3] and got[3][0]['stage'] == 'model'
  assert got == want


def test_stub_service_metricz_and_prom_keys_match_jax(served):
  views = {}
  for package in PACKAGES:
    make_runner, *_ = PACKAGES[package]
    runner, options = make_runner(Gate())
    s = served(package, runner, options, io_timeout_s=IO_TIMEOUT_S)
    c = s.client()
    c.polish(**molecule(runner.params, 'm/20/ccs', seed=20))
    m = c.metricz()
    status, body, ctype = c._request('GET', '/metricz?format=prom')
    # mesh_dp and n_dispatched_by_bucket come from the JAX package's
    # ModelRunner (its stub is one); the port's stub has no such keys.
    keys = sorted(set(m) - {'mesh_dp', 'n_dispatched_by_bucket'})
    views[package] = (keys, sorted(m['counters']), m['capacity'],
                      m['latency']['count'], status, ctype,
                      'dctpu_n_requests{tier="serve"} 1' in body.decode())
  assert views['port'] == views['jax']


def test_debugz_profile_gives_a_status_dict(served, tmp_path):
  runner, options = port_stub(Gate())
  s = served('port', runner, options, io_timeout_s=30.0)
  status, body, _ = s.client()._request(
      'GET', f'/debugz/profile?seconds=0.1&out={tmp_path / "prof"}')
  result = json.loads(body)
  assert status == 200 and result['ok'], result
  assert os.path.exists(result['trace'])
  status, body, _ = s.client()._request('GET', '/debugz/profile?seconds=x')
  assert status == 400


def test_client_sabotage_hook_fires_on_the_port_client(served, monkeypatch):
  runner, options = port_stub(Gate())
  s = served('port', runner, options, io_timeout_s=IO_TIMEOUT_S)
  monkeypatch.setenv(torch_faults.ENV_SERVE_CLIENT_FAULT, 'garbage')
  monkeypatch.setenv(torch_faults.ENV_SERVE_CLIENT_FAULT_ZMW, '/40/')
  c = s.client()
  resp = c.polish(**molecule(runner.params, 'm/40/ccs'))
  assert (resp['status'], resp['mode']) == ('client-fault', 'garbage')
  assert c.polish(**molecule(runner.params, 'm/41/ccs'))['status'] == 'ok'
  assert s.service.stats()['counters']['n_requests'] == 1


# ----------------------------------------------------------------------
# The real model


@pytest.fixture(scope='module')
def model_pair():
  """(JAX params, JAX variables, port params, port state): one Flax init
  at 2 layers with non-zero ReZero alphas, carried to the port."""
  params = jax_params()
  with params.unlocked():
    params.update(SMALL)
    params.use_fused_hotpath = True
  variables = jax_model.get_model(params).init(
      jax.random.PRNGKey(0), jnp.zeros((1, params.total_rows, 100, 1)))
  flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(variables))
  rng = np.random.default_rng(3)
  for key in flat:
    if key[-1] == 'alpha':
      flat[key] = jnp.asarray(rng.uniform(0.5, 1.0), jnp.float32)
  variables = flax.traverse_util.unflatten_dict(flat)
  tparams = torch_params()
  tparams.update(SMALL)
  state = weights_lib.from_flax_params(
      jax.device_get(variables['params']), tparams)
  return params, variables, tparams, state


@pytest.fixture(scope='module')
def bam_sets(tmp_path_factory):
  root = str(tmp_path_factory.mktemp('serve_bams'))
  return {
      'L100': synthetic.write_synthetic_zmw_bams(
          os.path.join(root, 'l100'), n_zmws=6, n_subreads=4, seq_len=260,
          seed=11),
      # A request carries windows of one width, so each molecule's
      # windows share a bucket: half 100-wide, half 200-wide.
      'mixed': synthetic.write_synthetic_zmw_bams(
          os.path.join(root, 'mixed'), n_zmws=6, n_subreads=4, seq_len=600,
          seed=12, smart_windows=True, window_width_cycle=(100, 200)),
  }


def molecules(bams, buckets):
  layout = FeatureLayout(20, 100, window_buckets=buckets)
  feed, _ = torch_feeder.create_proc_feeder(
      bams[0], bams[1], layout=layout, ins_trim=5,
      use_ccs_smart_windows=buckets is not None)
  return [torch_runner.preprocess_zmw(z)[0] for z in feed()]


def read_records(path):
  with open(path, 'rb') as f:
    lines = f.read().split(b'\n')
  return {lines[i][1:].decode(): b'\n'.join(lines[i:i + 4]) + b'\n'
          for i in range(0, len(lines) - 1, 4)}


def serve_all(make_client, mols, n_clients=8):
  """Posts every molecule from n_clients threads; name -> response."""
  out, errors = {}, []

  def worker(k):
    c = make_client()
    try:
      for feats in mols[k::n_clients]:
        name = feats[0]['name']
        out[name] = c.polish_features(feats)
    except Exception as e:  # surfaced by the assert below
      errors.append(e)

  threads = [threading.Thread(target=worker, args=(k,))
             for k in range(n_clients)]
  for t in threads:
    t.start()
  for t in threads:
    t.join(120)
  assert not errors, errors
  return out


@pytest.mark.parametrize('path', ['L100', 'mixed'])
def test_served_reads_match_run_and_the_jax_service(
    path, model_pair, bam_sets, served, tmp_path):
  params, variables, tparams, state = model_pair
  buckets = (100, 200) if path == 'mixed' else None
  bams = bam_sets[path]
  mols = molecules(bams, buckets)
  kw = dict(batch_size=BATCH, min_quality=0, skip_windows_above=0)
  # The port's batch run over the same BAMs: the reference records.
  run_opts = torch_runner.InferenceOptions(
      **kw, window_buckets=buckets, use_ccs_smart_windows=bool(buckets))
  out = str(tmp_path / 'run.fastq')
  torch_runner.run_inference(
      bams[0], bams[1], out,
      torch_runner.ModelRunner(tparams, state, run_opts, device='cpu'))
  records = read_records(out)
  assert len(records) == len(mols) == 6
  # The port's service, driven through serve_main as `cli serve` does.
  topts = torch_runner.InferenceOptions(**kw, window_buckets=buckets)
  runner = torch_runner.ModelRunner(tparams, state, topts, device='cpu')
  topts.max_passes, topts.max_length, topts.use_ccs_bq = 20, 100, False
  ready, stop, result = {}, threading.Event(), {}
  thread = threading.Thread(target=lambda: result.update(
      torch_server.serve_main(
          runner, topts, torch_service.ServeOptions(
              io_timeout_s=IO_TIMEOUT_S), port=0,
          ready_fn=ready.update, stop_event=stop)))
  thread.start()
  try:
    while 'port' not in ready and thread.is_alive():
      thread.join(0.01)
    assert ready['event'] == 'ready' and ready['warmup_s'] >= 0
    got = serve_all(
        lambda: torch_client.ServeClient(port=ready['port'], timeout=60),
        mols)
  finally:
    stop.set()
    thread.join(60)
  assert result['drained'] and not result['preempted']
  assert result['counters']['n_requests'] == len(mols)
  # The JAX package's service over the same weights and requests.
  jopts = jax_runner.InferenceOptions(**kw)
  if buckets:
    jopts.window_buckets = buckets
  jopts.max_passes, jopts.max_length, jopts.use_ccs_bq = 20, 100, False
  s = served('jax', jax_runner.ModelRunner(params, variables, jopts), jopts,
             io_timeout_s=IO_TIMEOUT_S)
  want = serve_all(lambda: s.client(timeout=60), mols)
  for name, resp in got.items():
    assert resp['status'] == 'ok', name
    record = stitch.format_fastq_bytes(name, resp['seq'], resp['quals'])
    assert record == records[name], name
    assert response_view(resp) == response_view(want[name]), name
  if buckets:
    assert set(result['counters']['n_packs_by_bucket']) == {100, 200}


# ----------------------------------------------------------------------
# cli serve


def test_cli_serve_refuses_what_the_port_does_not_run(tmp_path, monkeypatch):
  with pytest.raises(torch_faults.NotPortedError, match='multi-card'):
    cli.main(['serve', '--random_init', '--dp', '2', '--device', 'cpu'])
  with pytest.raises(torch_faults.NotPortedError, match='multi-card'):
    cli.main(['serve', '--random_init', '--tp', '2', '--device', 'cpu'])
  exported = tmp_path / 'exported'
  exported.mkdir()
  (exported / 'export_meta.json').write_text('{}')
  with pytest.raises(torch_faults.NotPortedError, match='exported'):
    cli.main(['serve', '--checkpoint', str(exported), '--device', 'cpu'])
  with pytest.raises(ValueError, match='--random_init'):
    cli.main(['serve', '--device', 'cpu'])
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='no CUDA device'):
    cli.main(['serve', '--random_init'])


def test_random_init_is_seeded_and_serves_on_cpu(served):
  """--random_init: the preset's model from a torch.Generator seeded 0,
  the same bits every time, served on the CPU."""
  params, state = torch_runner.load_model(
      random_init_config='transformer_learn_values+test')
  _, again = torch_runner.load_model(
      random_init_config='transformer_learn_values+test')
  assert state.keys() == again.keys()
  assert all(torch.equal(state[k], again[k]) for k in state)
  opts = torch_runner.InferenceOptions(batch_size=2, min_quality=0,
                                       skip_windows_above=0)
  runner = torch_runner.ModelRunner(params, state, opts, device='cpu')
  opts.max_passes, opts.max_length, opts.use_ccs_bq = 20, 100, False
  s = served('port', runner, opts, io_timeout_s=IO_TIMEOUT_S)
  resp = s.client().polish(**molecule(params, 'm/50/ccs', n=2, seed=50))
  assert resp['status'] == 'ok' and len(resp['seq']) > 0
