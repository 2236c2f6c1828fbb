"""The port's fleet tier (deepconsensus_tpu_torch/fleet: `route`,
`featurize-worker`) against the JAX package's.

* Registry and balancer: both packages' ReplicaRegistry and
  LeastLoadedBalancer run on one scripted probe sequence (a fake probe
  client stands in for the replicas' /readyz and /metricz) and one
  sequence of acquires and releases: the same replica states, the same
  picks in the same order, the same typed rejections (class, status,
  message), the same aggregated counters and QoS views. Exact: no
  tolerance.
* Router: in-process over two stub replicas of the port (weightless:
  ids from the draft CCS row, quality 40): concurrent clients get the
  bytes a solo replica gives; a replica that never reads the request is
  retried elsewhere and marked dead; one that dies after reading it
  gives a typed 503 (ReplicaLostError) and the request is never placed
  again.
* Featurize worker: a one-ZMW bam/1 body gives the JAX package's
  worker's bytes (compact features/1 and float32 frames; zip members
  stamped with one fixed time) and the same typed rejections; through
  the router, the bam/1 answer equals its features/1 body posted to the
  replica.

Everything binds port 0 on 127.0.0.1 and is stopped at the end of each
test; route_main and worker_main run off the main thread, so they
install no signal handler.
"""
import json
import os
import re
import socket
import struct
import threading
import time
import types
import zipfile

import numpy as np
import pytest
import torch

from deepconsensus_tpu import faults as jax_faults
from deepconsensus_tpu.fleet import balancer as jax_balancer
from deepconsensus_tpu.fleet import featurize_worker as jax_worker
from deepconsensus_tpu.fleet import registry as jax_registry
from deepconsensus_tpu_torch import cli
from deepconsensus_tpu_torch import faults as torch_faults
from deepconsensus_tpu_torch.fleet import balancer as torch_balancer
from deepconsensus_tpu_torch.fleet import featurize_worker as torch_worker
from deepconsensus_tpu_torch.fleet import registry as torch_registry
from deepconsensus_tpu_torch.fleet import router as router_lib
from deepconsensus_tpu_torch.inference import runner as runner_lib
from deepconsensus_tpu_torch.models import config as config_lib
from deepconsensus_tpu_torch.preprocess import feeder as feeder_lib
from deepconsensus_tpu_torch.preprocess.pileup import FeatureLayout
from deepconsensus_tpu_torch.serve import protocol
from deepconsensus_tpu_torch.serve import server as server_lib
from deepconsensus_tpu_torch.serve import service as service_lib
from deepconsensus_tpu_torch.serve.client import ServeClient
from deepconsensus_tpu_torch.testing import synthetic

BATCH = 8
STUB_QUAL = 40
MODEL, FEATURIZE = 'model', 'featurize'


@pytest.fixture(autouse=True)
def one_torch_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.fixture
def fixed_zip_time(monkeypatch):
  """One fixed clock for zipfile, so two np.savez bodies compare byte
  for byte."""
  monkeypatch.setattr(zipfile, 'time', types.SimpleNamespace(
      time=lambda: 1.7e9, localtime=time.localtime))


@pytest.fixture(scope='module')
def params():
  p = config_lib.get_config('transformer_learn_values+test')
  config_lib.finalize_params(p)
  return p


# ----------------------------------------------------------------------
# Registry and balancer on one script


class ScriptedProbes:
  """What each replica answers to the registry's probes this round:
  url -> None (connection refused) or (readyz dict, metricz dict)."""

  def __init__(self):
    self.answers = {}

  def client_class(self):
    answers = self.answers

    class FakeProbeClient:

      def __init__(self, host=None, port=None, timeout=None):
        del timeout
        self.answer = answers.get(f'{host}:{port}')

      def readyz(self):
        if self.answer is None:
          raise OSError('connection refused')
        return dict(self.answer[0])

      def metricz(self):
        return dict(self.answer[1])

    return FakeProbeClient


def ready(queue=0, mesh_dp=1, degraded=False, counters=None):
  return ({'ready': True, 'mesh_dp': mesh_dp, 'degraded': degraded},
          {'outstanding': queue, 'counters': counters or {}})


DRAINING = ({'ready': False, 'draining': True}, {'outstanding': 3})
WARMING = ({'ready': False}, {'outstanding': 0})

ROUNDS = [
    {'10.0.0.1:1': ready(queue=6, counters={'n_requests': 3,
                                            'x_fraction': 0.5,
                                            'warmup_s': 2.0}),
     '10.0.0.2:1': ready(queue=0, counters={'n_requests': 4,
                                            'x_fraction': 1.0}),
     '10.0.0.3:1': ready(queue=0, degraded=True),
     '10.0.0.4:1': ready(mesh_dp=4, queue=9),
     '10.0.0.9:1': ready()},
    {'10.0.0.1:1': DRAINING, '10.0.0.2:1': None,
     '10.0.0.3:1': ready(queue=1), '10.0.0.4:1': WARMING,
     '10.0.0.9:1': ready()},
    {'10.0.0.1:1': ready(queue=2), '10.0.0.2:1': ready(),
     '10.0.0.3:1': None, '10.0.0.4:1': ready(mesh_dp=4),
     '10.0.0.9:1': None},
    {'10.0.0.1:1': ready(), '10.0.0.2:1': ready(),
     '10.0.0.3:1': ready(), '10.0.0.4:1': ready(mesh_dp=2),
     '10.0.0.9:1': ready()},
]

# (op, args): acquire(tier, exclude, klass, client) | release(url, outcome,
# klass, client) | mark(url, how) | add(url, tier) | remove(url)
OPS = [
    [('acquire', (MODEL, (), None, None)) for _ in range(6)]
    + [('acquire', (MODEL, ('10.0.0.2:1',), 'bulk', 't1')),
       ('acquire', (MODEL, (), 'bulk', 't1')),
       ('acquire', (MODEL, (), 'bulk', 't1')),
       ('release', ('10.0.0.2:1', 'ok', None, None)),
       ('release', ('10.0.0.3:1', 'reject', 'bulk', 't1')),
       ('acquire', (FEATURIZE, (), None, None)),
       ('release', ('10.0.0.9:1', 'send_failure', None, None)),
       ('acquire', (FEATURIZE, ('10.0.0.9:1',), None, None))],
    [('acquire', (MODEL, (), None, 'q')) for _ in range(4)]
    + [('release', ('10.0.0.3:1', 'lost', None, 'q')),
       ('acquire', (FEATURIZE, (), None, None))],
    [('acquire', (MODEL, (), None, None)) for _ in range(3)]
    + [('mark', ('10.0.0.1:1', 'draining')),
       ('acquire', (MODEL, (), 'interactive', None)),
       ('mark', ('10.0.0.4:1', 'unreachable')),
       ('acquire', (MODEL, ('10.0.0.2:1',), None, None))],
    [('add', ('10.0.0.5:1', MODEL)),
     ('add', ('10.0.0.3:1', MODEL)),
     ('remove', ('10.0.0.4:1',)),
     ('acquire', (MODEL, (), None, None))]
    + [('acquire', (MODEL, (), 'bulk', 'q2')) for _ in range(4)],
]


def run_fleet_script(registry_lib, balancer_lib, faults, monkeypatch):
  probes = ScriptedProbes()
  monkeypatch.setattr(registry_lib, 'ServeClient', probes.client_class())
  reg = registry_lib.ReplicaRegistry(dead_after=1, ready_after=2)
  for url in ('10.0.0.1:1', '10.0.0.2:1', '10.0.0.3:1', '10.0.0.4:1'):
    reg.add(url, tier=MODEL)
  reg.add('10.0.0.9:1', tier=FEATURIZE)
  bal = balancer_lib.LeastLoadedBalancer(reg, max_inflight=2,
                                         client_quota=2)
  trace = []
  try:
    bal.acquire(MODEL)
  except faults.FleetRejection as e:
    trace.append(('before_probe', type(e).__name__, str(e)))
  for answers, ops in zip(ROUNDS, OPS):
    probes.answers.clear()
    probes.answers.update(answers)
    reg.probe_all()
    trace.append(sorted((r.url, r.state, r.mesh_dp, r.degraded,
                         r.queue_depth, r.healing, r.heal_streak,
                         r.probe_failures) for r in reg.snapshot()))
    for op, args in ops:
      try:
        if op == 'acquire':
          tier, exclude, klass, client = args
          trace.append(bal.acquire(tier, exclude=exclude, klass=klass,
                                   client=client).url)
        elif op == 'release':
          url, outcome, klass, client = args
          bal.release(url, outcome, klass=klass, client=client)
        elif op == 'mark':
          url, how = args
          getattr(reg, f'mark_{how}')(url)
        elif op == 'add':
          trace.append(reg.add(*args).state)
        else:
          trace.append(reg.remove(*args))
      except faults.ServeRejection as e:
        trace.append((type(e).__name__, e.http_status, e.kind, str(e)))
    trace.append(reg.tier_states())
    trace.append(reg.aggregate_counters())
    trace.append(bal.qos_snapshot())
    trace.append(sorted((r.url, r.in_flight, r.n_routed, r.n_ok,
                         r.n_upstream_rejects, r.n_send_failures, r.n_lost)
                        for r in reg.snapshot()))
  with pytest.raises(ValueError) as e:
    reg.add('10.0.0.7:1', tier='gpu')
  trace.append(str(e.value))
  return trace


def test_registry_and_balancer_picks_match_jax(monkeypatch):
  want = run_fleet_script(jax_registry, jax_balancer, jax_faults,
                          monkeypatch)
  got = run_fleet_script(torch_registry, torch_balancer, torch_faults,
                         monkeypatch)
  assert got == want
  picks = [x for x in got if isinstance(x, str) and x.startswith('10.')]
  assert len(set(picks)) >= 4
  kinds = {x[0] for x in got if isinstance(x, tuple) and len(x) == 4}
  assert {'FleetRejection', 'QuotaExceededError'} <= kinds


@pytest.mark.parametrize('weights', [None, {'interactive': 4.0, 'bulk': 1.0},
                                     {'gold': 3.0, 'bulk': 0.5}])
def test_weighted_fair_waits_grant_in_the_jax_order(weights):
  """Saturated acquires that wait their weighted-fair turn: with one
  slot freed at a time, the classes are granted in the same order by
  both balancers."""
  orders = {}
  for name, registry_lib, balancer_lib in (
      ('jax', jax_registry, jax_balancer),
      ('port', torch_registry, torch_balancer)):
    reg = registry_lib.ReplicaRegistry()
    reg.add('10.0.0.1:1', tier=MODEL)
    with reg.lock:
      reg._replicas['10.0.0.1:1'].state = registry_lib.ReplicaState.READY
    bal = balancer_lib.LeastLoadedBalancer(
        reg, max_inflight=1, class_weights=weights, queue_wait_s=30.0)
    bal.acquire(MODEL)
    classes = sorted(bal.class_weights) * 3
    granted, threads = [], []
    for k, klass in enumerate(classes):
      t = threading.Thread(target=lambda c=klass, i=k: (
          bal.acquire(MODEL, klass=c), granted.append((c, i))))
      t.start()
      threads.append(t)
      # Wait until this waiter is queued, so the arrival order is fixed.
      while sum(bal.qos_snapshot()['queued'].values()) < k + 1:
        t.join(0.005)
    for _ in classes:
      n = len(granted)
      bal.release('10.0.0.1:1', 'ok')
      while len(granted) == n:
        threads[0].join(0.005)
    for t in threads:
      t.join(10)
    orders[name] = granted
  assert orders['port'] == orders['jax']


# ----------------------------------------------------------------------
# Router and featurize worker, in process


class StubRunner:
  """Weightless stand-in for ModelRunner (no card)."""

  obs = None

  def __init__(self, params):
    self.params = params
    self.window_buckets = (params.max_length,)

  def dispatch(self, rows, batch_size=None):
    del batch_size
    return rows

  def finalize(self, rows):
    ids = rows[:, 4 * self.params.max_passes, :, 0].astype(np.int32)
    return ids, np.full(ids.shape, STUB_QUAL, np.int32)

  def predict(self, rows):
    return self.finalize(rows)


class Fleet:
  """Stub replicas, featurize workers and one router, all in process."""

  def __init__(self, params):
    self.params = params
    self.replicas = []  # (service, httpd, thread, port)
    self.workers = []   # (stop, thread, port, stats)
    self.router = None  # (stop, thread, port, stats)

  def add_replica(self):
    options = runner_lib.InferenceOptions(batch_size=BATCH)
    options.max_passes = self.params.max_passes
    options.max_length = self.params.max_length
    options.use_ccs_bq = self.params.use_ccs_bq
    service = service_lib.ConsensusService(
        StubRunner(self.params), options,
        service_lib.ServeOptions(io_timeout_s=5.0))
    service.warmup()
    service.start()
    httpd = server_lib.build_server(service, '127.0.0.1', 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    self.replicas.append((service, httpd, thread, httpd.server_address[1]))
    return self.replicas[-1]

  @staticmethod
  def _start(main, *args, **kw):
    stop, ready, stats = threading.Event(), {}, {}
    thread = threading.Thread(target=lambda: stats.update(main(
        *args, port=0, ready_fn=ready.update, stop_event=stop, **kw)),
                              daemon=True)
    thread.start()
    while 'port' not in ready and thread.is_alive():
      thread.join(0.01)
    return stop, thread, ready['port'], stats

  def add_worker(self, **kw):
    opts = torch_worker.FeaturizeWorkerOptions(
        max_passes=self.params.max_passes, max_length=self.params.max_length,
        **kw)
    self.workers.append(self._start(torch_worker.worker_main, opts))
    return self.workers[-1]

  def start_router(self, **kw):
    opts = router_lib.RouterOptions(**{
        'probe_interval_s': 0.1, 'probe_timeout_s': 2.0,
        'io_timeout_s': 5.0, **kw})
    self.router = self._start(
        router_lib.route_main,
        [f'127.0.0.1:{r[3]}' for r in self.replicas],
        [f'127.0.0.1:{w[2]}' for w in self.workers], options=opts)
    return ServeClient(port=self.router[2], timeout=30)

  def close(self):
    if self.router:
      self.router[0].set()
      self.router[1].join(15)
    for stop, thread, _, _ in self.workers:
      stop.set()
      thread.join(15)
    for service, httpd, thread, _ in self.replicas:
      service.begin_drain()
      httpd.shutdown()
      httpd.server_close()
      thread.join(10)
      service.drain(timeout=10)


@pytest.fixture
def fleet(params):
  made = []

  def make():
    made.append(Fleet(params))
    return made[-1]

  yield make
  for f in made:
    f.close()


def wait_ready(client, want_replicas):
  """Until the router's probes have promoted want_replicas replicas."""
  deadline = time.monotonic() + 20
  while time.monotonic() < deadline:
    states = client.metricz()['replicas']
    if sum(r['state'] == 'ready' for r in states) >= want_replicas:
      return
    threading.Event().wait(0.02)
  raise AssertionError(f'replicas never became ready: {states}')


def molecule(params, name, n=4, seed=0):
  rng = np.random.default_rng(seed)
  subreads = rng.integers(
      0, 5, size=(n, params.total_rows, params.max_length, 1)
  ).astype(np.float32)
  subreads[:, -4:] = rng.integers(0, 9, size=(n, 4, 1, 1))
  return dict(name=name, subreads=subreads,
              window_pos=np.arange(n, dtype=np.int64) * params.max_length,
              ccs_bq=np.full((n, params.max_length), 30, dtype=np.int32),
              overflow=np.zeros(n, dtype=np.uint8))


def test_router_spreads_concurrent_clients_with_solo_bytes(fleet, params):
  f = fleet()
  f.add_replica()
  f.add_replica()
  rc = f.start_router()
  wait_ready(rc, 2)
  solo = ServeClient(port=f.replicas[0][3], timeout=30)
  mols = [molecule(params, f'm/{i}/ccs', n=2 + i % 3, seed=i)
          for i in range(8)]
  want = [solo.polish(**m) for m in mols]
  got, errors = [None] * len(mols), []

  def worker(i):
    try:
      got[i] = ServeClient(port=f.router[2], timeout=30).polish(**mols[i])
    except Exception as e:  # surfaced by the assert below
      errors.append(e)

  threads = [threading.Thread(target=worker, args=(i,))
             for i in range(len(mols))]
  for t in threads:
    t.start()
  for t in threads:
    t.join(30)
  assert not errors
  for w, g in zip(want, got):
    assert (g['status'], g['seq']) == ('ok', w['seq'])
    np.testing.assert_array_equal(g['quals'], w['quals'])
  m = rc.metricz()
  assert m['counters']['n_routed_model'] == len(mols)
  assert len([r for r in m['replicas'] if r['n_ok'] > 0]) == 2


def test_send_phase_failure_retries_on_another_replica(fleet, params):
  f = fleet()
  f.add_replica()
  f.add_replica()
  rc = f.start_router(max_attempts=3)
  wait_ready(rc, 2)
  # Replica 0 stops listening before the prober notices.
  service, httpd, thread, port = f.replicas[0]
  httpd.shutdown()
  httpd.server_close()
  assert all(rc.polish(**molecule(params, f'r/{i}/ccs'))['status'] == 'ok'
             for i in range(4))
  states = {r['url']: r['state'] for r in rc.metricz()['replicas']}
  assert states[f'127.0.0.1:{port}'] == 'dead'
  assert f.replicas[1][0].stats()['counters']['n_requests'] == 4


def evil_replica():
  """Reads a whole POST, then resets the connection: no response."""
  sock = socket.socket()
  sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
  sock.bind(('127.0.0.1', 0))
  sock.listen(4)
  seen = []

  def loop():
    while True:
      try:
        conn, _ = sock.accept()
      except OSError:
        return
      with conn:
        data = b''
        while b'\r\n\r\n' not in data:
          chunk = conn.recv(65536)
          if not chunk:
            break
          data += chunk
        head, _, rest = data.partition(b'\r\n\r\n')
        length = 0
        for line in head.split(b'\r\n'):
          if line.lower().startswith(b'content-length:'):
            length = int(line.split(b':', 1)[1])
        while len(rest) < length:
          chunk = conn.recv(65536)
          if not chunk:
            break
          rest += chunk
        seen.append(len(rest))
        conn.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack('ii', 1, 0))

  threading.Thread(target=loop, daemon=True).start()
  return sock, seen


def test_post_send_death_is_a_typed_503_never_placed_twice(fleet, params):
  f = fleet()
  service = f.add_replica()[0]
  evil, seen = evil_replica()
  try:
    registry = torch_registry.ReplicaRegistry()
    evil_url = f'127.0.0.1:{evil.getsockname()[1]}'
    for url, queue in ((evil_url, 0), (f'127.0.0.1:{f.replicas[0][3]}', 50)):
      registry.add(url)
      with registry.lock:
        replica = registry._replicas[url]
        replica.state = torch_registry.ReplicaState.READY
        replica.queue_depth = queue
    core = router_lib.RouterCore(registry, router_lib.RouterOptions(
        max_attempts=3, upstream_timeout_s=10))
    body = protocol.request_from_features([
        dict(name='d/1/ccs', subreads=w, window_pos=i * 100,
             ccs_base_quality_scores=np.full(100, 30), overflow=False)
        for i, w in enumerate(molecule(params, 'd/1/ccs')['subreads'])])
    with pytest.raises(torch_faults.ReplicaLostError) as e:
      core.route(body)
    assert (e.value.http_status, e.value.kind) == (503, 'transient')
    assert 'never duplicated' in str(e.value)
    assert seen == [len(body)]
    assert service.stats()['counters']['n_requests'] == 0
    assert core.stats()['counters']['n_replica_lost'] == 1
    with registry.lock:
      assert registry._replicas[evil_url].state == 'dead'
  finally:
    evil.close()


@pytest.fixture(scope='module')
def one_zmw_bams(tmp_path_factory):
  root = str(tmp_path_factory.mktemp('fleet_bams'))
  return [synthetic.write_synthetic_zmw_bams(
      os.path.join(root, f'z{i}'), n_zmws=1, n_subreads=3, seq_len=260,
      movie=f'm0000{i}_000000_000000', seed=30 + i) for i in range(3)]


def bam_body(bams, name=''):
  with open(bams[0], 'rb') as a, open(bams[1], 'rb') as b:
    return protocol.encode_bam_request(a.read(), b.read(), name=name)


@pytest.mark.parametrize('compact', [True, False])
def test_featurize_worker_bytes_match_jax(compact, one_zmw_bams,
                                          fixed_zip_time, tmp_path):
  kw = dict(max_passes=20, max_length=100, compact=compact,
            work_dir=str(tmp_path))
  port = torch_worker.FeaturizeService(
      torch_worker.FeaturizeWorkerOptions(**kw))
  ref = jax_worker.FeaturizeService(jax_worker.FeaturizeWorkerOptions(**kw))
  for bams in one_zmw_bams:
    body = bam_body(bams, name='z')
    got, want = port.featurize(body), ref.featurize(body)
    assert got == want
    assert (protocol.sniff_frame(got) == protocol.FRAME_FEATURES) == compact
  assert port.stats()['counters'] == ref.stats()['counters']
  assert not os.listdir(tmp_path)


def test_featurize_worker_rejects_as_jax(params, tmp_path):
  two = synthetic.write_synthetic_zmw_bams(str(tmp_path / 'two'), n_zmws=2,
                                           seq_len=150)
  bodies = [bam_body(two, name='two'), b'garbage',
            protocol.encode_bam_request(b'\x1f\x8b junk', b'junk', name='j'),
            protocol.encode_request(**molecule(params, 'm/1/ccs', n=1))]
  kw = dict(max_passes=20, max_length=100, work_dir=str(tmp_path))
  seen = {}
  for package, worker, faults in (('port', torch_worker, torch_faults),
                                  ('jax', jax_worker, jax_faults)):
    service = worker.FeaturizeService(worker.FeaturizeWorkerOptions(**kw))
    seen[package] = []
    for body in bodies:
      with pytest.raises(faults.BadRequestError) as e:
        service.featurize(body)
      # Each package writes the request's BAMs to a temporary directory
      # of its own, which the message names.
      seen[package].append((type(e.value).__name__, e.value.http_status,
                            re.sub(r'dctpu_featurize_\w+', 'TMP',
                                   str(e.value))))
    seen[package].append(service.stats()['counters'])
  assert seen['port'] == seen['jax']
  assert 'one request per ZMW' in seen['port'][0][2]


def test_bam_frames_through_the_router_match_direct_features(
    fleet, params, one_zmw_bams):
  f = fleet()
  f.add_replica()
  f.add_worker()
  rc = f.start_router()
  wait_ready(rc, 2)
  replica = ServeClient(port=f.replicas[0][3], timeout=30)
  layout = FeatureLayout(params.max_passes, params.max_length)
  for bams in one_zmw_bams:
    feed, _ = feeder_lib.create_proc_feeder(bams[0], bams[1], layout=layout)
    feats = [runner_lib.preprocess_zmw(z)[0] for z in feed()]
    assert len(feats) == 1
    want = replica.polish_body(protocol.features_pack_from_features(feats[0]))
    got = rc.polish_body(bam_body(bams))
    assert got['status'] == 'ok'
    assert (got['seq'], got['quals'].tolist()) == (want['seq'],
                                                   want['quals'].tolist())
  m = rc.metricz()
  assert m['counters']['n_routed_featurize'] == len(one_zmw_bams)
  assert m['latency']['featurize']['count'] == len(one_zmw_bams)
  # The router's drain: no new work, then it exits drained.
  f.router[0].set()
  f.router[1].join(15)
  assert f.router[3]['drained']


def test_cli_route_and_worker_validate_their_flags():
  with pytest.raises(ValueError, match='--replica'):
    cli.main(['route'])
  with pytest.raises(ValueError, match='CLASS=WEIGHT'):
    cli.main(['route', '--replica', '127.0.0.1:1', '--class_weight', 'x'])
  with pytest.raises(ValueError):
    cli.main(['featurize-worker', '--window_buckets', '150'])


def test_router_relays_a_draining_replica_and_marks_it(fleet, params):
  """An explicit draining 503 moves the request to the other replica
  and flips the draining one at once, before the next probe."""
  f = fleet()
  f.add_replica()
  f.add_replica()
  rc = f.start_router(probe_interval_s=30.0)
  wait_ready(rc, 2)
  f.replicas[0][0].begin_drain()
  results = [rc.polish(**molecule(params, f'x/{i}/ccs', seed=i))['status']
             for i in range(3)]
  assert results == ['ok'] * 3
  states = {r['url']: r['state'] for r in rc.metricz()['replicas']}
  assert states[f'127.0.0.1:{f.replicas[0][3]}'] in ('draining', 'ready')
  assert f.replicas[1][0].stats()['counters']['n_requests'] == 3
  assert json.loads(json.dumps(rc.readyz()))['ready']


def module_imports(name):
  """The deepconsensus_tpu_torch modules and top-level packages that
  importing `name` loads at module level (imports inside functions are
  deferred and left out), transitively."""
  import ast

  import deepconsensus_tpu_torch

  root = os.path.dirname(os.path.dirname(os.path.abspath(
      deepconsensus_tpu_torch.__file__)))
  seen, todo, outside = set(), [name], set()
  while todo:
    mod = todo.pop()
    if mod in seen:
      continue
    seen.add(mod)
    base = os.path.join(root, *mod.split('.'))
    path = (os.path.join(base, '__init__.py') if os.path.isdir(base)
            else base + '.py')
    parts = mod.split('.')
    for i in range(1, len(parts)):  # parent packages run first
      todo.append('.'.join(parts[:i]))
    with open(path) as f:
      tree = ast.parse(f.read())
    for node in tree.body:
      names = []
      if isinstance(node, ast.Import):
        names = [a.name for a in node.names]
      elif isinstance(node, ast.ImportFrom) and node.module:
        names = [node.module] + [f'{node.module}.{a.name}'
                                 for a in node.names]
      for n in names:
        if n.startswith('deepconsensus_tpu_torch'):
          b = os.path.join(root, *n.split('.'))
          if os.path.isdir(b) or os.path.exists(b + '.py'):
            todo.append(n)
        else:
          outside.add(n.split('.')[0])
  return seen, outside


@pytest.mark.parametrize('name', [
    'deepconsensus_tpu_torch.serve.protocol',
    'deepconsensus_tpu_torch.serve.client',
    'deepconsensus_tpu_torch.serve.server',
    'deepconsensus_tpu_torch.fleet.router',
    'deepconsensus_tpu_torch.fleet.featurize_worker',
    'deepconsensus_tpu_torch.obs.profiler'])
def test_cpu_tiers_import_no_torch(name):
  """The router, the featurize worker and the wire format load without
  torch (a featurize worker stays light); serve/__init__.py's lazy
  re-export keeps the service, which needs torch, out."""
  mods, outside = module_imports(name)
  assert 'torch' not in outside, sorted(mods)
  assert not {'jax', 'deepconsensus_tpu'} & outside
  assert 'deepconsensus_tpu_torch.serve.service' not in mods
