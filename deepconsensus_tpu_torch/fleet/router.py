"""`route`: the fleet front tier for /v1/polish.

Port of deepconsensus_tpu/fleet/router.py (no torch: it imports neither
the model nor the engine).

Same stdlib HTTP conventions as serve/server.py (ThreadingHTTPServer,
absolute read deadlines, typed JSON errors), but no model: the router
steers bodies by their protocol frame —

  bam/1        -> a featurize worker (/v1/featurize) turns raw BAM
                  bytes into a compact features/1 pack, then the pack
                  goes to a model replica;
  features/1 or
  legacy float -> straight to a model replica's /v1/polish.

Placement is the balancer's weighted least-loaded pick over READY
replicas (registry.py owns health). Failure semantics around a dying
replica are deliberately asymmetric:

  * connect/send-phase failure: the replica provably never read the
    request ("never acked") — safe to retry against a different
    replica, excluding every replica already tried;
  * explicit upstream rejection (429/503): the replica refused the
    request, so it was not accepted — also safe to retry elsewhere
    (a draining 503 additionally flips the replica to DRAINING now,
    not at the next probe — the rolling-restart fast path);
  * failure after the request was fully written: the replica may have
    accepted the work, so the router must NOT place it again — that
    could duplicate an accepted request. It surfaces as a typed
    ReplicaLostError (503, transient) and the client decides.

/metricz aggregates the fleet: router counters, per-tier end-to-end
latency percentiles, per-replica snapshots, and the summed counters
from every replica's cached /metricz probe.

Rollout: SIGTERM stops admissions (/readyz goes 503 draining, new
polish gets a typed 503) and waits for in-flight forwards to finish —
zero accepted-then-lost through the router, same contract as serve.
"""
from __future__ import annotations

import dataclasses
import http.client
import io
import json
import logging
import re
import threading
import time
import socket
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

from deepconsensus_tpu_torch import faults as shared_faults
from deepconsensus_tpu_torch import obs as obs_lib
from deepconsensus_tpu_torch.fleet import registry as registry_lib
from deepconsensus_tpu_torch.fleet import balancer as balancer_lib
from deepconsensus_tpu_torch.fleet.balancer import LeastLoadedBalancer
from deepconsensus_tpu_torch.serve import protocol
from deepconsensus_tpu_torch.serve.server import _DeadlineSocketIO, _StopFlag

log = logging.getLogger(__name__)

_RETRYABLE_UPSTREAM = (429, 503)  # explicit refusal: request not accepted
_CLASS_RE = re.compile(r'^[a-z0-9_-]{1,32}$')


@dataclasses.dataclass
class RouterOptions:
  max_body_bytes: int = 64 << 20
  io_timeout_s: float = 20.0
  upstream_timeout_s: float = 300.0  # one forwarded polish, end to end
  probe_interval_s: float = 0.5
  probe_timeout_s: float = 5.0
  max_inflight: int = 8              # per replica, scaled by mesh_dp
  max_attempts: int = 3              # distinct replicas tried per request
  latency_window: int = 2048         # per-tier latency samples retained
  # Multi-tenant QoS (balancer.py): class weights for weighted-fair
  # admission, the class unlabeled requests land in, the per-client
  # concurrent-request quota (0 = unlimited), how long a saturated
  # acquire may wait its weighted-fair turn (0 = shed immediately,
  # the pre-QoS behavior), and the per-class waiter bound.
  class_weights: Optional[Dict[str, float]] = None
  default_class: str = balancer_lib.DEFAULT_CLASS
  client_quota: int = 0
  queue_wait_s: float = 0.0
  max_queued_per_class: int = 16


class _SendPhaseError(OSError):
  """Connect or request-write failed: the replica never read the
  request, so retrying it elsewhere cannot duplicate accepted work.
  Internal control flow — never crosses the wire."""


class _UpstreamRejected(RuntimeError):
  """Upstream answered a retryable rejection (429/503): carry it so
  the last attempt can relay the replica's own typed error."""

  def __init__(self, status: int, body: bytes, draining: bool):
    super().__init__(f'upstream rejected with {status}')
    self.status = status
    self.body = body
    self.draining = draining


class RouterCore:
  """Steering + forwarding, HTTP-server-free so tests drive it
  directly. Handler threads call route() concurrently; shared mutable
  state is the counters/latency maps under self._lock (replica state
  lives in the registry, under its own lock)."""

  def __init__(self, registry: registry_lib.ReplicaRegistry,
               options: Optional[RouterOptions] = None):
    self.registry = registry
    self.options = options or RouterOptions()
    self.balancer = LeastLoadedBalancer(
        registry, max_inflight=self.options.max_inflight,
        class_weights=self.options.class_weights,
        default_class=self.options.default_class,
        client_quota=self.options.client_quota,
        queue_wait_s=self.options.queue_wait_s,
        max_queued_per_class=self.options.max_queued_per_class)
    self._lock = threading.Lock()
    # Central metrics registry (obs/metrics.py): counters pre-created
    # so /metricz always exposes the full set, per-tier forwarding
    # latency histograms replacing the deque percentile math.
    self.obs = obs_lib.MetricsRegistry(tier='router')
    for key in ('n_requests', 'n_routed_model', 'n_routed_featurize',
                'n_retries', 'n_rejected_saturated', 'n_replica_lost',
                'n_bad_requests', 'n_upstream_rejects_relayed',
                'n_registered', 'n_quota_rejected'):
      self.obs.counter(key)
    self._tier_hists = {
        tier: self.obs.histogram(
            f'route_{tier}_latency_s',
            help=f'forwarding latency to the {tier} tier')
        for tier in registry_lib.TIERS
    }
    # Per-class end-to-end latency (the per-class SLO signal): one
    # histogram per priority class, pre-created for the configured
    # weights so /metricz exposes the classes before traffic arrives.
    self._class_hists: Dict[str, Any] = {}  # guarded by: self._lock
    for klass in sorted(self.balancer.class_weights):
      self._class_hist(klass)
    self._draining = False  # dclint: lock-free (monotonic bool flip,
    # read per request; worst case one request admitted during drain
    # finishes normally before drain() returns)
    self._in_flight = 0  # guarded by: self._lock

  def bump(self, key: str, n: int = 1) -> None:
    self.obs.inc(key, n)

  def _class_hist(self, klass: str):
    with self._lock:
      hist = self._class_hists.get(klass)
      if hist is None:
        hist = self.obs.histogram(
            f'route_class_{klass}_latency_s',
            help=f'end-to-end routed latency for priority class {klass}')
        self._class_hists[klass] = hist
      return hist

  # -- forwarding --------------------------------------------------------

  def _forward_once(self, replica: registry_lib.Replica, path: str,
                    body: bytes, headers: Dict[str, str]
                    ) -> Tuple[int, bytes, str]:
    """One POST to one replica, with the ack boundary made explicit:
    failures while sending raise _SendPhaseError (safe to retry
    elsewhere); failures after the send completed raise
    ReplicaLostError (the replica may have accepted the request)."""
    host, port = replica.host_port
    conn = http.client.HTTPConnection(
        host, port, timeout=self.options.upstream_timeout_s)
    try:
      try:
        conn.request('POST', path, body=body, headers=headers)
      except (OSError, http.client.HTTPException) as e:
        # dclint: allow=typed-faults (internal retry control flow: the
        # caller converts it to a retry or a typed FleetRejection; it
        # never crosses the wire)
        raise _SendPhaseError(
            f'{replica.url}: send failed: {type(e).__name__}: {e}'
        ) from e
      try:
        resp = conn.getresponse()
        data = resp.read()
        ctype = resp.getheader('Content-Type', '') or ''
      except (OSError, http.client.HTTPException) as e:
        raise shared_faults.ReplicaLostError(
            f'replica {replica.url} died after accepting the request '
            f'({type(e).__name__}: {e}); not retried — an accepted '
            'request is never duplicated') from e
      return resp.status, data, ctype
    finally:
      conn.close()

  def _forward_with_retry(self, tier: str, path: str, body: bytes,
                          headers: Dict[str, str],
                          klass: Optional[str] = None,
                          client: Optional[str] = None
                          ) -> Tuple[int, bytes, str]:
    """Places the request on the least-loaded replica of `tier`,
    moving to a different replica only when the previous one provably
    never accepted it (send-phase failure or explicit rejection)."""
    tried: set = set()
    last_reject: Optional[_UpstreamRejected] = None
    t0 = time.monotonic()
    for attempt in range(self.options.max_attempts):
      try:
        replica = self.balancer.acquire(tier, exclude=tried,
                                        klass=klass, client=client)
      except shared_faults.QuotaExceededError:
        self.bump('n_quota_rejected')
        raise
      except shared_faults.FleetRejection:
        if last_reject is not None:
          # Every other replica is excluded/saturated; relay the
          # clearest signal we have — the replica's own rejection.
          self.bump('n_upstream_rejects_relayed')
          raise shared_faults.FleetRejection(
              f'{tier} tier: {last_reject.body[:300].decode("latin-1")}')
        self.bump('n_rejected_saturated')
        raise
      tried.add(replica.url)
      if attempt > 0:
        self.bump('n_retries')
      try:
        status, data, ctype = self._forward_once(
            replica, path, body, headers)
      except _SendPhaseError as e:
        log.warning('%s never acked (%s); retrying elsewhere',
                    replica.url, e)
        self.balancer.release(replica.url, 'send_failure',
                              klass=klass, client=client)
        self.registry.mark_unreachable(replica.url)
        continue
      except shared_faults.ReplicaLostError:
        self.balancer.release(replica.url, 'lost',
                              klass=klass, client=client)
        self.registry.mark_unreachable(replica.url)
        self.bump('n_replica_lost')
        raise
      if status in _RETRYABLE_UPSTREAM:
        draining = b'UNAVAILABLE' in data or b'draining' in data
        self.balancer.release(replica.url, 'reject',
                              klass=klass, client=client)
        if draining:
          self.registry.mark_draining(replica.url)
        last_reject = _UpstreamRejected(status, data, draining)
        continue
      self.balancer.release(replica.url, 'ok', klass=klass, client=client)
      self._tier_hists[tier].observe(time.monotonic() - t0)
      return status, data, ctype
    if last_reject is not None:
      self.bump('n_upstream_rejects_relayed')
      raise shared_faults.FleetRejection(
          f'{tier} tier rejected the request on all '
          f'{self.options.max_attempts} attempts: '
          f'{last_reject.body[:300].decode("latin-1")}')
    raise shared_faults.FleetRejection(
        f'no {tier} replica reachable after '
        f'{self.options.max_attempts} attempts')

  # -- request entry -----------------------------------------------------

  def route(self, body: bytes,
            deadline_header: Optional[str] = None,
            trace_id: Optional[str] = None,
            klass: Optional[str] = None,
            client: Optional[str] = None) -> Tuple[int, bytes, str]:
    """Routes one /v1/polish body; returns (status, body, ctype) to
    relay verbatim. Raises ServeRejection subtypes for router-level
    rejections (mapped to typed JSON by the HTTP layer).

    The router is the fleet's outermost tier, so it mints the trace id
    (unless the client sent one) and stamps it into the forwarded
    headers — every downstream span joins this request's trace.

    `klass`/`client` are the multi-tenant QoS attribution (protocol
    CLASS_HEADER / CLIENT_HEADER): the class buys its weighted-fair
    share of fleet capacity and its own latency histogram; the client
    id is what per-client quotas are charged against."""
    if self._draining:
      raise shared_faults.DrainingError('router is draining')
    self.bump('n_requests')
    klass = klass or self.options.default_class
    if not _CLASS_RE.match(klass):
      self.bump('n_bad_requests')
      raise shared_faults.BadRequestError(
          f'bad {protocol.CLASS_HEADER} value {klass!r}: '
          'want [a-z0-9_-]{1,32}')
    trace_id = trace_id or obs_lib.trace.mint_trace_id()
    t_route = time.time()
    t_mono = time.monotonic()
    frame = ''
    with self._lock:
      self._in_flight += 1
    try:
      frame = protocol.sniff_frame(body)
      headers = {'Content-Type': protocol.CONTENT_TYPE,
                 protocol.TRACE_HEADER: trace_id,
                 protocol.CLASS_HEADER: klass}
      if client:
        headers[protocol.CLIENT_HEADER] = client
      if deadline_header:
        headers[protocol.DEADLINE_HEADER] = deadline_header
      if frame == protocol.FRAME_BAM:
        self.bump('n_routed_featurize')
        status, pack, ctype = self._forward_with_retry(
            registry_lib.FEATURIZE_TIER, '/v1/featurize', body, headers,
            klass=klass, client=client)
        if status != 200:
          return status, pack, ctype  # worker's typed error, relayed
        body = pack
      self.bump('n_routed_model')
      status, data, ctype = self._forward_with_retry(
          registry_lib.MODEL_TIER, '/v1/polish', body, headers,
          klass=klass, client=client)
      if status == 200:
        self._class_hist(klass).observe(time.monotonic() - t_mono)
      return status, data, ctype
    except shared_faults.BadRequestError:
      self.bump('n_bad_requests')
      raise
    except shared_faults.FleetRejection:
      # Class-aware shed accounting (QuotaExceededError included):
      # which class absorbed the rejection is the starvation signal.
      self.bump(f'n_shed_{klass}')
      raise
    finally:
      with self._lock:
        self._in_flight -= 1
      obs_lib.trace.complete_event(
          'route', 'request', t_route, time.time(),
          {'trace_id': trace_id, 'frame': frame, 'class': klass})

  # -- lifecycle / views -------------------------------------------------

  def begin_drain(self) -> None:
    self._draining = True

  def drain(self, timeout: float = 60.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
      with self._lock:
        if self._in_flight == 0:
          return True
      time.sleep(0.05)
    return False

  @property
  def ready(self) -> bool:
    if self._draining:
      return False
    return any(
        r.state == registry_lib.ReplicaState.READY
        and r.tier == registry_lib.MODEL_TIER
        for r in self.registry.snapshot())

  def readyz(self) -> Dict[str, Any]:
    return {
        'ready': self.ready,
        'draining': self._draining,
        'tiers': self.registry.tier_states(),
    }

  def _latency_percentiles(self) -> Dict[str, Dict[str, Any]]:
    # Nearest-rank on the per-tier histograms (same fix as the serve
    # replica's latency_percentiles).
    return {tier: h.percentiles() for tier, h in self._tier_hists.items()}

  def prom_text(self) -> str:
    """/metricz?format=prom payload."""
    return (self.obs.to_prom('router')
            + obs_lib.metrics.prom_counters_text(
                self.registry.aggregate_counters(), tier='fleet'))

  def stats(self) -> Dict[str, Any]:
    counters = self.obs.counter_values()
    registry_view = self.obs.snapshot()
    with self._lock:
      in_flight = self._in_flight
    replicas = []
    for r in self.registry.snapshot():
      replicas.append({
          'url': r.url,
          'tier': r.tier,
          'state': r.state,
          'mesh_dp': r.mesh_dp,
          'degraded': r.degraded,
          'queue_depth': r.queue_depth,
          'transfer_overlap_fraction': r.overlap_fraction,
          'in_flight': r.in_flight,
          'n_routed': r.n_routed,
          'n_ok': r.n_ok,
          'n_upstream_rejects': r.n_upstream_rejects,
          'n_send_failures': r.n_send_failures,
          'n_lost': r.n_lost,
      })
    with self._lock:
      class_hists = dict(self._class_hists)
    return {
        # The cross-tier schema (serve/service.py's stats()).
        'tier': 'router',
        'outstanding': in_flight,
        'draining': self._draining,
        'ready': self.ready,
        'counters': counters,
        'histograms': registry_view['histograms'],
        'latency': self._latency_percentiles(),
        'class_latency': {
            klass: h.percentiles()
            for klass, h in sorted(class_hists.items())
        },
        'qos': self.balancer.qos_snapshot(),
        'replicas': replicas,
        'fleet_counters': self.registry.aggregate_counters(),
    }


def _make_handler(core: RouterCore):
  opts = core.options

  class Handler(BaseHTTPRequestHandler):
    server_version = 'dctpu-route/1'
    protocol_version = 'HTTP/1.1'

    def setup(self):
      super().setup()
      self.connection.settimeout(opts.io_timeout_s)
      self._raw_in = _DeadlineSocketIO(self.connection, opts.io_timeout_s)
      self.rfile = io.BufferedReader(self._raw_in)

    def handle_one_request(self):
      self._raw_in.reset_deadline()
      super().handle_one_request()

    def log_message(self, fmt, *args):
      log.debug('%s %s', self.address_string(), fmt % args)

    def _reply(self, status: int, body: bytes,
               content_type: str = 'application/json') -> None:
      try:
        self.send_response(status)
        self.send_header('Content-Type', content_type)
        self.send_header('Content-Length', str(len(body)))
        self.end_headers()
        self.wfile.write(body)
      except (BrokenPipeError, ConnectionResetError, socket.timeout,
              TimeoutError):
        self.close_connection = True

    def _reply_json(self, status: int, obj: Dict[str, Any]) -> None:
      self._reply(status, json.dumps(obj).encode())

    def _reply_error(self, e: shared_faults.ServeRejection) -> None:
      self._reply_json(
          e.http_status,
          {'error': str(e), 'kind': e.kind, 'status': e.http_status})

    def do_GET(self):
      path, _, query = self.path.partition('?')
      params_qs = urllib.parse.parse_qs(query)
      if path == '/healthz':
        self._reply_json(200, {'ok': True})
      elif path == '/readyz':
        info = core.readyz()
        self._reply_json(200 if info['ready'] else 503, info)
      elif path == '/metricz':
        if params_qs.get('format', [''])[0] == 'prom':
          self._reply(200, core.prom_text().encode(),
                      content_type='text/plain; version=0.0.4')
        else:
          self._reply_json(200, core.stats())
      else:
        self._reply_json(404, {'error': f'no such path: {self.path}'})

    def _read_body(self) -> Optional[bytes]:
      try:
        length = int(self.headers.get('Content-Length', ''))
      except ValueError:
        self._reply_json(411, {'error': 'Content-Length required'})
        return None
      if length > opts.max_body_bytes:
        self.close_connection = True
        self._reply_error(shared_faults.RequestTooLargeError(
            f'body of {length} bytes exceeds '
            f'max_body_bytes={opts.max_body_bytes}'))
        return None
      try:
        body = self.rfile.read(length)
      except (socket.timeout, TimeoutError, ConnectionResetError):
        self.close_connection = True
        return None
      if len(body) < length:
        self.close_connection = True
        return None
      return body

    def do_POST(self):
      if self.path == '/v1/polish':
        body = self._read_body()
        if body is None:
          return
        try:
          status, data, ctype = core.route(
              body,
              deadline_header=self.headers.get(protocol.DEADLINE_HEADER),
              trace_id=self.headers.get(protocol.TRACE_HEADER) or None,
              klass=self.headers.get(protocol.CLASS_HEADER) or None,
              client=self.headers.get(protocol.CLIENT_HEADER)
              or self.address_string())
        except shared_faults.ServeRejection as e:
          self._reply_error(e)
          return
        self._reply(status, data,
                    content_type=ctype or protocol.CONTENT_TYPE)
      elif self.path == '/v1/register':
        body = self._read_body()
        if body is None:
          return
        try:
          spec = json.loads(body)
          url = spec['url']
          tier = spec.get('tier', registry_lib.MODEL_TIER)
          replica = core.registry.add(url, tier=tier)
        except (ValueError, KeyError, TypeError) as e:
          self._reply_error(shared_faults.BadRequestError(
              f'register expects JSON {{"url", "tier"}}: {e}'))
          return
        core.bump('n_registered')
        self._reply_json(200, {
            'registered': replica.url,
            'tier': replica.tier,
            'state': replica.state,
        })
      else:
        self._reply_json(404, {'error': f'no such path: {self.path}'})

  return Handler


class RouteHTTPServer(ThreadingHTTPServer):
  daemon_threads = True
  allow_reuse_address = True


def build_router(core: RouterCore, host: str, port: int) -> RouteHTTPServer:
  return RouteHTTPServer((host, port), _make_handler(core))


def route_main(replicas: List[str], featurize_workers: List[str],
               options: Optional[RouterOptions] = None,
               host: str = '127.0.0.1', port: int = 0,
               ready_fn=None, stop_event=None) -> Dict[str, Any]:
  """Runs the router until SIGTERM/SIGINT, then drains in-flight
  forwards. Returns the final stats dict (CLI exits 0 on clean
  drain). Mirrors serve_main's contract: ready_fn(info) fires once
  listening; stop_event is the in-process SIGTERM stand-in."""
  options = options or RouterOptions()
  obs_lib.trace.configure_from_env(tier='router')
  registry = registry_lib.ReplicaRegistry(
      probe_interval_s=options.probe_interval_s,
      probe_timeout_s=options.probe_timeout_s)
  for url in replicas:
    registry.add(url, tier=registry_lib.MODEL_TIER)
  for url in featurize_workers:
    registry.add(url, tier=registry_lib.FEATURIZE_TIER)
  core = RouterCore(registry, options)
  registry.probe_all()  # first health gate before we announce ready
  registry.start()
  httpd = build_router(core, host, port)
  bound_port = httpd.server_address[1]
  http_thread = threading.Thread(
      target=httpd.serve_forever, name='dctpu-route-http', daemon=True)
  http_thread.start()
  stop = _StopFlag()
  stop.install()
  info = {
      'event': 'ready',
      'host': host,
      'port': bound_port,
      'replicas': registry.urls(),
  }
  log.info('dctpu route ready on %s:%d fronting %d url(s)',
           host, bound_port, len(registry.urls()))
  if ready_fn is not None:
    ready_fn(info)
  try:
    while not stop.event.wait(timeout=0.5):
      if stop_event is not None and stop_event.is_set():
        break
    if stop.signum is not None:
      log.warning('signal %d: draining router', stop.signum)
    core.begin_drain()
    drained = core.drain(timeout=options.upstream_timeout_s + 10)
    if not drained:
      log.error('router drain timed out with forwards in flight')
  finally:
    stop.restore()
    registry.stop()
    httpd.shutdown()
    httpd.server_close()
  stats = core.stats()
  stats['drained'] = bool(drained)
  return stats
