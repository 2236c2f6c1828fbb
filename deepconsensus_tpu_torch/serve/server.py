"""HTTP front end for ConsensusService + serve_main (SIGTERM drain).

Port of deepconsensus_tpu/serve/server.py: the same endpoints, status
codes, JSON bodies and drain, with /debugz/profile on torch.profiler
(obs/profiler.py).

stdlib-only: ThreadingHTTPServer with daemon handler threads. Each
connection gets a socket timeout (ServeOptions.io_timeout_s), so a
slow-drip ("slowloris") or half-dead client costs one handler thread
for at most that long and never touches the model loop.

Endpoints:
  POST /v1/polish   one molecule's windows (protocol.py npz) -> npz
  GET  /healthz     200 while the model loop is alive (also during
                    drain), 503 after a loop crash
  GET  /readyz      200 only when warmed AND admitting; 503 while
                    draining -> load balancers stop routing here first
  GET  /metricz     JSON: faults counters (n_requests,
                    n_rejected_backpressure, n_deadline_cancelled,
                    n_quarantined_by_request, quarantine counters),
                    latency p50/p99, engine pack stats; ?format=prom
                    for Prometheus text
  GET  /debugz/profile?seconds=N[&out=DIR]  one torch.profiler capture

Shutdown follows the training preemption guard (models/train.py): the
SIGTERM/SIGINT handler only sets a flag; the main thread performs the
drain — stop admitting (503 on new polish),
let the model loop finish every admitted request, then stop the
listener and exit 0.
"""
from __future__ import annotations

import io
import json
import logging
import os
import signal
import socket
import tempfile
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from deepconsensus_tpu_torch import faults as shared_faults
from deepconsensus_tpu_torch import obs as obs_lib
from deepconsensus_tpu_torch.obs import profiler as profiler_lib
from deepconsensus_tpu_torch.serve import protocol

# ConsensusService/ServeOptions are imported inside serve_main: the
# service pulls in torch through the engine, and the fleet's CPU tiers
# (`route`, `featurize-worker`) reuse this module's socket plumbing
# without paying for it. Annotations stay as strings (PEP 563).

log = logging.getLogger(__name__)


class _DeadlineSocketIO(io.RawIOBase):
  """Raw socket reader enforcing an ABSOLUTE per-request deadline.

  A per-recv socket timeout alone does not stop a slowloris: a client
  dripping one byte per interval satisfies every individual recv while
  holding the handler thread forever. Each request (headers + body)
  must complete within io_timeout_s of its first byte; past the
  deadline the next read raises socket.timeout, which the http.server
  machinery turns into a closed connection.
  """

  def __init__(self, sock: socket.socket, io_timeout_s: float):
    super().__init__()
    self._sock = sock
    self._io_timeout_s = io_timeout_s
    self.deadline = time.monotonic() + io_timeout_s

  def reset_deadline(self) -> None:
    self.deadline = time.monotonic() + self._io_timeout_s

  def readable(self) -> bool:
    return True

  def readinto(self, b) -> int:
    remaining = self.deadline - time.monotonic()
    if remaining <= 0:
      # dclint: allow=typed-faults (socket.timeout is what
      # http.server's rfile machinery expects from a slow read; a
      # faults.py type would bypass its 408 handling)
      raise socket.timeout(
          f'request not fully read within io_timeout_s='
          f'{self._io_timeout_s}')
    self._sock.settimeout(min(self._io_timeout_s, remaining))
    return self._sock.recv_into(b)


def _make_handler(service: ConsensusService):
  opts = service.serve_options
  params = service.engine.params

  class Handler(BaseHTTPRequestHandler):
    server_version = 'dctpu-serve/1'
    protocol_version = 'HTTP/1.1'

    def setup(self):
      super().setup()
      # The request-scoped watchdog's socket half: a client that stops
      # sending (or reading) trips this timeout and only its own
      # handler thread dies. The deadline reader additionally bounds
      # the WHOLE request read, so drip-feeding can't evade it.
      self.connection.settimeout(opts.io_timeout_s)
      self._raw_in = _DeadlineSocketIO(self.connection, opts.io_timeout_s)
      self.rfile = io.BufferedReader(self._raw_in)

    def handle_one_request(self):
      self._raw_in.reset_deadline()  # keep-alive: per request, not conn
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
        # Client gone or stalled on read; its result is simply dropped.
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
        if service.healthy:
          self._reply_json(200, {'ok': True})
        else:
          self._reply_json(503, {'ok': False, 'error': 'model loop died'})
      elif path == '/readyz':
        # Degraded capacity (mesh stepped down a dp level) stays ready
        # — the service still answers, just slower — but the body says
        # so, so orchestrators can rebalance replicas.
        capacity = service.capacity()
        if service.ready:
          self._reply_json(200, dict({'ready': True}, **capacity))
        else:
          self._reply_json(
              503, dict({'ready': False, 'draining': service._draining},
                        **capacity))
      elif path == '/metricz':
        if params_qs.get('format', [''])[0] == 'prom':
          self._reply(200, service.prom_text().encode(),
                      content_type='text/plain; version=0.0.4')
        else:
          self._reply_json(200, service.stats())
      elif path == '/debugz/profile':
        # On-demand torch.profiler capture: blocks this handler thread
        # for the capture window, never the model loop.
        try:
          seconds = float(params_qs.get('seconds', ['5'])[0])
        except ValueError as e:
          self._reply_error(
              shared_faults.BadRequestError(f'bad seconds param: {e}'))
          return
        out_dir = (params_qs.get('out', [''])[0]
                   or os.path.join(tempfile.gettempdir(),
                                   f'dctpu-profile-{os.getpid()}'))
        result = profiler_lib.capture_profile(out_dir, seconds)
        self._reply_json(200 if result['ok'] else 503, result)
      else:
        self._reply_json(404, {'error': f'no such path: {self.path}'})

    def do_POST(self):
      if self.path != '/v1/polish':
        self._reply_json(404, {'error': f'no such path: {self.path}'})
        return
      try:
        length = int(self.headers.get('Content-Length', ''))
      except ValueError:
        self._reply_json(411, {'error': 'Content-Length required'})
        return
      if length > opts.max_body_bytes:
        # Rejected before reading: an oversized body never allocates.
        self.close_connection = True
        self._reply_error(shared_faults.RequestTooLargeError(
            f'body of {length} bytes exceeds '
            f'max_body_bytes={opts.max_body_bytes}'))
        return
      try:
        body = self.rfile.read(length)
      except (socket.timeout, TimeoutError, ConnectionResetError):
        self.close_connection = True
        return  # slowloris / mid-request disconnect: drop silently
      if len(body) < length:
        self.close_connection = True
        return  # client disconnected mid-body
      try:
        deadline_s: Optional[float] = None
        header = self.headers.get(protocol.DEADLINE_HEADER)
        if header:
          deadline_s = float(header)
        trace_id = self.headers.get(protocol.TRACE_HEADER) or None
        req = protocol.decode_request(
            body,
            total_rows=params.total_rows,
            max_length=params.max_length,
            max_windows=opts.max_windows_per_request,
            window_buckets=service.engine.window_buckets)
        state = service.submit(req, deadline_s,
                               client=self.address_string(),
                               trace_id=trace_id)
        result = service.wait(state)
      except ValueError as e:
        self._reply_error(
            shared_faults.BadRequestError(f'bad deadline header: {e}'))
        return
      except shared_faults.ServeRejection as e:
        self._reply_error(e)
        return
      self._reply(
          200,
          protocol.encode_response(
              status=result['status'],
              seq=result.get('seq', b''),
              quals=result.get('quals'),
              counters=result.get('counters'),
              error=result.get('error', ''),
          ),
          content_type=protocol.CONTENT_TYPE)

  return Handler


class ServeHTTPServer(ThreadingHTTPServer):
  """ThreadingHTTPServer that counts its live handler threads, so the
  drain can wait for the last replies to be written (wait_handlers):
  handler threads are daemons, and a process that exits while one
  writes would cut an admitted request's answer."""

  daemon_threads = True
  allow_reuse_address = True

  def __init__(self, *args, **kwargs):
    self._handlers = 0  # guarded by: self._handlers_done
    self._handlers_done = threading.Condition()
    super().__init__(*args, **kwargs)

  def process_request(self, request, client_address):
    with self._handlers_done:
      self._handlers += 1
    try:
      super().process_request(request, client_address)
    except BaseException:
      self._handler_finished()
      raise

  def process_request_thread(self, request, client_address):
    try:
      super().process_request_thread(request, client_address)
    finally:
      self._handler_finished()

  def _handler_finished(self) -> None:
    with self._handlers_done:
      self._handlers -= 1
      self._handlers_done.notify_all()

  def wait_handlers(self, timeout: float) -> bool:
    """True once every handler thread has returned (their connections
    close by themselves within io_timeout_s), False at the timeout."""
    with self._handlers_done:
      return self._handlers_done.wait_for(lambda: self._handlers == 0,
                                          timeout)


def build_server(service: ConsensusService, host: str,
                 port: int) -> ServeHTTPServer:
  return ServeHTTPServer((host, port), _make_handler(service))


class _PreemptionWatch:
  """Preemption notice: an early warning that this replica is about to
  be killed (cloud preemption, spot reclaim, scale-in). Two delivery
  paths set the same flag:

    * SIGUSR1 — the external notice (a node agent relaying the
      provider's preemption warning).
    * DCTPU_FAULT_PREEMPT_AT_S — the env fault hook: a daemon timer
      self-delivers the notice N seconds after serve start, so tests
      and soaks exercise the path without process signals.

  Like _StopFlag, the handler only sets a flag; serve_main's main
  thread sees it and runs the normal drain — /readyz flips to 503
  draining (the router stops routing here), admitted work finishes,
  and the process exits 0 well before the provider's hard kill."""

  def __init__(self):
    self.noticed = threading.Event()
    self._saved = None
    self._timer: Optional[threading.Timer] = None

  def install(self):
    try:
      self._saved = signal.signal(signal.SIGUSR1, self._handle)
    except ValueError:
      # Not the main thread (in-process tests): the env timer below
      # still works, and tests can call notice() directly.
      pass
    at_s = shared_faults.preempt_notice_after_s()
    if at_s > 0:
      self._timer = threading.Timer(at_s, self.notice)
      self._timer.daemon = True
      self._timer.start()

  def notice(self) -> None:
    log.warning('preemption notice: draining ahead of the kill')
    self.noticed.set()

  def restore(self):
    if self._timer is not None:
      self._timer.cancel()
    if self._saved is not None:
      signal.signal(signal.SIGUSR1, self._saved)

  def _handle(self, signum, frame):
    del signum, frame
    self.notice()


class _StopFlag:
  """PreemptionGuard-style: the signal handler only sets a flag (and
  remembers which signal); the main thread owns the drain."""

  def __init__(self):
    self.event = threading.Event()
    self.signum: Optional[int] = None
    self._saved = {}

  def install(self):
    for sig in (signal.SIGTERM, signal.SIGINT):
      try:
        self._saved[sig] = signal.signal(sig, self._handle)
      except ValueError:
        # Not the main thread (in-process tests): run without signal
        # handling; the caller stops us via request_stop().
        break

  def request_stop(self, signum: int = signal.SIGTERM) -> None:
    self._handle(signum, None)

  def restore(self):
    for sig, handler in self._saved.items():
      signal.signal(sig, handler)

  def _handle(self, signum, frame):
    del frame
    self.signum = signum
    self.event.set()


def serve_main(runner, options, serve_options: ServeOptions,
               host: str = '127.0.0.1', port: int = 0,
               ready_fn=None, stop_event=None) -> Dict[str, Any]:
  """Runs the service until SIGTERM/SIGINT, then drains. Returns the
  final stats dict (the CLI exits 0 on a clean drain).

  ready_fn(info) is called once the endpoint is warm and listening —
  the CLI prints the info line to stdout; tests use it to learn the
  bound port. stop_event (threading.Event) is the in-process stand-in
  for SIGTERM when serve_main runs off the main thread.
  """
  from deepconsensus_tpu_torch.serve.service import ConsensusService

  # Fleet tracing: every tier appends to the shared trace file named
  # by DCTPU_TRACE (no-op when unset).
  obs_lib.trace.configure_from_env(tier='serve')
  service = ConsensusService(runner, options, serve_options)
  warm_s = service.warmup()
  service.start()
  httpd = build_server(service, host, port)
  bound_port = httpd.server_address[1]
  http_thread = threading.Thread(
      target=httpd.serve_forever, name='dctpu-serve-http', daemon=True)
  http_thread.start()
  stop = _StopFlag()
  stop.install()
  preempt = _PreemptionWatch()
  preempt.install()
  info = {
      'event': 'ready',
      'host': host,
      'port': bound_port,
      'warmup_s': round(warm_s, 3),
  }
  log.info('dctpu serve ready on %s:%d (warmup %.3fs)',
           host, bound_port, warm_s)
  if ready_fn is not None:
    ready_fn(info)
  try:
    while not stop.event.wait(timeout=0.5):
      if stop_event is not None and stop_event.is_set():
        break
      if preempt.noticed.is_set():
        break
      if not service.healthy:
        log.error('model loop died; shutting down')
        break
    if stop.signum is not None:
      log.warning('signal %d: draining (no new admissions)', stop.signum)
    # Drain while the listener stays up: in-flight handler threads can
    # still deliver their responses; new polish requests get 503. A
    # preemption notice takes the same path — the only difference is
    # who asked (provider warning vs operator SIGTERM).
    service.begin_drain()
    drained = service.drain(timeout=serve_options.max_deadline_s + 30)
    if not drained:
      log.error('drain timed out with work outstanding')
  finally:
    stop.restore()
    preempt.restore()
    httpd.shutdown()
    httpd.server_close()
    # Let the handler threads write their last replies: the process may
    # exit as soon as this returns.
    if not httpd.wait_handlers(serve_options.io_timeout_s + 1):
      log.error('handler threads still running after the drain')
  stats = service.stats()
  stats['drained'] = bool(drained)
  stats['preempted'] = preempt.noticed.is_set()
  return stats
