"""`featurize-worker`: the CPU tier of the disaggregated fleet.

Port of deepconsensus_tpu/fleet/featurize_worker.py over the port's
feeder and pileup. It runs on the CPU and never touches the card: it
imports neither torch nor the model.

Accepts bam/1 frames (one molecule's subreads-to-CCS mini BAM plus
its draft-CCS mini BAM, as raw file bytes) on POST /v1/featurize and
answers with the same molecule featurized: a compact features/1 uint8
pack when the window tensor is losslessly packable, else the legacy
float32 request frame. Either answer is a valid /v1/polish body, so
the router forwards it to a model replica untouched.

Decode and pileup run through the machinery the batch pipeline uses
(io.bam's bounded readers via preprocess.feeder.create_proc_feeder,
then reads_to_pileup / iter_window_features), so the features this
tier ships are byte-identical to what a batch `run` or a client-side
featurize produces; the model replica's ingest is unchanged. This role
runs on plain CPU hosts and scales horizontally.

Same HTTP conventions as serve/server.py: ThreadingHTTPServer,
absolute read deadlines, typed JSON errors, SIGTERM drain with
/readyz flipping to draining first.
"""
from __future__ import annotations

import dataclasses
import io
import json
import logging
import os
import shutil
import socket
import tempfile
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from deepconsensus_tpu_torch import faults as shared_faults
from deepconsensus_tpu_torch import obs as obs_lib
from deepconsensus_tpu_torch.models import config as config_lib
from deepconsensus_tpu_torch.preprocess.feeder import (create_proc_feeder,
                                                      reads_to_pileup)
from deepconsensus_tpu_torch.preprocess.pileup import FeatureLayout
from deepconsensus_tpu_torch.serve import protocol
from deepconsensus_tpu_torch.serve.server import _DeadlineSocketIO, _StopFlag

log = logging.getLogger(__name__)


@dataclasses.dataclass
class FeaturizeWorkerOptions:
  max_passes: int = 20
  max_length: int = config_lib.DEFAULT_MAX_LENGTH
  use_ccs_bq: bool = False
  window_buckets: Tuple[int, ...] = ()
  ins_trim: int = 0
  use_ccs_smart_windows: bool = False
  work_dir: Optional[str] = None     # scratch for per-request mini BAMs
  compact: bool = True               # prefer features/1 uint8 packs
  max_body_bytes: int = 64 << 20
  io_timeout_s: float = 20.0


class FeaturizeService:
  """bam/1 bytes -> features body. Handler threads call featurize()
  concurrently; the shared counters sit under one lock."""

  def __init__(self, options: FeaturizeWorkerOptions):
    self.options = options
    self.layout = FeatureLayout(
        options.max_passes, options.max_length, options.use_ccs_bq,
        window_buckets=options.window_buckets or None)
    self._lock = threading.Lock()
    # Central metrics registry (obs/metrics.py): counters pre-created
    # so /metricz always exposes the full set; the request-latency
    # histogram replaces the deque percentile math.
    self.obs = obs_lib.MetricsRegistry(tier='featurize')
    for key in ('n_requests', 'n_featurized', 'n_windows',
                'n_packed_compact', 'n_packed_float', 'n_bad_requests'):
      self.obs.counter(key)
    self._latency_hist = self.obs.histogram(
        'featurize_request_latency_s',
        help='bam/1 decode + featurize latency per request')
    self._in_flight = 0  # guarded by: self._lock
    self._draining = False  # dclint: lock-free (monotonic bool flip;
    # an admission racing the flip finishes normally before drain())

  def bump(self, key: str, n: int = 1) -> None:
    self.obs.inc(key, n)

  def featurize(self, body: bytes,
                trace_id: Optional[str] = None) -> bytes:
    """One bam/1 request -> one /v1/polish-ready body. Raises typed
    ServeRejection subtypes on anything malformed."""
    if self._draining:
      raise shared_faults.DrainingError('featurize worker is draining')
    self.bump('n_requests')
    with self._lock:
      self._in_flight += 1
    t0 = time.monotonic()
    t_wall = time.time()
    try:
      req = protocol.decode_bam_request(body)
      features = self._featurize_bam(req)
      pack: Optional[bytes] = None
      if self.options.compact:
        pack = protocol.features_pack_from_features(features)
      if pack is not None:
        self.bump('n_packed_compact')
      else:
        pack = protocol.request_from_features(features)
        self.bump('n_packed_float')
      self.bump('n_featurized')
      self.bump('n_windows', len(features))
      self._latency_hist.observe(time.monotonic() - t0)
      return pack
    except shared_faults.ServeRejection:
      self.bump('n_bad_requests')
      raise
    finally:
      with self._lock:
        self._in_flight -= 1
      # The worker's leg of the cross-tier trace: the featurize stage
      # span carries the router-minted trace id.
      obs_lib.record_stage(self.obs, obs_lib.trace.STAGE_FEATURIZE,
                           t_wall, time.time(), trace_id=trace_id)

  def _featurize_bam(self, req: Dict[str, Any]):
    """Runs the hardened feeder over the request's mini BAMs. The
    bytes land in per-request temp files because the BAM readers are
    file-based; they live under work_dir (tmpfs in production) for
    the few ms of the decode."""
    tmpdir = tempfile.mkdtemp(prefix='dctpu_featurize_',
                              dir=self.options.work_dir)
    try:
      subreads_path = os.path.join(tmpdir, 'subreads_to_ccs.bam')
      ccs_path = os.path.join(tmpdir, 'ccs.bam')
      with open(subreads_path, 'wb') as f:
        f.write(req['subreads_bam'])
      with open(ccs_path, 'wb') as f:
        f.write(req['ccs_bam'])
      try:
        feeder, _counter = create_proc_feeder(
            subreads_to_ccs=subreads_path,
            ccs_bam=ccs_path,
            layout=self.layout,
            ins_trim=self.options.ins_trim,
            use_ccs_smart_windows=self.options.use_ccs_smart_windows,
        )
        molecules = []
        for zmw_input in feeder():
          subreads, name, layout, _split, window_widths = zmw_input
          pileup = reads_to_pileup(subreads, name, layout, window_widths)
          molecules.append(list(pileup.iter_window_features()))
          if len(molecules) > 1:
            break
      except shared_faults.ServeRejection:
        raise
      except Exception as e:
        # Corrupt/truncated BAM bytes, unpaired records, expansion
        # failures: all client-data problems at this boundary.
        raise shared_faults.BadRequestError(
            f'featurize failed for {req["name"] or "<unnamed>"}: '
            f'{type(e).__name__}: {e}') from e
      if not molecules or not molecules[0]:
        raise shared_faults.BadRequestError(
            f'bam/1 payload for {req["name"] or "<unnamed>"} yielded '
            'no featurizable molecule')
      if len(molecules) > 1:
        raise shared_faults.BadRequestError(
            'bam/1 carries more than one molecule; send one request '
            'per ZMW (the /v1/polish contract)')
      return molecules[0]
    finally:
      shutil.rmtree(tmpdir, ignore_errors=True)

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
    return not self._draining

  def prom_text(self) -> str:
    """/metricz?format=prom payload."""
    return self.obs.to_prom('featurize')

  def stats(self) -> Dict[str, Any]:
    counters = self.obs.counter_values()
    registry_view = self.obs.snapshot()
    with self._lock:
      in_flight = self._in_flight
    return {
        # The cross-tier schema (serve/service.py's stats()).
        'tier': 'featurize',
        'outstanding': in_flight,
        'draining': self._draining,
        'ready': self.ready,
        'counters': counters,
        'histograms': registry_view['histograms'],
        'latency': self._latency_hist.percentiles(),
    }


def _make_handler(service: FeaturizeService):
  opts = service.options

  class Handler(BaseHTTPRequestHandler):
    server_version = 'dctpu-featurize/1'
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
        if service.ready:
          self._reply_json(200, {'ready': True, 'tier': 'featurize'})
        else:
          self._reply_json(503, {'ready': False, 'tier': 'featurize',
                                 'draining': service._draining})
      elif path == '/metricz':
        if params_qs.get('format', [''])[0] == 'prom':
          self._reply(200, service.prom_text().encode(),
                      content_type='text/plain; version=0.0.4')
        else:
          self._reply_json(200, service.stats())
      else:
        self._reply_json(404, {'error': f'no such path: {self.path}'})

    def do_POST(self):
      if self.path != '/v1/featurize':
        self._reply_json(404, {'error': f'no such path: {self.path}'})
        return
      try:
        length = int(self.headers.get('Content-Length', ''))
      except ValueError:
        self._reply_json(411, {'error': 'Content-Length required'})
        return
      if length > opts.max_body_bytes:
        self.close_connection = True
        self._reply_error(shared_faults.RequestTooLargeError(
            f'body of {length} bytes exceeds '
            f'max_body_bytes={opts.max_body_bytes}'))
        return
      try:
        body = self.rfile.read(length)
      except (socket.timeout, TimeoutError, ConnectionResetError):
        self.close_connection = True
        return
      if len(body) < length:
        self.close_connection = True
        return
      try:
        pack = service.featurize(
            body, trace_id=self.headers.get(protocol.TRACE_HEADER) or None)
      except shared_faults.ServeRejection as e:
        self._reply_error(e)
        return
      self._reply(200, pack, content_type=protocol.CONTENT_TYPE)

  return Handler


class FeaturizeHTTPServer(ThreadingHTTPServer):
  daemon_threads = True
  allow_reuse_address = True


def build_worker(service: FeaturizeService, host: str,
                 port: int) -> FeaturizeHTTPServer:
  return FeaturizeHTTPServer((host, port), _make_handler(service))


def worker_main(options: FeaturizeWorkerOptions,
                host: str = '127.0.0.1', port: int = 0,
                ready_fn=None, stop_event=None) -> Dict[str, Any]:
  """Runs the worker until SIGTERM/SIGINT, then drains (same contract
  as serve_main / route_main)."""
  obs_lib.trace.configure_from_env(tier='featurize')
  service = FeaturizeService(options)
  httpd = build_worker(service, host, port)
  bound_port = httpd.server_address[1]
  http_thread = threading.Thread(
      target=httpd.serve_forever, name='dctpu-featurize-http',
      daemon=True)
  http_thread.start()
  stop = _StopFlag()
  stop.install()
  info = {'event': 'ready', 'host': host, 'port': bound_port,
          'tier': 'featurize'}
  log.info('dctpu featurize-worker ready on %s:%d', host, bound_port)
  if ready_fn is not None:
    ready_fn(info)
  try:
    while not stop.event.wait(timeout=0.5):
      if stop_event is not None and stop_event.is_set():
        break
    if stop.signum is not None:
      log.warning('signal %d: draining featurize worker', stop.signum)
    service.begin_drain()
    drained = service.drain(timeout=options.io_timeout_s + 30)
    if not drained:
      log.error('featurize drain timed out with work in flight')
  finally:
    stop.restore()
    httpd.shutdown()
    httpd.server_close()
  stats = service.stats()
  stats['drained'] = bool(drained)
  return stats
