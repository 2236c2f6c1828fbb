"""ConsensusService: continuous batching with per-request isolation.

Port of deepconsensus_tpu/serve/service.py over the port's
ConsensusEngine: the same admission, batching, deadline, isolation and
quarantine rules, the same statuses and counters. Warm-up builds (or
loads) the kernel libraries and runs one pack per bucket on the card,
or one ragged pack, before /readyz flips; there is no compile cache to
warm.

One model-loop thread owns the ConsensusEngine and the card. HTTP
handler threads only decode, submit, and wait on a per-request event —
the model loop never waits on a client, so a hung or disconnected
client can never wedge the device pipeline (the request-scoped
watchdog is this structural property plus the per-request deadline).

Admission control: a request is admitted only while fewer than
max_pending requests are outstanding AND the admission queue has room;
otherwise it is shed with a typed BackpressureError (429). While
draining (SIGTERM), submission raises DrainingError (503) but
everything already admitted still completes — zero accepted-then-lost.

Continuous batching: the loop greedily ingests every queued request,
so windows from many concurrent requests share fixed-shape packs (the
engine cuts full packs as they fill). Only when the queue is empty and
windows are still buffered does it flush — batching under load, low
latency when idle. Pack composition cannot change results: attention
is strictly within-window, so serve output is byte-identical to a solo
batch run.

Fault isolation: when a shared pack fails, each affected request's
windows are retried once in a solo "isolation pack" (after a full
flush, so no innocent bystander rides along). A second failure
quarantines that request via the shared faults taxonomy — dead-letter
line with request attribution (request_id, client, pack seq), policy
skip/ccs-fallback — while every other request in the original pack
proceeds normally.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import os
import queue as queue_lib
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from deepconsensus_tpu_torch import faults as shared_faults
from deepconsensus_tpu_torch import obs as obs_lib
from deepconsensus_tpu_torch.inference import engine as engine_lib
from deepconsensus_tpu_torch.inference import faults
from deepconsensus_tpu_torch.models import data as data_lib
from deepconsensus_tpu_torch.postprocess import stitch
from deepconsensus_tpu_torch.preprocess.pileup import row_indices

log = logging.getLogger(__name__)


@dataclasses.dataclass
class ServeOptions:
  """Admission and robustness knobs (the reference's defaults)."""

  max_pending: int = 64          # outstanding admitted requests
  admit_queue_depth: int = 32    # requests queued ahead of the loop
  max_windows_per_request: int = 512
  max_body_bytes: int = 64 * 1024 * 1024
  default_deadline_s: float = 120.0
  max_deadline_s: float = 600.0
  io_timeout_s: float = 20.0     # per-socket read/write (slowloris cap)
  # Policy for a request whose windows fail the model stage twice
  # (shared pack + isolation retry). 'fail' is deliberately not
  # offered: a resident service degrades per-request, never crashes
  # the loop.
  on_request_error: str = faults.OnZmwError.CCS_FALLBACK
  dead_letter_path: Optional[str] = None

  def __post_init__(self):
    if self.on_request_error not in (faults.OnZmwError.SKIP,
                                     faults.OnZmwError.CCS_FALLBACK):
      # dclint: allow=typed-faults (startup flag validation: cli main
      # maps ValueError to exit code 2 before the service exists)
      raise ValueError(
          "on_request_error must be 'skip' or 'ccs-fallback', got "
          f'{self.on_request_error!r}')


class _Ticket:
  """One model window of one request, as seen by the engine.

  slot indexes the request's pos/ids/quals arrays; row indexes its
  retained formatted model_rows (for isolation retries); the draft CCS
  copy makes ccs-fallback possible after the request tensors are gone.
  """

  __slots__ = ('state', 'slot', 'row', 'ccs_ids', 'ccs_bq')

  def __init__(self, state: '_RequestState', slot: int, row: int,
               ccs_ids: np.ndarray, ccs_bq: np.ndarray):
    self.state = state
    self.slot = slot
    self.row = row
    self.ccs_ids = ccs_ids
    self.ccs_bq = ccs_bq


class _RequestState:
  """One admitted request flowing through the model loop."""

  __slots__ = (
      'request_id', 'name', 'client', 'req', 'deadline', 't_submit',
      't_submit_wall', 'trace_id',
      'pos', 'ids', 'quals', 'tickets', 'model_rows', 'pending',
      'ingested', 'retried', 'adopted', 'cancelled', 'finished',
      'counters', 'result', 'error', 'event')

  def __init__(self, request_id: int, req: Dict[str, Any],
               client: str, deadline: float,
               trace_id: Optional[str] = None):
    self.request_id = request_id
    self.name = req['name']
    self.client = client
    self.req = req
    self.deadline = deadline
    self.t_submit = time.monotonic()
    # Wall-clock twin of t_submit: trace spans live on the shared
    # wall-clock timeline (obs/trace.py), monotonic stays for deadlines.
    self.t_submit_wall = time.time()
    self.trace_id = trace_id or obs_lib.trace.mint_trace_id()
    self.pos: List[int] = []
    self.ids: List[Optional[np.ndarray]] = []
    self.quals: List[Optional[np.ndarray]] = []
    self.tickets: List[_Ticket] = []
    # Per-window formatted [total_rows, L, 1] tensors (indexed by
    # ticket.row); a list, not a stacked array, because one request's
    # windows may span length buckets.
    self.model_rows: Optional[List[np.ndarray]] = None
    self.pending = 0
    self.ingested = False
    self.retried = False
    self.adopted = False      # ccs-fallback applied (or skip-dropped)
    self.cancelled = False
    self.finished = False
    self.counters: collections.Counter = collections.Counter()
    self.result: Optional[Dict[str, Any]] = None
    self.error: Optional[str] = None
    self.event = threading.Event()

  @property
  def expired(self) -> bool:
    return time.monotonic() > self.deadline


class ConsensusService:
  """The resident engine + its model loop; see module docstring."""

  def __init__(self, runner, options, serve_options: ServeOptions):
    self.options = options          # InferenceOptions (model knobs)
    self.serve_options = serve_options
    self._queue: 'queue_lib.Queue[_RequestState]' = queue_lib.Queue(
        maxsize=max(1, serve_options.admit_queue_depth))
    self._lock = threading.Lock()
    self._outstanding: set = set()  # guarded by: self._lock
    # dclint: lock-free (monotonic False->True flag; a stale read only
    # delays drain one loop tick, and the loop re-checks under lock)
    self._draining = False
    self._stopped = threading.Event()
    # dclint: lock-free (written once by warmup before traffic starts)
    self._warm = False
    # dclint: lock-free (single writer: the model loop; handlers read
    # at-worst-stale None and fail the next health check instead)
    self._loop_error: Optional[BaseException] = None
    self._next_id = 0  # guarded by: self._lock
    self._retries: List[Tuple[_RequestState, List[_Ticket], int, str]] = []
    # One metrics registry per replica: shared with the runner (whose
    # stage histograms land in the same /metricz view) when it has one;
    # stub runners in tests get a service-local registry.
    self.metrics: obs_lib.MetricsRegistry = (
        getattr(runner, 'obs', None) or obs_lib.MetricsRegistry())
    self.metrics.tier = self.metrics.tier or 'serve'
    self._latency_hist = self.metrics.histogram(
        'serve_request_latency_s',
        help='end-to-end request latency (submit to result)')
    # dclint: lock-free (mutated only by the model loop via stitch;
    # stats() reads int fields whose torn values are tolerable)
    self.outcome = stitch.OutcomeCounter()
    dead_letter = None
    if serve_options.dead_letter_path:
      dead_letter = shared_faults.DeadLetterWriter(
          serve_options.dead_letter_path, append=True)
    self.quarantine = faults.Quarantine(
        serve_options.on_request_error, dead_letter)
    self.engine = engine_lib.ConsensusEngine(
        runner, options,
        deliver=self._deliver,
        on_pack_failure=self._on_pack_failure)
    self._thread = threading.Thread(
        target=self._model_loop, name='dctpu-serve-model', daemon=True)

  # ------------------------------------------------------------------
  # Lifecycle

  def warmup(self) -> float:
    """Runs one pack of each shape before /readyz flips: the kernel
    libraries load (built at first use into the build directory), the
    pinned buffers and the card's allocator warm up."""
    params = self.engine.params
    t0 = time.monotonic()
    if getattr(self.options, 'use_ragged_kernel', False):
      # One ragged pack shape serves every bucket width.
      packer = self.engine._packer_for(max(self.engine.window_buckets))
      pack = np.zeros(
          (packer.n_slots, params.total_rows, packer.slot_len, 1),
          dtype=np.float32)
      lengths = np.zeros(
          (packer.n_slots, packer.windows_per_slot), dtype=np.int32)
      self.engine.runner.finalize(
          self.engine.runner.dispatch_ragged(pack, lengths))
    else:
      for width in self.engine.window_buckets:
        self.engine.runner.predict(np.zeros(
            (1, params.total_rows, width, 1), dtype=np.float32))
    self._warm = True
    return time.monotonic() - t0

  def start(self) -> None:
    self._thread.start()

  def begin_drain(self) -> None:
    """Stops admission; already-admitted requests keep completing."""
    self._draining = True

  def drain(self, timeout: Optional[float] = None) -> bool:
    """begin_drain + wait for the model loop to finish all admitted
    work and exit. True when fully drained."""
    self.begin_drain()
    self._thread.join(timeout=timeout)
    drained = not self._thread.is_alive()
    if drained and self.quarantine.dead_letter is not None:
      self.quarantine.dead_letter.close()
    return drained

  @property
  def healthy(self) -> bool:
    return self._loop_error is None and (
        self._thread.is_alive() or not self._thread.ident)

  @property
  def ready(self) -> bool:
    return (self._warm and not self._draining and self.healthy
            and self._thread.is_alive())

  # ------------------------------------------------------------------
  # Handler-thread side

  def submit(self, req: Dict[str, Any], deadline_s: Optional[float],
             client: str = '',
             trace_id: Optional[str] = None) -> _RequestState:
    """Admits one decoded request or raises a typed ServeRejection."""
    self.quarantine.bump('n_requests')
    if self._draining or self._stopped.is_set():
      raise shared_faults.DrainingError()
    if not self.healthy:
      raise shared_faults.ServeRejection(
          f'model loop died: {self._loop_error!r}')
    opts = self.serve_options
    deadline_s = min(deadline_s or opts.default_deadline_s,
                     opts.max_deadline_s)
    with self._lock:
      if len(self._outstanding) >= opts.max_pending:
        self.quarantine.bump('n_rejected_backpressure')
        raise shared_faults.BackpressureError(
            f'{len(self._outstanding)} requests outstanding '
            f'(max_pending={opts.max_pending})')
      self._next_id += 1
      state = _RequestState(self._next_id, req, client,
                            time.monotonic() + deadline_s,
                            trace_id=trace_id)
      self._outstanding.add(state)
    try:
      self._queue.put_nowait(state)
    except queue_lib.Full:
      with self._lock:
        self._outstanding.discard(state)
      self.quarantine.bump('n_rejected_backpressure')
      raise shared_faults.BackpressureError(
          f'admission queue full (depth={opts.admit_queue_depth})')
    return state

  def wait(self, state: _RequestState) -> Dict[str, Any]:
    """Blocks the handler thread until the result or the deadline.
    Raises DeadlineExceededError after cancelling the request (queued
    windows are never submitted; in-flight deliveries are dropped)."""
    remaining = state.deadline - time.monotonic()
    if not state.event.wait(timeout=max(0.0, remaining) + 0.25):
      self._cancel(state, 'deadline elapsed while awaiting the model loop')
      raise shared_faults.DeadlineExceededError(
          f'request {state.request_id} ({state.name}) missed its deadline')
    if state.cancelled:
      raise shared_faults.DeadlineExceededError(
          f'request {state.request_id} ({state.name}) cancelled at '
          'deadline')
    assert state.result is not None
    return state.result

  def _cancel(self, state: _RequestState, reason: str) -> None:
    with self._lock:
      if state.finished or state.cancelled:
        return
      state.cancelled = True
    self.quarantine.bump('n_deadline_cancelled')
    log.warning('request %d (%s): cancelled: %s',
                state.request_id, state.name, reason)
    # Un-ingested states are skipped (and released) when the loop pops
    # them; in-flight ones are released as their deliveries drain.
    if state.ingested and state.pending == 0:
      self._release(state)
    state.event.set()

  # ------------------------------------------------------------------
  # Model-loop side

  def _model_loop(self) -> None:
    while True:
      try:
        try:
          state = self._queue.get(timeout=0.05)
        except queue_lib.Empty:
          if self._retries:
            self._process_retries()
          elif self.engine.has_work:
            # Idle with a buffered tail: don't hold it hostage waiting
            # for traffic that may never come.
            self.engine.flush(drain=True)
          elif self._draining:
            # Exit only once every admitted request has resolved — a
            # submit that won admission just before the drain flag
            # flipped still lands in the queue and must be served
            # (zero accepted-then-lost).
            with self._lock:
              done = not self._outstanding
            if done:
              break
          continue
        self._ingest(state)
        # Continuous batching: everything already queued joins the
        # same packs before we consider flushing a partial tail.
        while True:
          try:
            self._ingest(self._queue.get_nowait())
          except queue_lib.Empty:
            break
        if self._retries:
          self._process_retries()
      except BaseException as e:  # never die silently: fail loudly
        self._loop_error = e
        log.exception('serve model loop died')
        self._fail_all_outstanding(e)
        break
    self._stopped.set()

  def _ingest(self, state: _RequestState) -> None:
    if state.cancelled:
      self._release(state)
      return
    if state.expired:
      self._cancel(state, 'expired in admission queue')
      self._release(state)
      return
    req = state.req
    opts = self.options
    fds = [
        {
            'overflow': bool(req['overflow'][i]),
            'ccs_base_quality_scores': req['ccs_bq'][i],
            'subreads': req['subreads'][i],
            'window_pos': int(req['window_pos'][i]),
        }
        for i in range(len(req['subreads']))
    ]
    to_model, to_skip = engine_lib.triage_windows(
        fds, opts, state.counters)
    for fd in to_skip:
      state.pos.append(fd['window_pos'])
      ids, quals = engine_lib.skipped_window_arrays(fd, opts)
      state.ids.append(ids)
      state.quals.append(quals)
    ccs_row = row_indices(opts.max_passes, opts.use_ccs_bq)[4][0]
    for row, fd in enumerate(to_model):
      slot = len(state.pos)
      state.pos.append(fd['window_pos'])
      state.ids.append(None)
      state.quals.append(None)
      state.tickets.append(_Ticket(
          state, slot, row,
          fd['subreads'][ccs_row, :, 0].astype(np.uint8),
          np.array(fd['ccs_base_quality_scores'])))
    state.pending = len(to_model)
    state.ingested = True
    state.req = None  # the raw request tensors are no longer needed
    if to_model:
      # Formatted once and retained per window: isolation retries
      # re-dispatch the same rows without the raw tensors
      # (~34 KB/window). Formatting batches per width group (a
      # mixed-length request spans buckets); submit hands the whole
      # list to the engine, which regroups per bucket and lets windows
      # from concurrent requests share each bucket's packs.
      groups: Dict[int, Tuple[List[int], List[np.ndarray]]] = {}
      for row, fd in enumerate(to_model):
        rows_idx, raws = groups.setdefault(
            int(fd['subreads'].shape[1]), ([], []))
        rows_idx.append(row)
        raws.append(fd['subreads'])
      formatted: List[Optional[np.ndarray]] = [None] * len(to_model)
      for width in sorted(groups):
        rows_idx, raws = groups[width]
        batch = data_lib.format_rows_batch(
            np.stack(raws), self.engine.params,
            window_buckets=self.engine.window_buckets)
        for row, formatted_row in zip(rows_idx, batch):
          formatted[row] = formatted_row
      state.model_rows = formatted
      poison = os.environ.get(shared_faults.ENV_POISON_WINDOW)
      if poison and poison in state.name:
        self.engine.poison_ticket(state.tickets[0])
      self.engine.submit_formatted(state.model_rows, state.tickets)
    else:
      self._finish(state)

  def _deliver(self, ticket: _Ticket, ids: np.ndarray,
               quals: np.ndarray) -> None:
    state = ticket.state
    if not state.adopted and not state.cancelled:
      state.ids[ticket.slot] = ids
      state.quals[ticket.slot] = quals
    state.pending -= 1
    if state.pending == 0 and state.ingested:
      self._finish(state)

  def _on_pack_failure(self, tickets, pack_seq: int,
                       error: BaseException) -> None:
    """One shared pack failed: route each member request to an
    isolation retry (first failure) or quarantine (second)."""
    text = f'{type(error).__name__}: {error}'
    by_state: Dict[int, Tuple[_RequestState, List[_Ticket]]] = {}
    for t in tickets:
      by_state.setdefault(id(t.state), (t.state, []))[1].append(t)
    for state, ts in by_state.values():
      if state.cancelled or state.adopted:
        state.pending -= len(ts)
        if state.pending == 0 and state.ingested:
          self._finish(state)
      elif not state.retried:
        state.retried = True
        self.quarantine.bump('n_isolation_retries')
        log.warning(
            'pack %d failed (%s); scheduling isolation retry for '
            'request %d (%s, %d window(s))', pack_seq, text,
            state.request_id, state.name, len(ts))
        self._retries.append((state, ts, pack_seq, text))
      else:
        self._quarantine_request(state, ts, pack_seq, text)

  def _process_retries(self) -> None:
    retries, self._retries = self._retries, []
    # Empty the packer (buffered + in flight) so each retry below forms
    # a pure isolation pack: a second failure indicts this request
    # alone. May itself reveal more failures -> self._retries refills
    # and the loop comes back around.
    self.engine.flush(drain=True)
    for state, ts, pack_seq, text in retries:
      if state.cancelled or state.adopted:
        state.pending -= len(ts)
        if state.pending == 0 and state.ingested:
          self._finish(state)
        continue
      poison = os.environ.get(shared_faults.ENV_POISON_WINDOW)
      if poison and poison in state.name:
        # The injected poison rides with the payload, so the isolation
        # pack fails too -> quarantine (matching a genuinely bad
        # window, which fails solo just as it failed shared).
        self.engine.poison_ticket(ts[0])
      self.engine.submit_formatted(
          [state.model_rows[t.row] for t in ts], ts)
      self.engine.flush(drain=True)

  def _quarantine_request(self, state: _RequestState, ts: List[_Ticket],
                          pack_seq: int, text: str) -> None:
    """Second model-stage failure for this request: apply the policy
    (whole-request, like the batch plane's whole-molecule fallback) and
    dead-letter it with request attribution."""
    self.quarantine.bump('n_quarantined_by_request')

    def adopt_all() -> bool:
      for t in state.tickets:
        state.ids[t.slot] = t.ccs_ids
        state.quals[t.slot] = engine_lib.ccs_quals_array(
            t.ccs_bq, self.options)
      return True

    adopted = self.quarantine.handle(
        state.name, 'model', text,
        fallback=adopt_all,
        extra={
            'request_id': state.request_id,
            'client': state.client,
            'trace_id': state.trace_id,
            'model_pack': pack_seq,
            'n_windows_in_pack': len(ts),
        })
    state.adopted = True
    state.error = text
    if not adopted:
      state.result = {'status': 'quarantined', 'error': text}
    state.pending -= len(ts)
    if state.pending == 0 and state.ingested:
      self._finish(state)

  def _finish(self, state: _RequestState) -> None:
    with self._lock:
      if state.finished:
        return
      state.finished = True
    self._release(state)
    if state.cancelled:
      return
    if state.result is None:  # not quarantined-skip
      status = 'fallback' if state.adopted else 'ok'
      t_stitch = time.time()
      try:
        stitched = stitch.stitch_arrays(
            state.name,
            np.asarray(state.pos, dtype=np.int64),
            state.ids,
            state.quals,
            max_length=self.options.max_length,
            min_quality=self.options.min_quality,
            min_length=self.options.min_length,
            outcome_counter=self.outcome,
        )
      except Exception as e:
        self.quarantine.handle(
            state.name, 'stitch', e, fallback=None,
            extra={'request_id': state.request_id,
                   'client': state.client,
                   'trace_id': state.trace_id})
        stitched = None
        status = 'quarantined'
        state.error = f'{type(e).__name__}: {e}'
      obs_lib.record_stage(self.metrics, obs_lib.trace.STAGE_STITCH,
                           t_stitch, time.time(),
                           trace_id=state.trace_id, zmw=state.name)
      if stitched is None and status != 'quarantined':
        status = 'filtered'
      state.result = {
          'status': status,
          'seq': stitched[0] if stitched else b'',
          'quals': stitched[1] if stitched else None,
          'counters': dict(state.counters),
          'error': state.error or '',
      }
    t_done = time.time()
    self._latency_hist.observe(time.monotonic() - state.t_submit)
    # Request-level span: the replica's leg of the cross-tier trace
    # (joined to router/featurize-worker spans by trace_id).
    obs_lib.trace.complete_event(
        'serve_request', 'request', state.t_submit_wall, t_done,
        {'trace_id': state.trace_id, 'zmw': state.name,
         'request_id': state.request_id,
         'status': (state.result or {}).get('status', 'cancelled')})
    state.event.set()

  def _release(self, state: _RequestState) -> None:
    with self._lock:
      self._outstanding.discard(state)

  def _fail_all_outstanding(self, error: BaseException) -> None:
    with self._lock:
      stuck = list(self._outstanding)
      self._outstanding.clear()
    for state in stuck:
      state.result = {
          'status': 'quarantined',
          'error': f'model loop died: {type(error).__name__}: {error}',
      }
      state.event.set()

  # ------------------------------------------------------------------
  # Observability

  def capacity(self) -> Dict[str, Any]:
    """Device capacity for /readyz and /metricz, in the reference's
    keys: the data-parallel width now and at launch, and whether the
    degrade ladder stepped down. The port serves on one card: mesh_dp 0,
    never degraded."""
    runner = self.engine.runner
    return {
        'mesh_dp': int(getattr(runner, 'mesh_dp', 0) or 0),
        'initial_dp': int(getattr(runner, '_initial_dp', 0) or 0),
        'degraded': bool(getattr(runner, 'is_degraded', False)),
    }

  def latency_percentiles(self) -> Dict[str, Optional[float]]:
    """Nearest-rank p50/p99 from the request-latency histogram,
    quantized to its bucket edges."""
    return self._latency_hist.percentiles()

  def prom_text(self) -> str:
    """/metricz?format=prom payload: the registry's typed exposition
    plus the pre-registry quarantine counters as untyped samples (the
    registry-owned names are excluded so no sample appears twice)."""
    registry_keys = set(self.metrics.snapshot()['counters'])
    extra = {k: v for k, v in self.stats()['counters'].items()
             if k not in registry_keys}
    return (self.metrics.to_prom('serve')
            + obs_lib.metrics.prom_counters_text(extra, tier='serve'))

  def stats(self) -> Dict[str, Any]:
    """The unified /metricz split: per-request serve counters next to
    the quarantine counters the batch pipeline already reports."""
    counters = dict(self.quarantine.counters)
    counters.setdefault('n_requests', 0)
    counters.setdefault('n_rejected_backpressure', 0)
    counters.setdefault('n_deadline_cancelled', 0)
    counters.setdefault('n_quarantined_by_request', 0)
    # Sharded-dispatch / transfer-overlap counters live in the faults
    # split; the zero defaults keep the keys present under stub
    # runners that don't implement the full dispatch contract.
    counters.setdefault('n_packs_dispatched_sharded', 0)
    counters.setdefault('n_transfer_overlapped', 0)
    counters.setdefault('n_transfer_direct', 0)
    counters.setdefault('transfer_overlap_fraction', 0.0)
    # Device fault domain (--on_device_error / --dispatch_timeout).
    counters.setdefault('n_oom_bisections', 0)
    counters.setdefault('n_device_faults', 0)
    counters.setdefault('n_dispatch_timeouts', 0)
    counters.setdefault('n_mesh_degradations', 0)
    # Quantized-inference levers (--inference_dtype/--quantize_matmuls):
    # the real values ride in from runner.dispatch_stats() through
    # engine.stats() and replace these defaults below.
    counters.setdefault('inference_dtype', 'float32')
    counters.setdefault('n_quantized_matmuls', 0)
    # Device-resident output plane (--device_epilogue): uint8 drain
    # counters, real values ride in the same way.
    counters.setdefault('device_epilogue', 0)
    counters.setdefault('n_epilogue_packs', 0)
    counters.setdefault('d2h_bytes_per_pack', 0)
    # Bucketed dispatch (--window_buckets): per-bucket pack counts,
    # compile count (distinct compiled forward shapes), and the
    # measured pad-to-max waste avoided; real values ride in from
    # engine.stats() the same way.
    counters.setdefault('n_packs_by_bucket', {})
    counters.setdefault('n_forward_shapes', 0)
    counters.setdefault('padding_fraction', 0.0)
    # Starvation-flush cost (--bucket_flush_packs) and the ragged
    # single-stream gate (--use_ragged_kernel): real values ride in
    # from engine.stats() the same way. flush_padding_fraction is
    # structurally 0.0 on the ragged path (no starvation flush).
    counters.setdefault('n_starvation_flushes', 0)
    counters.setdefault('flush_padding_fraction', 0.0)
    counters.setdefault('use_ragged_kernel', 0)
    with self._lock:
      outstanding = len(self._outstanding)
    engine_stats = self.engine.stats()
    for key in tuple(engine_stats):
      if key in counters:
        counters[key] = engine_stats.pop(key)
    registry_view = self.metrics.snapshot()
    out = {
        # The cross-tier schema: every tier exposes tier, ready,
        # draining, outstanding, counters, latency and histograms at the
        # top level; tier-specific keys nest beside.
        'tier': 'serve',
        'outstanding': outstanding,
        'draining': self._draining,
        'ready': self.ready,
        'counters': {**registry_view['counters'], **counters},
        'histograms': registry_view['histograms'],
        'capacity': self.capacity(),
        'latency': self.latency_percentiles(),
        'outcomes': dataclasses.asdict(self.outcome),
    }
    out.update(engine_stats)
    return out
