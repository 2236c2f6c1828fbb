"""ConsensusEngine: featurized windows in, finalized (ids, quals) out.

Port of deepconsensus_tpu/inference/engine.py, the model stage of `run`
(triage -> pack -> dispatch -> finalize) behind a narrow interface:

  engine = ConsensusEngine(runner, options, deliver=...)
  engine.submit(raw_windows, tickets)   # featurized windows in
  engine.flush()                        # end of input
  # finalized uint8 (ids, quals) rows come back through deliver()

* `tickets` are opaque, one per submitted window; the engine never
  inspects them. deliver(ticket, ids_u8, quals_u8) fires once per
  window as its pack finalizes, on the thread that calls submit/flush.
* The engine owns one cross-batch `_WindowPacker` per window bucket
  (full fixed-shape packs cut across submissions, padding only at
  flush) or, with use_ragged_kernel, one `_RaggedPacker` for every
  width; and the dispatch depth: up to options.dispatch_depth packs of
  each packer stay in flight on the card (ModelRunner.dispatch /
  finalize) before the oldest is drained.
* A pack that fails to dispatch or finalize routes its tickets to
  on_pack_failure(tickets, pack_seq, error); without the callback the
  error propagates. The error is first classified into the DeviceFault
  family (faults.classify_device_error). Under
  options.on_device_error == 'degrade' an out-of-memory pack is retried
  as halves at half the batch shape, recursively, down to one row
  (_bisect); a dispatch timeout is never retried. On one card there is
  no mesh to degrade, so a lost device goes to on_pack_failure, as the
  reference's degrade_mesh does without a mesh.
* poison_ticket() makes the pack holding a ticket fail at dispatch
  (faults.ENV_POISON_WINDOW).
* The serving hooks (serve/service.py): submit_formatted() re-submits
  rows already formatted (the isolation retry), has_work says whether a
  window is buffered or in flight, and stats() gives the pack counters
  that `/metricz` shows.

The engine is not thread-safe: one thread drives it.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepconsensus_tpu_torch import faults as faults_lib
from deepconsensus_tpu_torch import obs as obs_lib
from deepconsensus_tpu_torch.calibration import lib as calibration_lib
from deepconsensus_tpu_torch.models import data as data_lib
from deepconsensus_tpu_torch.ops import ragged_window_attention as rwa
from deepconsensus_tpu_torch.preprocess.pileup import row_indices
from deepconsensus_tpu_torch.utils import phred

# Bucket starvation flush: a bucket's partial tail that sat buffered
# while the other buckets cut this many packs is cut as a padded pack,
# so a rarely fed bucket's windows are not held back (the reference's
# default; tails always flush at end of input).
BUCKET_FLUSH_PACKS = 8

Ticket = Any
DeliverFn = Callable[[Ticket, np.ndarray, np.ndarray], None]
PackFailureFn = Callable[[Sequence[Ticket], int, BaseException], None]


# ----------------------------------------------------------------------
# Window triage


def triage_windows(
    feature_dicts: List[Dict[str, Any]],
    options,
    counter: collections.Counter,
) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]]]:
  """Splits windows into (model, skip) per overflow/quality rules
  (reference: quick_inference.py:653-678)."""
  to_model: List[Dict[str, Any]] = []
  to_skip: List[Dict[str, Any]] = []
  for fd in feature_dicts:
    if fd['overflow']:
      to_skip.append(fd)
      counter['n_windows_overflow_skipped'] += 1
      continue
    if options.skip_windows_above:
      avg_q = phred.avg_phred(fd['ccs_base_quality_scores'])
      # Strictly above, matching the reference (quick_inference.py:671).
      if avg_q > options.skip_windows_above:
        to_skip.append(fd)
        counter['n_windows_quality_skipped'] += 1
        continue
    to_model.append(fd)
    counter['n_windows_to_model'] += 1
  return to_model, to_skip


def ccs_quals_array(bq_scores, options) -> np.ndarray:
  """CCS base qualities -> emitted phred uint8 (calibration, cap at
  max_base_quality, floor at 0)."""
  quals = np.asarray(bq_scores)
  if options.ccs_calibration_values.enabled:
    quals = calibration_lib.calibrate_quality_scores(
        quals, options.ccs_calibration_values)
  quals = np.minimum(quals, options.max_base_quality).astype(np.int32)
  return np.maximum(quals, 0).astype(np.uint8)


def skipped_window_arrays(
    feature_dict: Dict[str, Any], options
) -> Tuple[np.ndarray, np.ndarray]:
  """(vocab ids uint8 [L], phred uint8 [L]) adopted from the draft CCS.
  Copies out of the feature tensor, so a backing shm segment can be
  released."""
  rows = feature_dict['subreads']
  ccs_range = row_indices(options.max_passes, options.use_ccs_bq)[4]
  ids = rows[ccs_range[0], :, 0].astype(np.uint8)
  return ids, ccs_quals_array(
      feature_dict['ccs_base_quality_scores'], options)


def _raise_pack_failure(tickets, pack_seq: int, error: BaseException):
  del tickets, pack_seq
  raise error


def _raise_if_poisoned(poisoned: set, tickets, seq: int, what: str) -> None:
  """Fault injection: a pack holding a poisoned ticket fails at dispatch
  with a bare RuntimeError, as a real dispatch error would."""
  hit = [t for t in tickets if id(t) in poisoned]
  if hit:
    for t in hit:
      poisoned.discard(id(t))
    raise RuntimeError(
        'injected poison window payload '
        f'({faults_lib.ENV_POISON_WINDOW}; {len(hit)} window(s) '
        f'in {what} {seq})')


# ----------------------------------------------------------------------
# Cross-batch window packer (one bucket width)


class _WindowPacker:
  """Formatted rows of one width accumulate across submissions; full
  batch_size packs are cut and dispatched as soon as they exist, so the
  forward runs padded only at the end-of-input tail (and at a
  starvation flush). Up to dispatch_depth packs stay in flight;
  draining the oldest hands its rows to deliver(), one call per
  ticket. Under on_device_error == 'degrade' each in-flight pack keeps
  its host rows, so an out-of-memory pack can be bisected (up to
  dispatch_depth packs of extra host memory)."""

  def __init__(self, runner, options, timing_rows: List[Dict[str, Any]],
               on_pack_failure: PackFailureFn, deliver: DeliverFn,
               poisoned: Optional[set] = None,
               pack_clock: Optional[List[int]] = None):
    self._runner = runner
    self._batch = options.batch_size
    self._depth = max(1, options.dispatch_depth)
    self._degrade = getattr(options, 'on_device_error', 'fail') == 'degrade'
    self._timing_rows = timing_rows
    self._on_pack_failure = on_pack_failure
    self._deliver = deliver
    self._rows: List[np.ndarray] = []
    self._tickets: List[Ticket] = []
    self._buffered = 0
    self._in_flight: collections.deque = collections.deque()
    # Shared across a bucketed engine's packers: one poison set (the
    # caller does not know which bucket a ticket lands in) and one pack
    # clock, which every bucket's dispatches tick, so the starvation
    # rule can measure the packs the other buckets cut while this tail
    # sat buffered.
    self._poisoned: set = poisoned if poisoned is not None else set()
    self._pack_clock: List[int] = (
        pack_clock if pack_clock is not None else [0])
    self._starve_mark = 0
    # When the buffered tail started waiting (the pack_wait span).
    self._t_buf_start = 0.0
    self._obs = getattr(runner, 'obs', None)
    self.n_packs = 0
    self.n_pack_rows = 0
    self.n_pad_rows = 0
    self.n_starvation_flushes = 0
    # The pad rows of starvation flushes (also counted in n_pad_rows).
    self.n_flush_pad_rows = 0
    # Host seconds spent resolving packs (finalize and delivery).
    self.model_wall = 0.0
    self.n_oom_bisections = 0
    self.n_device_faults = 0
    self.n_dispatch_timeouts = 0

  def add(self, rows: np.ndarray, tickets: Sequence[Ticket]) -> None:
    """Buffers one submission's formatted rows ([k, R, L, 1], aligned
    with tickets) and dispatches every full pack now cuttable."""
    if not self._buffered:
      self._starve_mark = self._pack_clock[0]
      self._t_buf_start = time.time()
    self._rows.append(rows)
    self._tickets.extend(tickets)
    self._buffered += len(rows)
    self._cut_packs(flush=False)

  def maybe_flush_starved(self, limit: int) -> None:
    """Cuts this packer's partial tail as a padded pack once the engine
    (all buckets together) cut >= limit packs while it sat buffered,
    so a rarely fed bucket's windows are not held back."""
    if self._buffered and self._pack_clock[0] - self._starve_mark >= limit:
      self.n_starvation_flushes += 1
      self.n_flush_pad_rows += self._batch - self._buffered
      self._cut_packs(flush=True)

  def _cut_packs(self, flush: bool) -> None:
    while self._buffered >= self._batch or (flush and self._buffered):
      if len(self._rows) > 1:
        self._rows = [np.concatenate(self._rows)]
      buf = self._rows[0]
      n = min(self._batch, self._buffered)
      pack, rest = buf[:n], buf[n:]
      self._rows = [rest] if len(rest) else []
      tickets = self._tickets[:n]
      del self._tickets[:n]
      self._buffered -= n
      self._dispatch(pack, tickets)

  def _dispatch(self, pack: np.ndarray, tickets: List[Ticket]) -> None:
    seq = self.n_packs
    self.n_packs += 1
    self._pack_clock[0] += 1
    self._starve_mark = self._pack_clock[0]
    t_cut = time.time()
    obs_lib.record_stage(self._obs, obs_lib.trace.STAGE_PACK_WAIT,
                         self._t_buf_start or t_cut, t_cut,
                         bucket=int(pack.shape[2]), n_rows=len(pack))
    # A leftover tail starts its wait at this cut.
    self._t_buf_start = t_cut
    self.n_pack_rows += len(pack)
    self.n_pad_rows += self._batch - len(pack)
    try:
      if self._poisoned:
        _raise_if_poisoned(self._poisoned, tickets, seq, 'pack')
      handle = self._runner.dispatch(pack)
    except Exception as e:
      self._handle_pack_fault(pack if self._degrade else None, tickets, seq,
                              e)
      return
    # Degrade mode keeps the host rows, so an OOM can bisect the pack.
    self._in_flight.append(
        (handle, tickets, seq, pack if self._degrade else None))
    while len(self._in_flight) > self._depth:
      self._drain_one()

  def _drain_one(self) -> None:
    handle, tickets, seq, pack = self._in_flight.popleft()
    t0 = time.perf_counter()
    try:
      pred_ids, quality = self._runner.finalize(handle)
    except Exception as e:
      self._handle_pack_fault(pack, tickets, seq, e)
      return
    self._deliver_pack(tickets, pred_ids, quality, t0)

  def _deliver_pack(self, tickets: List[Ticket], pred_ids: np.ndarray,
                    quality: np.ndarray, t0: float) -> None:
    # uint8 transport into the stitch plane (values are 0..4 / 0..93).
    ids_u8 = pred_ids.astype(np.uint8)
    quals_u8 = quality.astype(np.uint8)
    elapsed = time.perf_counter() - t0
    self.model_wall += elapsed
    for ticket, row_ids, row_quals in zip(tickets, ids_u8, quals_u8):
      self._deliver(ticket, row_ids, row_quals)
    self._timing_rows.append(dict(
        stage='run_model', runtime=elapsed, n_zmws=0,
        n_examples=len(tickets), n_subreads=0))

  def _handle_pack_fault(self, pack: Optional[np.ndarray],
                         tickets: List[Ticket], seq: int,
                         error: BaseException,
                         batch_size: Optional[int] = None) -> None:
    """The device-fault policy for one failed pack: classify, count,
    and under degrade (with the pack's host rows kept) bisect an
    out-of-memory pack. Whatever is not recovered goes to
    on_pack_failure with the classified error, so dead letters carry
    the device fault's type."""
    error = faults_lib.classify_device_error(error)
    if isinstance(error, faults_lib.DeviceFault):
      self.n_device_faults += 1
      if isinstance(error, faults_lib.DispatchTimeoutError):
        # The watchdog bounded the loss; a hung device would hang again.
        self.n_dispatch_timeouts += 1
      elif (self._degrade and pack is not None
            and isinstance(error, faults_lib.DeviceOomError)
            and self._bisect(pack, tickets, seq, batch_size or self._batch)):
        return
    self._on_pack_failure(tickets, seq, error)

  def _bisect(self, pack: np.ndarray, tickets: List[Ticket], seq: int,
              batch_size: int) -> bool:
    """OOM bisection: the pack again as halves at half the batch shape;
    False when no smaller shape exists (one row)."""
    half = batch_size // 2
    if half < 1:
      return False
    self.n_oom_bisections += 1
    for lo in range(0, len(pack), half):
      self._run_pack_at(pack[lo:lo + half], tickets[lo:lo + half], seq, half)
    return True

  def _run_pack_at(self, pack: np.ndarray, tickets: List[Ticket], seq: int,
                   batch_size: int) -> None:
    """A synchronous retry of one (bisected) pack at an explicit batch
    shape; a further fault recurses through _handle_pack_fault, so a
    half can bisect again."""
    t0 = time.perf_counter()
    try:
      handle = self._runner.dispatch(pack, batch_size=batch_size)
      pred_ids, quality = self._runner.finalize(handle)
    except Exception as e:
      self._handle_pack_fault(pack, tickets, seq, e, batch_size=batch_size)
      return
    self._deliver_pack(tickets, pred_ids, quality, t0)

  def flush(self, drain: bool = True) -> None:
    """Cuts the sub-batch tail as a final (padded) pack; with drain,
    also resolves every in-flight pack."""
    self._cut_packs(flush=True)
    while drain and self._in_flight:
      self._drain_one()

  @property
  def batch(self) -> int:
    return self._batch

  @property
  def has_work(self) -> bool:
    return bool(self._buffered or self._in_flight)


# ----------------------------------------------------------------------
# Single-stream ragged packer (use_ragged_kernel)


class _RaggedPacker:
  """One pack stream for every bucket width: mixed-width windows pack
  into fixed [n_slots, R, slot_len, 1] slots (slot_len = the largest
  bucket) with a per-slot int32 lengths row, and dispatch through the
  runner's ragged forward (ModelRunner.dispatch_ragged). Packs cut
  across submissions, only when every slot fills exactly; partial,
  zero-length-padded slots appear only at flush(). Up to
  dispatch_depth packs stay in flight; delivery slices each window
  back out by its placement.

  Packing is greedy largest-first against the bucket divisibility
  chain, so every window starts at a multiple of its own width.

  Faults are classified and counted (dispatch timeouts among them),
  then the whole pack goes to on_pack_failure: no bisection, as in the
  reference (the single slot shape is the point of the path).

  The card's attention core sums a window's keys in tiles aligned to
  the slot, so a window's outputs are the same bits only at the same
  offset. With a chain of two buckets (a, b), every exactly filled slot
  holds one b-wide window or b/a a-wide ones, so in a stream that was
  never flushed the j-th a-wide window sits at offset a * (j mod b/a).
  After a partial pack (a flush before the end of input, as
  `pack_across_batches=False` makes at every featurize batch), a slot
  that would start with an a-wide window at j mod b/a != 0 starts with
  that many zero-filled dummy windows instead, so every window keeps
  that offset and its output does not depend on where the stream was
  flushed. Dummies count as padding and are never delivered. A stream
  that resumes an interrupted run (`placed`: the windows of each width
  the committed featurize batches held) starts aligned in the same way,
  as if it had placed them, so its windows keep the uninterrupted
  run's offsets. With three or more buckets the offsets depend on how
  the widths mix, which no count reproduces: no dummies are placed and
  the plan is the JAX package's, whose flush points may then change a
  window's bits.
  """

  def __init__(self, runner, options, buckets: Sequence[int],
               deliver: DeliverFn,
               on_pack_failure: Optional[PackFailureFn] = None,
               timing_rows: Optional[List[Dict[str, Any]]] = None,
               poisoned: Optional[set] = None,
               pack_clock: Optional[List[int]] = None,
               placed: Optional[Dict[int, int]] = None):
    self._buckets = rwa.validate_ragged_buckets(buckets)
    self._runner = runner
    self._slot_len = self._buckets[-1]
    self._wps = self._slot_len // self._buckets[0]  # windows per slot, max
    self._n_slots = max(1, int(options.batch_size) // self._wps)
    self._depth = max(1, int(getattr(options, 'dispatch_depth', 1)))
    self._deliver = deliver
    self._on_pack_failure = on_pack_failure or _raise_pack_failure
    self._timing_rows = timing_rows if timing_rows is not None else []
    self._poisoned: set = poisoned if poisoned is not None else set()
    self._pack_clock: List[int] = (
        pack_clock if pack_clock is not None else [0])
    self._t_buf_start = 0.0
    self._obs = getattr(runner, 'obs', None)
    # Per-width FIFO queues of (rows [R, w, 1], ticket): within a
    # width, placement order is submission order.
    self._queues: Dict[int, collections.deque] = {
        w: collections.deque() for w in self._buckets}
    self._buffered = 0
    self._in_flight: collections.deque = collections.deque()
    # Windows placed per width (a resumed stream counts the committed
    # ones), and whether the dummy-window alignment (class docstring)
    # applies: after a partial pack or on resuming, on a chain of at most
    # two buckets.
    self._placed: Dict[int, int] = {
        w: int((placed or {}).get(w, 0)) for w in self._buckets}
    self._can_realign = len(self._buckets) <= 2
    self._realign = self._can_realign and any(self._placed.values())
    self.n_windows_by_bucket: Dict[int, int] = {w: 0 for w in self._buckets}
    self.n_packs = 0
    self.n_pack_rows = 0
    self.n_pad_rows = 0
    self.n_device_faults = 0
    self.n_dispatch_timeouts = 0
    self.model_wall = 0.0

  @property
  def slot_len(self) -> int:
    return self._slot_len

  @property
  def n_slots(self) -> int:
    return self._n_slots

  @property
  def windows_per_slot(self) -> int:
    return self._wps

  @property
  def has_work(self) -> bool:
    return bool(self._buffered or self._in_flight)

  def add(self, rows: np.ndarray, tickets: Sequence[Ticket]) -> None:
    """Buffers formatted rows [k, R, w, 1] of one bucket width (aligned
    with tickets) and dispatches every pack whose slots now fill
    exactly."""
    width = int(rows.shape[2])
    queue = self._queues.get(width)
    if queue is None:
      raise ValueError(
          f'window width {width} not in window buckets {self._buckets}')
    if not self._buffered:
      self._t_buf_start = time.time()
    for row, ticket in zip(rows, tickets):
      queue.append((row, ticket))
    self._buffered += len(rows)
    self.n_windows_by_bucket[width] += len(rows)
    self._cut_packs(flush=False)

  def _plan(self, allow_partial: bool
            ) -> Optional[List[Tuple[int, int, int, bool]]]:
    """Greedy largest-first slot plan: [(slot, offset, width, dummy),
    ...] in per-width FIFO order, or None when the slots cannot all be
    filled exactly (and partial packs are not allowed). With the
    divisibility chain, any remaining slot capacity is a multiple of
    every smaller bucket, so largest-first never strands capacity a
    different order could have filled."""
    counts = {w: len(q) for w, q in self._queues.items()}
    placed = dict(self._placed)
    plan: List[Tuple[int, int, int, bool]] = []
    for slot in range(self._n_slots):
      remaining = self._slot_len
      while remaining:
        width = next(
            (w for w in reversed(self._buckets)
             if w <= remaining and counts[w]), None)
        if width is None:
          if allow_partial:
            break
          return None
        if self._realign and remaining == self._slot_len:
          for _ in range(placed[width] % (self._slot_len // width)):
            plan.append((slot, self._slot_len - remaining, width, True))
            remaining -= width
        counts[width] -= 1
        placed[width] += 1
        plan.append((slot, self._slot_len - remaining, width, False))
        remaining -= width
      if allow_partial and not any(counts.values()):
        break
    return plan

  def _cut_packs(self, flush: bool) -> None:
    while True:
      plan = self._plan(allow_partial=False)
      if plan is None:
        break
      self._dispatch(plan)
    while flush and self._buffered:
      self._dispatch(self._plan(allow_partial=True))
      self._realign = self._can_realign

  def _materialize(self, plan: List[Tuple[int, int, int, bool]]):
    """Pops the planned windows: (pack [n_slots, R, slot_len, 1] f32,
    lengths [n_slots, wps] int32, placements [(ticket, slot, offset,
    width)]); dummy windows stay zero and have no placement."""
    width0 = next(width for _, _, width, dummy in plan if not dummy)
    n_rows = self._queues[width0][0][0].shape[0]
    pack = np.zeros((self._n_slots, n_rows, self._slot_len, 1),
                    dtype=np.float32)
    lengths = np.zeros((self._n_slots, self._wps), dtype=np.int32)
    slot_fill = [0] * self._n_slots
    placements = []
    for slot, off, width, dummy in plan:
      lengths[slot, slot_fill[slot]] = width
      slot_fill[slot] += 1
      if dummy:
        continue
      row, ticket = self._queues[width].popleft()
      pack[slot, :, off:off + width] = row
      placements.append((ticket, slot, off, width))
      self._placed[width] += 1
    self._buffered -= len(placements)
    return pack, lengths, placements

  def _dispatch(self, plan: List[Tuple[int, int, int, bool]]) -> None:
    pack, lengths, placements = self._materialize(plan)
    seq = self.n_packs
    self.n_packs += 1
    self._pack_clock[0] += 1
    t_cut = time.time()
    obs_lib.record_stage(self._obs, obs_lib.trace.STAGE_PACK_WAIT,
                         self._t_buf_start or t_cut, t_cut,
                         bucket=self._slot_len, n_rows=len(placements))
    self._t_buf_start = t_cut
    self.n_pack_rows += len(placements)
    # Unused position capacity in min-bucket units: the windows a full
    # pack of the same shape could additionally have carried.
    used = sum(p[3] for p in placements)
    self.n_pad_rows += (
        self._n_slots * self._slot_len - used) // self._buckets[0]
    try:
      if self._poisoned:
        _raise_if_poisoned(self._poisoned, [p[0] for p in placements], seq,
                           'ragged pack')
      handle = self._runner.dispatch_ragged(pack, lengths)
    except Exception as e:
      self._handle_pack_fault(placements, seq, e)
      return
    self._in_flight.append((handle, placements, seq))
    while len(self._in_flight) > self._depth:
      self._drain_one()

  def _drain_one(self) -> None:
    handle, placements, seq = self._in_flight.popleft()
    t0 = time.perf_counter()
    try:
      pred_ids, quality = self._runner.finalize(handle)
    except Exception as e:
      self._handle_pack_fault(placements, seq, e)
      return
    ids_u8 = pred_ids.astype(np.uint8)
    quals_u8 = quality.astype(np.uint8)
    elapsed = time.perf_counter() - t0
    self.model_wall += elapsed
    for ticket, slot, off, width in placements:
      self._deliver(ticket, ids_u8[slot, off:off + width],
                    quals_u8[slot, off:off + width])
    self._timing_rows.append(dict(
        stage='run_model', runtime=elapsed, n_zmws=0,
        n_examples=len(placements), n_subreads=0))

  def _handle_pack_fault(self, placements, seq: int,
                         error: BaseException) -> None:
    error = faults_lib.classify_device_error(error)
    if isinstance(error, faults_lib.DeviceFault):
      self.n_device_faults += 1
      if isinstance(error, faults_lib.DispatchTimeoutError):
        self.n_dispatch_timeouts += 1
    self._on_pack_failure([p[0] for p in placements], seq, error)

  def flush(self, drain: bool = True) -> None:
    """Cuts the buffered tail as final (zero-length-padded) packs; with
    drain, also resolves every in-flight pack. The only place partial
    packs exist on the ragged path."""
    self._cut_packs(flush=True)
    while drain and self._in_flight:
      self._drain_one()


# ----------------------------------------------------------------------
# The engine


class ConsensusEngine:
  """Submit featurized windows, receive finalized uint8 (ids, quals).

  Owns one window packer per length bucket (created at the first
  window of that width), or one ragged packer for every width with
  options.use_ragged_kernel, and the shared pack clock. Mixed-width
  submissions are grouped by trailing window width; within a bucket,
  delivery stays in submission order.
  """

  def __init__(self, runner, options, deliver: DeliverFn,
               on_pack_failure: Optional[PackFailureFn] = None,
               timing_rows: Optional[List[Dict[str, Any]]] = None,
               resume_placed: Optional[Dict[int, int]] = None):
    self.runner = runner
    # Model windows of each width before a resumed stream's first (the
    # ragged packer's alignment; _RaggedPacker's `placed`).
    self._resume_placed = resume_placed
    self.options = options
    self.timing_rows = timing_rows if timing_rows is not None else []
    self._deliver_fn = deliver
    self._on_pack_failure = on_pack_failure or _raise_pack_failure
    self._buckets = tuple(int(b) for b in (
        getattr(options, 'window_buckets', None) or runner.window_buckets))
    self._packers: Dict[int, _WindowPacker] = {}
    self._poisoned: set = set()
    self._pack_clock: List[int] = [0]
    self._n_windows_by_bucket: Dict[int, int] = {}
    self._ragged = bool(getattr(options, 'use_ragged_kernel', False))
    self._ragged_packer: Optional[_RaggedPacker] = None

  @property
  def window_buckets(self) -> Tuple[int, ...]:
    return self._buckets

  @property
  def params(self):
    return self.runner.params

  def _packer_for(self, width: int):
    if width not in self._buckets:
      raise ValueError(
          f'window width {width} not in window buckets {self._buckets}')
    if self._ragged:
      if self._ragged_packer is None:
        self._ragged_packer = _RaggedPacker(
            self.runner, self.options, self._buckets, self._deliver_fn,
            on_pack_failure=self._on_pack_failure,
            timing_rows=self.timing_rows, poisoned=self._poisoned,
            pack_clock=self._pack_clock, placed=self._resume_placed)
      return self._ragged_packer
    packer = self._packers.get(width)
    if packer is None:
      packer = self._packers[width] = _WindowPacker(
          self.runner, self.options, self.timing_rows,
          self._on_pack_failure, self._deliver_fn, poisoned=self._poisoned,
          pack_clock=self._pack_clock)
    return packer

  def _all_packers(self) -> List[Any]:
    if self._ragged:
      return [self._ragged_packer] if self._ragged_packer else []
    return [self._packers[w] for w in sorted(self._packers)]

  def _flush_starved(self) -> None:
    if self._ragged or len(self._packers) < 2:
      return
    for width in sorted(self._packers):
      self._packers[width].maybe_flush_starved(BUCKET_FLUSH_PACKS)

  @staticmethod
  def _by_width(windows, tickets):
    """(width, stacked windows, their tickets) per trailing window width,
    in ascending width; submission order within a width."""
    if len(windows) != len(tickets):
      raise ValueError(f'{len(windows)} windows vs {len(tickets)} tickets')
    groups: Dict[int, Tuple[list, list]] = {}
    for w, t in zip(windows, tickets):
      ws, ts = groups.setdefault(int(np.shape(w)[-2]), ([], []))
      ws.append(w)
      ts.append(t)
    return [(width, np.stack(ws), ts)
            for width, (ws, ts) in sorted(groups.items())]

  def _add_rows(self, width: int, rows: np.ndarray, tickets) -> None:
    self._n_windows_by_bucket[width] = (
        self._n_windows_by_bucket.get(width, 0) + len(rows))
    self._packer_for(width).add(rows, tickets)

  def submit(self, raw_windows, tickets: Sequence[Ticket]) -> None:
    """Feeds featurized window tensors (one ticket per window) through
    format -> pack -> dispatch: a uniform [k, total_rows, L, 1] array
    or a sequence of [total_rows, L, 1] tensors with mixed L, grouped
    per bucket in submission order. Full packs dispatch at once; each
    bucket's tail waits for more windows, the starvation flush or
    flush()."""
    for width, windows, ts in self._by_width(raw_windows, tickets):
      self._add_rows(width, data_lib.format_rows_batch(
          windows, self.runner.params, window_buckets=self._buckets), ts)
    self._flush_starved()

  def submit_formatted(self, rows, tickets: Sequence[Ticket]) -> None:
    """submit() for rows already through data.format_rows_batch (the
    serve isolation retry dispatches them again without formatting)."""
    for width, stacked, ts in self._by_width(rows, tickets):
      self._add_rows(width, stacked, ts)
    self._flush_starved()

  @property
  def has_work(self) -> bool:
    """True while a submitted window is buffered or in flight."""
    return any(p.has_work for p in self._all_packers())

  def flush(self, drain: bool = True) -> None:
    """Cuts every bucket's buffered tail as a padded pack; with drain,
    resolves every in-flight pack. Tails cut for all buckets before any
    drain, so the end-of-input packs overlap on the card."""
    for packer in self._all_packers():
      packer.flush(drain=False)
    if drain:
      for packer in self._all_packers():
        packer.flush(drain=True)

  def poison_ticket(self, ticket: Ticket) -> None:
    """Fault injection: the pack that takes this ticket fails at
    dispatch (one poison set for every bucket)."""
    self._poisoned.add(id(ticket))

  def _agg(self, name: str):
    return sum(getattr(p, name, 0) for p in self._all_packers())

  @property
  def n_packs(self) -> int:
    return self._agg('n_packs')

  @property
  def n_pack_rows(self) -> int:
    return self._agg('n_pack_rows')

  @property
  def n_pad_rows(self) -> int:
    return self._agg('n_pad_rows')

  @property
  def n_starvation_flushes(self) -> int:
    return sum(p.n_starvation_flushes for p in self._packers.values())

  @property
  def model_wall(self) -> float:
    return self._agg('model_wall')

  @property
  def flush_padding_fraction(self) -> float:
    """Share of all dispatched positions that were starvation-flush
    padding: sum_b(n_flush_pad_rows_b * L_b) / sum_b(n_packs_b * B * L_b);
    0.0 on the ragged path, which has no starvation flush."""
    dispatched = flushed = 0
    for width, packer in sorted(self._packers.items()):
      dispatched += packer.n_packs * packer.batch * width
      flushed += packer.n_flush_pad_rows * width
    return flushed / dispatched if dispatched else 0.0

  @property
  def padding_fraction(self) -> float:
    """Share of positions a pad-to-max policy would have dispatched on
    top of the bucketed dispatch: 1 - sum(n_b * L_b) / (N * L_max); 0.0
    with one bucket or before any window arrives."""
    total = sum(self._n_windows_by_bucket.values())
    if not total or len(self._buckets) < 2:
      return 0.0
    bucketed = sum(n * w for w, n in self._n_windows_by_bucket.items())
    return 1.0 - bucketed / (total * max(self._buckets))

  @property
  def n_oom_bisections(self) -> int:
    return self._agg('n_oom_bisections')

  @property
  def n_device_faults(self) -> int:
    return self._agg('n_device_faults')

  @property
  def n_dispatch_timeouts(self) -> int:
    return self._agg('n_dispatch_timeouts')

  def _by_bucket(self, name: str) -> Dict[int, int]:
    if self._ragged:
      packer = self._ragged_packer
      return {packer.slot_len: getattr(packer, name)} if packer else {}
    return {w: getattr(self._packers[w], name) for w in sorted(self._packers)}

  @property
  def n_packs_by_bucket(self) -> Dict[int, int]:
    return self._by_bucket('n_packs')

  @property
  def n_pad_rows_by_bucket(self) -> Dict[int, int]:
    """Pad rows per pack shape; ragged packs count unused slot capacity
    in min-bucket units."""
    return self._by_bucket('n_pad_rows')

  @property
  def n_windows_by_bucket(self) -> Dict[int, int]:
    return {w: self._n_windows_by_bucket.get(w, 0) for w in self._buckets}

  def stats(self) -> Dict[str, Any]:
    """The pack counters of serve's `/metricz` (the reference engine's
    stats() keys), with the runner's transfer counters."""
    out = {
        'n_model_packs': self.n_packs,
        'n_model_pack_rows': self.n_pack_rows,
        'n_model_pad_rows': self.n_pad_rows,
        'n_starvation_flushes': self.n_starvation_flushes,
        'flush_padding_fraction': round(self.flush_padding_fraction, 4),
        'model_wall_s': round(self.model_wall, 3),
        'n_oom_bisections': self.n_oom_bisections,
        'n_device_faults': self.n_device_faults,
        'n_dispatch_timeouts': self.n_dispatch_timeouts,
    }
    dispatch_stats = getattr(self.runner, 'dispatch_stats', None)
    if dispatch_stats is not None:
      out.update(dispatch_stats())
    out['window_buckets'] = list(self._buckets)
    out['use_ragged_kernel'] = int(self._ragged)
    out['n_packs_by_bucket'] = self.n_packs_by_bucket
    out['n_windows_by_bucket'] = {
        w: self._n_windows_by_bucket[w]
        for w in sorted(self._n_windows_by_bucket)}
    out['padding_fraction'] = round(self.padding_fraction, 4)
    return out
