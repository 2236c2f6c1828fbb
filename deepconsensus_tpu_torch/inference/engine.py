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
  error propagates. The reference's fault policies (OOM bisection, mesh
  degradation, poisoned windows) are not part of the port yet.

The engine is not thread-safe: one thread drives it.
"""
from __future__ import annotations

import collections
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

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


# ----------------------------------------------------------------------
# Cross-batch window packer (one bucket width)


class _WindowPacker:
  """Formatted rows of one width accumulate across submissions; full
  batch_size packs are cut and dispatched as soon as they exist, so the
  forward runs padded only at the end-of-input tail (and at a
  starvation flush). Up to dispatch_depth packs stay in flight;
  draining the oldest hands its rows to deliver(), one call per
  ticket."""

  def __init__(self, runner, options, timing_rows: List[Dict[str, Any]],
               on_pack_failure: PackFailureFn, deliver: DeliverFn,
               pack_clock: Optional[List[int]] = None):
    self._runner = runner
    self._batch = options.batch_size
    self._depth = max(1, options.dispatch_depth)
    self._timing_rows = timing_rows
    self._on_pack_failure = on_pack_failure
    self._deliver = deliver
    self._rows: List[np.ndarray] = []
    self._tickets: List[Ticket] = []
    self._buffered = 0
    self._in_flight: collections.deque = collections.deque()
    # Shared across a bucketed engine's packers: every bucket's
    # dispatches tick it, so the starvation rule can measure the packs
    # the other buckets cut while this tail sat buffered.
    self._pack_clock: List[int] = (
        pack_clock if pack_clock is not None else [0])
    self._starve_mark = 0
    self.n_packs = 0
    self.n_pack_rows = 0
    self.n_pad_rows = 0
    self.n_starvation_flushes = 0

  def add(self, rows: np.ndarray, tickets: Sequence[Ticket]) -> None:
    """Buffers one submission's formatted rows ([k, R, L, 1], aligned
    with tickets) and dispatches every full pack now cuttable."""
    if not self._buffered:
      self._starve_mark = self._pack_clock[0]
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
    self.n_pack_rows += len(pack)
    self.n_pad_rows += self._batch - len(pack)
    try:
      handle = self._runner.dispatch(pack)
    except Exception as e:
      self._on_pack_failure(tickets, seq, e)
      return
    self._in_flight.append((handle, tickets, seq))
    while len(self._in_flight) > self._depth:
      self._drain_one()

  def _drain_one(self) -> None:
    handle, tickets, seq = self._in_flight.popleft()
    t0 = time.perf_counter()
    try:
      pred_ids, quality = self._runner.finalize(handle)
    except Exception as e:
      self._on_pack_failure(tickets, seq, e)
      return
    # uint8 transport into the stitch plane (values are 0..4 / 0..93).
    ids_u8 = pred_ids.astype(np.uint8)
    quals_u8 = quality.astype(np.uint8)
    elapsed = time.perf_counter() - t0
    for ticket, row_ids, row_quals in zip(tickets, ids_u8, quals_u8):
      self._deliver(ticket, row_ids, row_quals)
    self._timing_rows.append(dict(
        stage='run_model', runtime=elapsed, n_zmws=0,
        n_examples=len(tickets), n_subreads=0))

  def flush(self, drain: bool = True) -> None:
    """Cuts the sub-batch tail as a final (padded) pack; with drain,
    also resolves every in-flight pack."""
    self._cut_packs(flush=True)
    while drain and self._in_flight:
      self._drain_one()


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
  flushed. Dummies count as padding and are never delivered. With three
  or more buckets the offsets depend on how the widths mix, which no
  count reproduces: no dummies are placed and the plan is the JAX
  package's, whose flush points may then change a window's bits.
  """

  def __init__(self, runner, options, buckets: Sequence[int],
               deliver: DeliverFn,
               on_pack_failure: Optional[PackFailureFn] = None,
               timing_rows: Optional[List[Dict[str, Any]]] = None,
               pack_clock: Optional[List[int]] = None):
    self._buckets = rwa.validate_ragged_buckets(buckets)
    self._runner = runner
    self._slot_len = self._buckets[-1]
    self._wps = self._slot_len // self._buckets[0]  # windows per slot, max
    self._n_slots = max(1, int(options.batch_size) // self._wps)
    self._depth = max(1, int(getattr(options, 'dispatch_depth', 1)))
    self._deliver = deliver
    self._on_pack_failure = on_pack_failure or _raise_pack_failure
    self._timing_rows = timing_rows if timing_rows is not None else []
    self._pack_clock: List[int] = (
        pack_clock if pack_clock is not None else [0])
    # Per-width FIFO queues of (rows [R, w, 1], ticket): within a
    # width, placement order is submission order.
    self._queues: Dict[int, collections.deque] = {
        w: collections.deque() for w in self._buckets}
    self._buffered = 0
    self._in_flight: collections.deque = collections.deque()
    # Windows placed per width, and whether a partial pack was cut: the
    # dummy-window alignment (class docstring) applies from then on, on
    # a chain of at most two buckets.
    self._placed: Dict[int, int] = {w: 0 for w in self._buckets}
    self._realign = False
    self._can_realign = len(self._buckets) <= 2
    self.n_windows_by_bucket: Dict[int, int] = {w: 0 for w in self._buckets}
    self.n_packs = 0
    self.n_pack_rows = 0
    self.n_pad_rows = 0

  @property
  def slot_len(self) -> int:
    return self._slot_len

  def add(self, rows: np.ndarray, tickets: Sequence[Ticket]) -> None:
    """Buffers formatted rows [k, R, w, 1] of one bucket width (aligned
    with tickets) and dispatches every pack whose slots now fill
    exactly."""
    width = int(rows.shape[2])
    queue = self._queues.get(width)
    if queue is None:
      raise ValueError(
          f'window width {width} not in window buckets {self._buckets}')
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
    self.n_pack_rows += len(placements)
    # Unused position capacity in min-bucket units: the windows a full
    # pack of the same shape could additionally have carried.
    used = sum(p[3] for p in placements)
    self.n_pad_rows += (
        self._n_slots * self._slot_len - used) // self._buckets[0]
    try:
      handle = self._runner.dispatch_ragged(pack, lengths)
    except Exception as e:
      self._on_pack_failure([p[0] for p in placements], seq, e)
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
      self._on_pack_failure([p[0] for p in placements], seq, e)
      return
    ids_u8 = pred_ids.astype(np.uint8)
    quals_u8 = quality.astype(np.uint8)
    elapsed = time.perf_counter() - t0
    for ticket, slot, off, width in placements:
      self._deliver(ticket, ids_u8[slot, off:off + width],
                    quals_u8[slot, off:off + width])
    self._timing_rows.append(dict(
        stage='run_model', runtime=elapsed, n_zmws=0,
        n_examples=len(placements), n_subreads=0))

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
               timing_rows: Optional[List[Dict[str, Any]]] = None):
    self.runner = runner
    self.options = options
    self.timing_rows = timing_rows if timing_rows is not None else []
    self._deliver_fn = deliver
    self._on_pack_failure = on_pack_failure or _raise_pack_failure
    self._buckets = tuple(int(b) for b in (
        getattr(options, 'window_buckets', None) or runner.window_buckets))
    self._packers: Dict[int, _WindowPacker] = {}
    self._pack_clock: List[int] = [0]
    self._n_windows_by_bucket: Dict[int, int] = {}
    self._ragged = bool(getattr(options, 'use_ragged_kernel', False))
    self._ragged_packer: Optional[_RaggedPacker] = None

  def _packer_for(self, width: int):
    if width not in self._buckets:
      raise ValueError(
          f'window width {width} not in window buckets {self._buckets}')
    if self._ragged:
      if self._ragged_packer is None:
        self._ragged_packer = _RaggedPacker(
            self.runner, self.options, self._buckets, self._deliver_fn,
            on_pack_failure=self._on_pack_failure,
            timing_rows=self.timing_rows, pack_clock=self._pack_clock)
      return self._ragged_packer
    packer = self._packers.get(width)
    if packer is None:
      packer = self._packers[width] = _WindowPacker(
          self.runner, self.options, self.timing_rows,
          self._on_pack_failure, self._deliver_fn,
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

  def submit(self, raw_windows, tickets: Sequence[Ticket]) -> None:
    """Feeds featurized window tensors (one ticket per window) through
    format -> pack -> dispatch: a uniform [k, total_rows, L, 1] array
    or a sequence of [total_rows, L, 1] tensors with mixed L, grouped
    per bucket in submission order. Full packs dispatch at once; each
    bucket's tail waits for more windows, the starvation flush or
    flush()."""
    if len(raw_windows) != len(tickets):
      raise ValueError(
          f'{len(raw_windows)} windows vs {len(tickets)} tickets')
    if not len(raw_windows):
      return
    groups: Dict[int, Tuple[list, list]] = {}
    for w, t in zip(raw_windows, tickets):
      ws, ts = groups.setdefault(int(np.shape(w)[-2]), ([], []))
      ws.append(w)
      ts.append(t)
    for width, (ws, ts) in sorted(groups.items()):
      rows = data_lib.format_rows_batch(
          np.stack(ws), self.runner.params, window_buckets=self._buckets)
      self._n_windows_by_bucket[width] = (
          self._n_windows_by_bucket.get(width, 0) + len(rows))
      self._packer_for(width).add(rows, ts)
    self._flush_starved()

  def flush(self, drain: bool = True) -> None:
    """Cuts every bucket's buffered tail as a padded pack; with drain,
    resolves every in-flight pack. Tails cut for all buckets before any
    drain, so the end-of-input packs overlap on the card."""
    for packer in self._all_packers():
      packer.flush(drain=False)
    if drain:
      for packer in self._all_packers():
        packer.flush(drain=True)

  def _agg(self, name: str):
    return sum(getattr(p, name) for p in self._all_packers())

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
