"""The ragged slot packer: mixed-width windows -> fixed-shape packs.

Port of the reference's deepconsensus_tpu/inference/engine.py
`_RaggedPacker` as a serial packer. Windows of every bucket width pack
into fixed [n_slots, R, slot_len, 1] packs (slot_len = the largest
bucket) with a per-slot int32 lengths row, and each pack runs through
the runner's ragged forward (ModelRunner.predict_ragged) as soon as it
is cut; delivery slices each window back out by its placement. Packs
cut only when every slot fills exactly; partial, zero-length-padded
slots appear only at flush(). The reference's dispatch depth, poison
set and fault counters are not part of the port (ROADMAP).

Packing is greedy largest-first against the bucket divisibility chain,
so every window starts at a multiple of its own width.
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from deepconsensus_tpu_torch.ops import ragged_window_attention as rwa

Ticket = Any
DeliverFn = Callable[[Ticket, np.ndarray, np.ndarray], None]


class _RaggedPacker:
  """Buffers formatted windows per width and runs every pack it can
  fill exactly; flush() runs the partial tail."""

  def __init__(self, runner, options, buckets: Sequence[int],
               deliver: DeliverFn):
    self._buckets = rwa.validate_ragged_buckets(buckets)
    self._runner = runner
    self._slot_len = self._buckets[-1]
    self._wps = self._slot_len // self._buckets[0]  # windows per slot, max
    self._n_slots = max(1, int(options.batch_size) // self._wps)
    self._deliver = deliver
    # Per-width FIFO queues of (rows [R, w, 1], ticket): within a
    # width, placement order is submission order.
    self._queues: Dict[int, collections.deque] = {
        w: collections.deque() for w in self._buckets}
    self._buffered = 0
    self.n_windows_by_bucket: Dict[int, int] = {w: 0 for w in self._buckets}
    self.n_packs = 0
    self.n_pack_rows = 0
    self.n_pad_rows = 0

  def add(self, rows: np.ndarray, tickets: Sequence[Ticket]) -> None:
    """Buffers formatted rows [k, R, w, 1] of one bucket width (aligned
    with tickets) and runs every pack whose slots now fill exactly."""
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

  def _plan(self, allow_partial: bool) -> Optional[List[Tuple[int, int, int]]]:
    """Greedy largest-first slot plan: [(slot, offset, width), ...] in
    per-width FIFO order, or None when the slots cannot all be filled
    exactly (and partial packs are not allowed). With the divisibility
    chain, any remaining slot capacity is a multiple of every smaller
    bucket, so largest-first never strands capacity a different order
    could have filled."""
    counts = {w: len(q) for w, q in self._queues.items()}
    plan: List[Tuple[int, int, int]] = []
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
        counts[width] -= 1
        plan.append((slot, self._slot_len - remaining, width))
        remaining -= width
      if allow_partial and not any(counts.values()):
        break
    return plan

  def _cut_packs(self, flush: bool) -> None:
    while True:
      plan = self._plan(allow_partial=False)
      if plan is None:
        break
      self._run(plan)
    while flush and self._buffered:
      self._run(self._plan(allow_partial=True))

  def _materialize(self, plan: List[Tuple[int, int, int]]):
    """Pops the planned windows: (pack [n_slots, R, slot_len, 1] f32,
    lengths [n_slots, wps] int32, placements [(ticket, slot, offset,
    width)])."""
    n_rows = self._queues[plan[0][2]][0][0].shape[0]
    pack = np.zeros((self._n_slots, n_rows, self._slot_len, 1),
                    dtype=np.float32)
    lengths = np.zeros((self._n_slots, self._wps), dtype=np.int32)
    slot_fill = [0] * self._n_slots
    placements = []
    for slot, off, width in plan:
      row, ticket = self._queues[width].popleft()
      pack[slot, :, off:off + width] = row
      lengths[slot, slot_fill[slot]] = width
      slot_fill[slot] += 1
      placements.append((ticket, slot, off, width))
    self._buffered -= len(placements)
    return pack, lengths, placements

  def _run(self, plan: List[Tuple[int, int, int]]) -> None:
    pack, lengths, placements = self._materialize(plan)
    self.n_packs += 1
    self.n_pack_rows += len(placements)
    # Unused position capacity in min-bucket units: the windows a full
    # pack of the same shape could additionally have carried.
    used = sum(p[3] for p in placements)
    self.n_pad_rows += (
        self._n_slots * self._slot_len - used) // self._buckets[0]
    ids, quals = self._runner.predict_ragged(pack, lengths)
    ids_u8 = ids.astype(np.uint8)
    quals_u8 = quals.astype(np.uint8)
    for ticket, slot, off, width in placements:
      self._deliver(ticket, ids_u8[slot, off:off + width],
                    quals_u8[slot, off:off + width])

  def flush(self) -> None:
    """Runs the buffered tail as final (zero-length-padded) packs."""
    self._cut_packs(flush=True)
