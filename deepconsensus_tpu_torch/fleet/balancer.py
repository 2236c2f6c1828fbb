"""Weighted least-loaded replica pick with bounded in-flight counts
and weighted-fair multi-tenant admission.

Port of deepconsensus_tpu/fleet/balancer.py: on the same probed
signals it picks the same replicas in the same order.

The placement score is work-per-capacity: (router in-flight + replica
queue depth) / mesh_dp, with a degraded replica (its mesh stepped down
a dp level but /readyz stays green) weighted at half capacity so the
healthy replicas absorb more of the load. queue_depth comes from the
registry's cached /metricz probe, in_flight is the router's own
ground truth — together they see both work this router placed and
work other routers/clients placed directly.

In-flight is bounded per replica at max_inflight * mesh_dp: one slow
replica saturates its own bound and the pick moves on; when every
eligible replica of the tier is at its bound the fleet is saturated
and the caller sheds with a typed FleetRejection (503, transient).

Multi-tenant QoS. Every acquire carries a priority class and a client
id; admission is two-layered:

  * per-client quota: a client already holding `client_quota`
    concurrent requests is shed with a typed QuotaExceededError (429,
    transient) before it can touch fleet capacity — one tenant's
    runaway concurrency is charged to that tenant alone.
  * weighted fair queueing: when every eligible replica is at its
    in-flight bound, acquirers wait (bounded by queue_wait_s) in
    start-time-fair-queueing order. Each waiter gets a virtual finish
    time vft = max(tier virtual time, its class's last vft) +
    1/weight, and a freed slot goes to the smallest vft that can
    actually place (a waiter whose exclusions block it does not
    head-of-line-block the rest). A saturating weight-1 bulk stream
    therefore cannot starve a weight-4 interactive trickle: the
    interactive waiter's vft lands ahead of the queued bulk backlog,
    so it is served within about one slot turnover. Per-class queue
    depth is bounded (max_queued_per_class); the class that overflows
    its own queue is the class that sheds — a typed FleetRejection
    naming the class, never a penalty on the others.

With queue_wait_s=0 (the construction default) admission never waits
and the balancer behaves exactly as before QoS existed: a saturated
acquire sheds immediately with the tier-level FleetRejection.

acquire() and its in-flight increment are one atomic step under the
registry lock (the QoS condition variable wraps the same lock): two
handler threads can't both claim the last slot.
"""
from __future__ import annotations

import bisect
import dataclasses
import threading
import time
from typing import Any, Dict, Iterable, Optional

from deepconsensus_tpu_torch import faults as shared_faults
from deepconsensus_tpu_torch.fleet import registry as registry_lib

# Priority-class defaults: unlabeled traffic is interactive (old
# clients predate classes and are human-facing); bulk backfill must
# label itself to get bulk treatment.
DEFAULT_CLASS = 'interactive'
DEFAULT_CLASS_WEIGHTS: Dict[str, float] = {'interactive': 4.0, 'bulk': 1.0}


class _Waiter:
  """One parked acquire: its WFQ finish time plus what it needs to
  place. Ordered by (vft, seq) — seq breaks ties FIFO."""

  __slots__ = ('vft', 'seq', 'klass', 'excluded')

  def __init__(self, vft: float, seq: int, klass: str, excluded: set):
    self.vft = vft
    self.seq = seq
    self.klass = klass
    self.excluded = excluded

  def __lt__(self, other: '_Waiter') -> bool:
    return (self.vft, self.seq) < (other.vft, other.seq)


class LeastLoadedBalancer:

  def __init__(self, registry: registry_lib.ReplicaRegistry,
               max_inflight: int = 8,
               class_weights: Optional[Dict[str, float]] = None,
               default_class: str = DEFAULT_CLASS,
               client_quota: int = 0,
               queue_wait_s: float = 0.0,
               max_queued_per_class: int = 16):
    self._registry = registry
    self.max_inflight = max_inflight
    self.class_weights = dict(class_weights or DEFAULT_CLASS_WEIGHTS)
    self.default_class = default_class
    self.client_quota = client_quota
    self.queue_wait_s = queue_wait_s
    self.max_queued_per_class = max_queued_per_class
    # QoS state shares the registry lock (the condition wraps it), so
    # a grant and its in-flight/accounting increments stay one atomic
    # step with the replica pick.
    self._cond = threading.Condition(registry.lock)
    self._waiters: Dict[str, list] = {}  # guarded by: self._registry.lock
    self._vtime: Dict[str, float] = {}  # guarded by: self._registry.lock
    self._last_vft: Dict[Any, float] = {}  # guarded by: self._registry.lock
    self._class_inflight: Dict[str, int] = {}  # guarded by: self._registry.lock
    self._client_inflight: Dict[str, int] = {}  # guarded by: self._registry.lock
    self._seq = 0  # guarded by: self._registry.lock

  def weight(self, klass: str) -> float:
    return max(0.001, float(self.class_weights.get(klass, 1.0)))

  def _bound(self, replica: registry_lib.Replica) -> int:
    return self.max_inflight * max(1, replica.mesh_dp)

  def _score(self, replica: registry_lib.Replica) -> float:
    weight = max(1, replica.mesh_dp) * (0.5 if replica.degraded else 1.0)
    return (replica.in_flight + replica.queue_depth) / weight

  # -- placement ---------------------------------------------------------

  def _try_pick(self, tier: str,
                excluded: set) -> Optional[registry_lib.Replica]:
    """The least-loaded READY open-slot replica, or None. Caller holds
    the registry lock; the returned replica is the LIVE object (the
    caller claims its slot under the same lock hold)."""
    open_slots = [
        r for r in self._registry._replicas.values()
        if r.tier == tier and r.state == registry_lib.ReplicaState.READY
        and r.url not in excluded and r.in_flight < self._bound(r)
    ]
    if not open_slots:
      return None
    return min(open_slots, key=lambda r: (self._score(r), r.url))

  def _saturation_error(self, tier: str,
                        excluded: set) -> shared_faults.FleetRejection:
    """The typed rejection for an acquire that cannot place (and, with
    queue_wait_s=0, will not wait). Caller holds the registry lock."""
    tier_members = [
        r for r in self._registry._replicas.values() if r.tier == tier
    ]
    if not tier_members:
      return shared_faults.FleetRejection(
          f'no {tier} replicas registered')
    candidates = [
        r for r in tier_members
        if r.state == registry_lib.ReplicaState.READY
        and r.url not in excluded
    ]
    if not candidates:
      return shared_faults.FleetRejection(
          f'no {tier} replica is ready '
          f'({self._describe(tier_members, excluded)})')
    return shared_faults.FleetRejection(
        f'all {len(candidates)} ready {tier} replica(s) are at '
        f'their in-flight bound (max_inflight={self.max_inflight} '
        'per dp)')

  def _grant(self, replica: registry_lib.Replica, klass: str,
             client: Optional[str]) -> registry_lib.Replica:
    """Claims one slot + the class/client accounting. Caller holds the
    registry lock and passes the live replica object."""
    replica.in_flight += 1
    replica.n_routed += 1
    self._class_inflight[klass] = self._class_inflight.get(klass, 0) + 1
    if client is not None:
      self._client_inflight[client] = (
          self._client_inflight.get(client, 0) + 1)
    return dataclasses.replace(replica)

  # -- admission ---------------------------------------------------------

  def acquire(self, tier: str, exclude: Iterable[str] = (),
              klass: Optional[str] = None,
              client: Optional[str] = None) -> registry_lib.Replica:
    """Picks the least-loaded READY replica of `tier` (skipping urls in
    `exclude` — the retry path never re-picks a replica it already
    tried) and claims one in-flight slot on it, charging the slot to
    `klass`/`client`. Raises QuotaExceededError when the client is at
    its quota, and FleetRejection when no replica is eligible — after
    a weighted-fair wait of up to queue_wait_s when waiting is on."""
    excluded = set(exclude)
    klass = klass or self.default_class
    with self._cond:
      if client is not None and self.client_quota > 0:
        if self._client_inflight.get(client, 0) >= self.client_quota:
          raise shared_faults.QuotaExceededError(
              f'client {client!r} is at its quota of '
              f'{self.client_quota} concurrent request(s)')
      queue = self._waiters.setdefault(tier, [])
      if not queue:
        replica = self._try_pick(tier, excluded)
        if replica is not None:
          return self._grant(replica, klass, client)
      if self.queue_wait_s <= 0:
        # dclint: allow=typed-faults (_saturation_error builds a typed
        # FleetRejection — the helper exists so the wait path below can
        # reuse the same message taxonomy)
        raise self._saturation_error(tier, excluded)
      if sum(1 for w in queue if w.klass == klass) >= \
          self.max_queued_per_class:
        raise shared_faults.FleetRejection(
            f'{tier} tier: class {klass!r} admission queue is full '
            f'({self.max_queued_per_class} waiting) — shedding the '
            'overflowing class only')
      self._seq += 1
      vft = max(self._vtime.get(tier, 0.0),
                self._last_vft.get((tier, klass), 0.0)
                ) + 1.0 / self.weight(klass)
      self._last_vft[(tier, klass)] = vft
      waiter = _Waiter(vft, self._seq, klass, excluded)
      bisect.insort(queue, waiter)
      deadline = time.monotonic() + self.queue_wait_s
      try:
        while True:
          replica = self._try_pick(tier, excluded)
          if replica is not None and not any(
              w is not waiter and w < waiter
              and self._try_pick(tier, w.excluded) is not None
              for w in queue):
            # Smallest placeable vft: take the slot and advance the
            # tier's virtual clock to this grant.
            queue.remove(waiter)
            self._vtime[tier] = max(self._vtime.get(tier, 0.0), vft)
            return self._grant(replica, klass, client)
          remaining = deadline - time.monotonic()
          if remaining <= 0:
            queue.remove(waiter)
            raise shared_faults.FleetRejection(
                f'{tier} tier saturated: class {klass!r} request shed '
                f'after a {self.queue_wait_s:.1f}s weighted-fair wait')
          # Short recheck period: replica state also changes on probe
          # cycles, which don't notify the condition.
          self._cond.wait(timeout=min(remaining, 0.05))
      except BaseException:
        if waiter in queue:
          queue.remove(waiter)
        raise

  def release(self, url: str, outcome: str,
              klass: Optional[str] = None,
              client: Optional[str] = None) -> None:
    """Returns a slot and its class/client accounting. outcome: 'ok' |
    'reject' (upstream typed 4xx/5xx rejection) | 'send_failure'
    (never acked) | 'lost' (acked, replica died)."""
    klass = klass or self.default_class
    with self._cond:
      replica = self._registry._replicas.get(url)
      if replica is not None:
        replica.in_flight = max(0, replica.in_flight - 1)
        if outcome == 'ok':
          replica.n_ok += 1
        elif outcome == 'reject':
          replica.n_upstream_rejects += 1
        elif outcome == 'send_failure':
          replica.n_send_failures += 1
        elif outcome == 'lost':
          replica.n_lost += 1
      held = self._class_inflight.get(klass, 0)
      if held > 0:
        self._class_inflight[klass] = held - 1
      if client is not None:
        held = self._client_inflight.get(client, 0)
        if held <= 1:
          self._client_inflight.pop(client, None)
        else:
          self._client_inflight[client] = held - 1
      self._cond.notify_all()

  # -- views -------------------------------------------------------------

  def qos_snapshot(self) -> Dict[str, Any]:
    """The admission-policy view the router's /metricz publishes."""
    with self._registry.lock:
      return {
          'class_weights': dict(self.class_weights),
          'default_class': self.default_class,
          'client_quota': self.client_quota,
          'queue_wait_s': self.queue_wait_s,
          'max_queued_per_class': self.max_queued_per_class,
          'class_in_flight': {
              k: v for k, v in sorted(self._class_inflight.items()) if v
          },
          'queued': {
              tier: len(q) for tier, q in self._waiters.items() if q
          },
          'clients_in_flight': len(self._client_inflight),
      }

  @staticmethod
  def _describe(members, excluded) -> str:
    parts = []
    for r in members:
      note = ' (excluded)' if r.url in excluded else ''
      parts.append(f'{r.url}={r.state}{note}')
    return ', '.join(sorted(parts))
