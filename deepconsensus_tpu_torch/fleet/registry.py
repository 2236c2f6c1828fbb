"""Replica registry: health-gated membership for the fleet tier.

Port of deepconsensus_tpu/fleet/registry.py.

A replica (model or featurize) joins in state JOINING and receives no
traffic until a /readyz probe succeeds — registration is an intent,
health is earned. The probe thread then keeps per-replica balancing
signals fresh from endpoints the serve stack already exposes:

  /readyz   ready/draining + capacity (mesh_dp, degraded): a replica
            answering 503 with draining=true goes to DRAINING and gets
            no new work while it finishes its admitted requests — the
            rolling-restart handshake.
  /metricz  outstanding (queue depth), transfer_overlap_fraction, and
            the full unified counter split, cached per replica so the
            router's /metricz can aggregate the fleet without fanning
            out a probe per scrape.

Connection-level probe failures accumulate; dead_after consecutive
failures park the replica in DEAD. DEAD replicas keep being probed —
a restarted replica on the same address heals back to READY, so a
static fleet config survives rolling restarts.

Healing has hysteresis: after a DEAD verdict, READY requires
ready_after CONSECUTIVE healthy probes (any missed probe resets the
streak). A replica flapping between alive and dead therefore never
re-enters the balancer's candidate set mid-flap — without the streak
requirement a flapper would thrash the balancer, absorbing a request
on each one-probe revival and losing it on the next flap.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional
from urllib.parse import urlsplit

from deepconsensus_tpu_torch.serve.client import ServeClient

MODEL_TIER = 'model'
FEATURIZE_TIER = 'featurize'
TIERS = (MODEL_TIER, FEATURIZE_TIER)


class ReplicaState:
  JOINING = 'joining'      # registered, no successful probe yet
  READY = 'ready'          # probed healthy: eligible for new work
  DRAINING = 'draining'    # answered /readyz 503 draining: no new work
  DEAD = 'dead'            # unreachable; still probed for revival

  ALL = (JOINING, READY, DRAINING, DEAD)


@dataclasses.dataclass
class Replica:
  """One fleet member and its latest probed signals. Mutable fields
  are owned by ReplicaRegistry._lock (see registry docstring); the
  snapshots handed out by snapshot()/eligible() are copies."""

  url: str
  tier: str = MODEL_TIER
  state: str = ReplicaState.JOINING
  mesh_dp: int = 1
  degraded: bool = False
  queue_depth: int = 0
  overlap_fraction: float = 0.0
  in_flight: int = 0
  probe_failures: int = 0
  # Probe hysteresis: healing=True after a DEAD verdict until the
  # replica earns ready_after consecutive healthy probes; heal_streak
  # counts them (reset by any missed probe).
  healing: bool = False
  heal_streak: int = 0
  last_probe_s: float = 0.0
  n_routed: int = 0
  n_ok: int = 0
  n_upstream_rejects: int = 0
  n_send_failures: int = 0
  n_lost: int = 0
  counters: Dict[str, Any] = dataclasses.field(default_factory=dict)

  @property
  def host_port(self):
    parts = urlsplit(self.url if '//' in self.url else f'//{self.url}')
    return parts.hostname or '127.0.0.1', parts.port or 80


class ReplicaRegistry:
  """Membership + probe loop. All replica mutation happens under one
  lock; the balancer shares it (via the `lock` property) so a pick and
  its in-flight increment are one atomic step."""

  def __init__(self, probe_interval_s: float = 0.5,
               probe_timeout_s: float = 5.0, dead_after: int = 3,
               ready_after: int = 2):
    self.probe_interval_s = probe_interval_s
    self.probe_timeout_s = probe_timeout_s
    self.dead_after = dead_after
    self.ready_after = max(1, ready_after)
    self._lock = threading.Lock()
    self._replicas: Dict[str, Replica] = {}  # guarded by: self._lock
    self._stop = threading.Event()
    self._thread: Optional[threading.Thread] = None  # dclint: lock-free
    # (written once by start(), read by stop(); both run on the
    # lifecycle thread — the prober itself never touches it)

  @property
  def lock(self) -> threading.Lock:
    return self._lock

  # -- membership --------------------------------------------------------

  def add(self, url: str, tier: str = MODEL_TIER) -> Replica:
    """Registers a replica in JOINING (health-gated: it becomes
    eligible only after a successful probe). Re-registering a known
    url resets its probe state — the rolling-restart rejoin path."""
    if tier not in TIERS:
      # dclint: allow=typed-faults (operator/config validation at the
      # registration boundary, surfaced as a 400 by the router)
      raise ValueError(f'unknown tier {tier!r}: must be one of {TIERS}')
    url = url.rstrip('/')
    with self._lock:
      replica = self._replicas.get(url)
      if replica is None or replica.tier != tier:
        replica = Replica(url=url, tier=tier)
        self._replicas[url] = replica
      else:
        replica.state = ReplicaState.JOINING
        replica.probe_failures = 0
        # Explicit re-registration is operator intent (rolling-restart
        # rejoin): it clears the hysteresis debt a DEAD spell accrued.
        replica.healing = False
        replica.heal_streak = 0
      return dataclasses.replace(replica)

  def remove(self, url: str) -> bool:
    with self._lock:
      return self._replicas.pop(url.rstrip('/'), None) is not None

  def urls(self) -> List[str]:
    with self._lock:
      return sorted(self._replicas)

  # -- probing -----------------------------------------------------------

  def start(self) -> None:
    self._thread = threading.Thread(
        target=self._probe_loop, name='dctpu-route-probe', daemon=True)
    self._thread.start()

  def stop(self) -> None:
    self._stop.set()
    if self._thread is not None:
      self._thread.join(timeout=self.probe_timeout_s + 1)

  def _probe_loop(self) -> None:
    while not self._stop.wait(timeout=self.probe_interval_s):
      self.probe_all()

  def probe_all(self) -> None:
    with self._lock:
      targets = [(r.url, r.host_port) for r in self._replicas.values()]
    for url, (host, port) in targets:
      self._probe_one(url, host, port)

  def _probe_one(self, url: str, host: str, port: int) -> None:
    client = ServeClient(host, port, timeout=self.probe_timeout_s)
    try:
      ready = client.readyz()
      stats = client.metricz()
    # dclint: allow=typed-faults (probe transport failure IS the
    # signal: it increments probe_failures and drives the replica to
    # DEAD below — routing, not swallowing)
    except Exception:  # noqa: BLE001 - any transport failure = missed probe
      with self._lock:
        replica = self._replicas.get(url)
        if replica is None:
          return
        replica.probe_failures += 1
        replica.last_probe_s = time.monotonic()
        replica.heal_streak = 0  # any missed probe breaks the streak
        if replica.probe_failures >= self.dead_after:
          replica.state = ReplicaState.DEAD
          replica.healing = True
      return
    with self._lock:
      replica = self._replicas.get(url)
      if replica is None:
        return  # removed while probing
      replica.probe_failures = 0
      replica.last_probe_s = time.monotonic()
      replica.mesh_dp = int(ready.get('mesh_dp', 0) or 1)
      replica.degraded = bool(ready.get('degraded', False))
      replica.queue_depth = int(stats.get('outstanding', 0) or 0)
      counters = stats.get('counters', {})
      replica.overlap_fraction = float(
          counters.get('transfer_overlap_fraction', 0.0) or 0.0)
      replica.counters = {
          k: v for k, v in counters.items() if isinstance(v, (int, float))
      }
      if ready.get('ready'):
        if replica.healing:
          # Hysteresis: a replica coming back from DEAD must answer
          # ready_after consecutive healthy probes before it re-enters
          # the candidate set — one good probe from a flapper is noise.
          replica.heal_streak += 1
          if replica.heal_streak >= self.ready_after:
            replica.healing = False
            replica.heal_streak = 0
            replica.state = ReplicaState.READY
          else:
            replica.state = ReplicaState.JOINING
        else:
          replica.state = ReplicaState.READY
      elif ready.get('draining'):
        replica.heal_streak = 0
        replica.state = ReplicaState.DRAINING
      else:
        # Alive but not ready (warming after restart): back to the
        # health gate; no new work until /readyz goes green.
        replica.heal_streak = 0
        replica.state = ReplicaState.JOINING

  # -- router-observed events -------------------------------------------

  def mark_unreachable(self, url: str) -> None:
    """The router saw a connection-level failure: park the replica in
    DEAD immediately instead of waiting out dead_after probe cycles
    (the probe loop revives it when it answers again)."""
    with self._lock:
      replica = self._replicas.get(url)
      if replica is not None:
        replica.probe_failures = max(replica.probe_failures,
                                     self.dead_after)
        replica.state = ReplicaState.DEAD
        replica.healing = True
        replica.heal_streak = 0

  def mark_draining(self, url: str) -> None:
    """The router saw a draining 503 from this replica before the next
    probe cycle would have: stop sending it new work now."""
    with self._lock:
      replica = self._replicas.get(url)
      if replica is not None and replica.state == ReplicaState.READY:
        replica.state = ReplicaState.DRAINING

  # -- views -------------------------------------------------------------

  def snapshot(self) -> List[Replica]:
    with self._lock:
      return [dataclasses.replace(r) for r in self._replicas.values()]

  def tier_states(self) -> Dict[str, Dict[str, int]]:
    """{tier: {state: count}} for /readyz."""
    out: Dict[str, Dict[str, int]] = {t: {} for t in TIERS}
    for replica in self.snapshot():
      states = out.setdefault(replica.tier, {})
      states[replica.state] = states.get(replica.state, 0) + 1
    return out

  def aggregate_counters(self) -> Dict[str, Any]:
    """Sum of every numeric counter across the latest cached /metricz
    of all replicas (fractions are averaged over replicas reporting
    them) — the fleet-wide view the router's /metricz publishes."""
    totals: Dict[str, float] = {}
    fractions: Dict[str, List[float]] = {}
    for replica in self.snapshot():
      for key, value in replica.counters.items():
        if key.endswith('_fraction') or key.endswith('_s'):
          fractions.setdefault(key, []).append(float(value))
        else:
          totals[key] = totals.get(key, 0) + value
    out: Dict[str, Any] = dict(totals)
    for key, values in fractions.items():
      out[key] = round(sum(values) / len(values), 4)
    return out
