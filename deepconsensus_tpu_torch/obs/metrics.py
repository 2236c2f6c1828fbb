"""Metrics registry: typed counters and gauges, and fixed-bucket
histograms.

Port of deepconsensus_tpu/obs/metrics.py. One ``MetricsRegistry`` per
run (``ModelRunner.obs``) receives every stage interval that
``obs.record_stage`` records, so a stage's span-duration total in a
trace and its histogram ``sum`` come from the same measured interval.

* ``counter`` is a monotone int, ``gauge`` a settable float,
  ``histogram`` a fixed-bucket distribution with per-bucket counts and
  an exact running sum.
* Percentiles are nearest rank on the histogram: p(q) is the upper
  bound of the first bucket whose cumulative count reaches
  ``ceil(q * n)``.
* One registry lock guards the name -> metric maps and every metric's
  cells.
* ``to_prom`` renders Prometheus text exposition (``_bucket`` /
  ``_sum`` / ``_count`` with cumulative ``le`` labels).

Nothing here imports torch or numpy.
"""
from __future__ import annotations

import math
import re
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

# Default latency bucket upper bounds (seconds): roughly geometric from
# 1 ms to 600 s. A +Inf bucket is implicit.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 25.0, 60.0, 120.0, 300.0, 600.0)

_PROM_NAME_RE = re.compile(r'[^a-zA-Z0-9_:]')


def _prom_name(name: str) -> str:
  return _PROM_NAME_RE.sub('_', name)


def prom_counters_text(counters: Dict[str, Any], tier: str = '') -> str:
  """Renders a plain numeric counter dict (a run's sidecar counters:
  quarantine, faults, packs) as untyped Prometheus samples."""
  label = f'{{tier="{tier}"}}' if tier else ''
  lines: List[str] = []
  for name in sorted(counters):
    value = counters[name]
    if isinstance(value, bool) or not isinstance(value, (int, float)):
      continue
    lines.append(f'{_prom_name(f"dctpu_{name}")}{label} {value}')
  return '\n'.join(lines) + ('\n' if lines else '')


class Counter:
  """Monotone integer counter. Mutate via inc() only."""

  __slots__ = ('name', 'help', '_lock', '_value')

  def __init__(self, name: str, lock: threading.Lock, help: str = ''):
    self.name = name
    self.help = help
    self._lock = lock
    self._value = 0  # guarded by: self._lock

  def inc(self, n: int = 1) -> None:
    with self._lock:
      self._value += n

  @property
  def value(self) -> int:
    with self._lock:
      return self._value


class Gauge:
  """Point-in-time float value (queue depth, overlap fraction, ...)."""

  __slots__ = ('name', 'help', '_lock', '_value')

  def __init__(self, name: str, lock: threading.Lock, help: str = ''):
    self.name = name
    self.help = help
    self._lock = lock
    self._value = 0.0  # guarded by: self._lock

  def set(self, value: float) -> None:
    with self._lock:
      self._value = float(value)

  @property
  def value(self) -> float:
    with self._lock:
      return self._value


class Histogram:
  """Fixed-bucket distribution with exact running sum.

  ``bounds`` are the bucket upper edges (an implicit +Inf bucket
  catches the overflow). observe() is O(log n_buckets).
  """

  __slots__ = ('name', 'help', 'bounds', '_lock', '_counts', '_sum',
               '_count')

  def __init__(self, name: str, lock: threading.Lock,
               bounds: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
               help: str = ''):
    self.name = name
    self.help = help
    self.bounds: Tuple[float, ...] = tuple(sorted(float(b) for b in bounds))
    if not self.bounds:
      raise ValueError(f'histogram {name!r} needs at least one bucket')
    self._lock = lock
    self._counts = [0] * (len(self.bounds) + 1)  # guarded by: self._lock
    self._sum = 0.0  # guarded by: self._lock
    self._count = 0  # guarded by: self._lock

  def observe(self, value: float) -> None:
    value = float(value)
    lo, hi = 0, len(self.bounds)
    while lo < hi:
      mid = (lo + hi) // 2
      if value <= self.bounds[mid]:
        hi = mid
      else:
        lo = mid + 1
    with self._lock:
      self._counts[lo] += 1
      self._sum += value
      self._count += 1

  def percentile(self, q: float) -> Optional[float]:
    """Nearest-rank percentile: the upper edge of the first bucket
    whose cumulative count reaches ceil(q * n). None when empty."""
    with self._lock:
      total = self._count
      counts = list(self._counts)
    if not total:
      return None
    rank = max(1, math.ceil(q * total))
    cum = 0
    for i, c in enumerate(counts):
      cum += c
      if cum >= rank:
        if i < len(self.bounds):
          return self.bounds[i]
        return self.bounds[-1]  # +Inf bucket: report the last edge
    return self.bounds[-1]

  def snapshot(self) -> Dict[str, Any]:
    with self._lock:
      counts = list(self._counts)
      total = self._count
      total_sum = self._sum
    return {
        'count': total,
        'sum': round(total_sum, 6),
        'buckets': [[self.bounds[i] if i < len(self.bounds) else 'inf',
                     counts[i]] for i in range(len(counts))],
    }

  def percentiles(self) -> Dict[str, Any]:
    p50 = self.percentile(0.50)
    p99 = self.percentile(0.99)
    with self._lock:
      n = self._count
    return {
        'p50': None if p50 is None else round(p50, 4),
        'p99': None if p99 is None else round(p99, 4),
        'count': n,
    }


class MetricsRegistry:
  """Name -> metric map shared by one tier process.

  Accessors create-on-first-use so instrumentation sites need no
  registration ceremony; convenience ``inc``/``set_gauge``/``observe``
  cover the common one-shot paths. snapshot()/to_prom() render the
  whole registry as a plain dict and as Prometheus text.
  """

  def __init__(self, tier: str = ''):
    self.tier = tier
    self._lock = threading.Lock()
    self._counters: Dict[str, Counter] = {}  # guarded by: self._lock
    self._gauges: Dict[str, Gauge] = {}  # guarded by: self._lock
    self._histograms: Dict[str, Histogram] = {}  # guarded by: self._lock

  # -- accessors ---------------------------------------------------------

  def counter(self, name: str, help: str = '') -> Counter:
    with self._lock:
      metric = self._counters.get(name)
      if metric is None:
        metric = Counter(name, self._lock, help=help)
        self._counters[name] = metric
      return metric

  def gauge(self, name: str, help: str = '') -> Gauge:
    with self._lock:
      metric = self._gauges.get(name)
      if metric is None:
        metric = Gauge(name, self._lock, help=help)
        self._gauges[name] = metric
      return metric

  def histogram(self, name: str,
                bounds: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                help: str = '') -> Histogram:
    with self._lock:
      metric = self._histograms.get(name)
    if metric is None:
      # Constructed outside the lock (Histogram.__init__ validates and
      # may raise); the double-checked insert below keeps first-wins.
      candidate = Histogram(name, self._lock, bounds=bounds, help=help)
      with self._lock:
        metric = self._histograms.setdefault(name, candidate)
    return metric

  # -- one-shot mutation helpers ----------------------------------------

  def inc(self, name: str, n: int = 1) -> None:
    self.counter(name).inc(n)

  def set_gauge(self, name: str, value: float) -> None:
    self.gauge(name).set(value)

  def observe(self, name: str, value: float,
              bounds: Sequence[float] = DEFAULT_LATENCY_BUCKETS) -> None:
    self.histogram(name, bounds=bounds).observe(value)

  # -- views -------------------------------------------------------------

  def counter_values(self) -> Dict[str, int]:
    with self._lock:
      metrics = list(self._counters.values())
    return {m.name: m.value for m in metrics}

  def snapshot(self) -> Dict[str, Any]:
    """Plain-dict view of the whole registry."""
    with self._lock:
      counters = list(self._counters.values())
      gauges = list(self._gauges.values())
      histograms = list(self._histograms.values())
    return {
        'counters': {m.name: m.value for m in counters},
        'gauges': {m.name: round(m.value, 6) for m in gauges},
        'histograms': {m.name: m.snapshot() for m in histograms},
    }

  def latency_summary(self) -> Dict[str, Dict[str, Any]]:
    """Per-histogram nearest-rank percentiles."""
    with self._lock:
      histograms = list(self._histograms.values())
    return {m.name: m.percentiles() for m in histograms}

  def to_prom(self, tier: Optional[str] = None) -> str:
    """Prometheus text exposition (v0.0.4) of the whole registry."""
    tier = tier if tier is not None else self.tier
    label = f'{{tier="{tier}"}}' if tier else ''
    lines: List[str] = []
    with self._lock:
      counters = list(self._counters.values())
      gauges = list(self._gauges.values())
      histograms = list(self._histograms.values())
    for m in sorted(counters, key=lambda m: m.name):
      name = _prom_name(f'dctpu_{m.name}')
      if m.help:
        lines.append(f'# HELP {name} {m.help}')
      lines.append(f'# TYPE {name} counter')
      lines.append(f'{name}{label} {m.value}')
    for m in sorted(gauges, key=lambda m: m.name):
      name = _prom_name(f'dctpu_{m.name}')
      if m.help:
        lines.append(f'# HELP {name} {m.help}')
      lines.append(f'# TYPE {name} gauge')
      lines.append(f'{name}{label} {m.value}')
    for m in sorted(histograms, key=lambda m: m.name):
      name = _prom_name(f'dctpu_{m.name}')
      snap = m.snapshot()
      if m.help:
        lines.append(f'# HELP {name} {m.help}')
      lines.append(f'# TYPE {name} histogram')
      cum = 0
      for le, count in snap['buckets']:
        cum += count
        le_txt = '+Inf' if le == 'inf' else repr(float(le))
        if tier:
          lines.append(f'{name}_bucket{{tier="{tier}",le="{le_txt}"}} {cum}')
        else:
          lines.append(f'{name}_bucket{{le="{le_txt}"}} {cum}')
      lines.append(f'{name}_sum{label} {snap["sum"]}')
      lines.append(f'{name}_count{label} {snap["count"]}')
    return '\n'.join(lines) + '\n'
