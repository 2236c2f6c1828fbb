"""Trace-file summarization: the analysis half of `cli trace`.

Port of deepconsensus_tpu/obs/summarize.py. Reads a Chrome-trace-event
file written by obs.trace and derives:

* per-stage time: total span duration and union-of-interval coverage
  per pipeline stage (featurize, pack_wait, h2d_transfer,
  device_compute, finalize_drain, stitch);
* critical-path attribution: each stage's coverage as a fraction of
  the end-to-end wall interval, largest first (stages overlap by
  design, so the fractions sum past 1.0 when the pipeline overlaps);
* straggler packs: the slowest decile of device_compute spans with
  their bucket and row count;
* a span-derived transfer-overlap fraction (a pack's device_compute
  starting before its own finalize_drain span was launched ahead of
  the drain);
* device gaps: the time between consecutive device_compute spans, and
  how much of it H2D copies cover.

The per-stage totals here and the ``stage_*_s`` histogram sums of the
run's MetricsRegistry come from the same intervals (obs.record_stage).
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Tuple

from deepconsensus_tpu_torch import faults as faults_lib
from deepconsensus_tpu_torch.obs import trace as trace_lib


def load_trace(path: str) -> List[Dict[str, Any]]:
  """Parses an obs.trace file into a list of event dicts."""
  events: List[Dict[str, Any]] = []
  try:
    with open(path, 'r', encoding='utf-8') as f:
      lines = f.readlines()
  except OSError as e:
    raise faults_lib.CorruptInputError(
        f'cannot read trace file {path}: {e}') from e
  for i, line in enumerate(lines, start=1):
    text = line.strip()
    if not text or text in ('[', ']'):
      continue
    if text.endswith(','):
      text = text[:-1]
    try:
      event = json.loads(text)
    except ValueError as e:
      raise faults_lib.CorruptInputError(
          f'{path}:{i}: undecodable trace event: {e}') from e
    if not isinstance(event, dict):
      raise faults_lib.CorruptInputError(
          f'{path}:{i}: trace event is not an object')
    events.append(event)
  return events


def _complete_spans(events: List[Dict[str, Any]]
                    ) -> List[Dict[str, Any]]:
  return [e for e in events if e.get('ph') == 'X']


def _union_s(intervals: List[Tuple[float, float]]) -> float:
  """Total length of the union of [start, end) intervals, in seconds
  (inputs in microseconds)."""
  if not intervals:
    return 0.0
  total = 0.0
  cur_lo, cur_hi = None, None
  for lo, hi in sorted(intervals):
    if cur_lo is None:
      cur_lo, cur_hi = lo, hi
    elif lo <= cur_hi:
      cur_hi = max(cur_hi, hi)
    else:
      total += cur_hi - cur_lo
      cur_lo, cur_hi = lo, hi
  total += cur_hi - cur_lo
  return total / 1e6


def tier_names(events: List[Dict[str, Any]]) -> Dict[int, str]:
  """pid -> tier label from process_name metadata events."""
  out: Dict[int, str] = {}
  for e in events:
    if e.get('ph') == 'M' and e.get('name') == 'process_name':
      out[int(e.get('pid', 0))] = str(
          (e.get('args') or {}).get('name', ''))
  return out


def trace_groups(events: List[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
  """trace_id -> {'pids': sorted pids, 'names': span names, 'n_spans'}.

  A run stamps one id on every span of its threads.
  """
  groups: Dict[str, Dict[str, Any]] = {}
  for e in _complete_spans(events):
    trace_id = (e.get('args') or {}).get('trace_id')
    if not trace_id:
      continue
    g = groups.setdefault(str(trace_id),
                          {'pids': set(), 'names': set(), 'n_spans': 0})
    g['pids'].add(int(e.get('pid', 0)))
    g['names'].add(str(e.get('name', '')))
    g['n_spans'] += 1
  return {
      tid: {'pids': sorted(g['pids']), 'names': sorted(g['names']),
            'n_spans': g['n_spans']}
      for tid, g in groups.items()
  }


def span_overlap(events: List[Dict[str, Any]]) -> Dict[str, Any]:
  """Span-derived transfer/compute overlap: per (pid, pack), the
  device_compute span starting strictly before its finalize_drain span
  means the launch was overlapped by a later dispatch."""
  compute_ts: Dict[Tuple[int, Any], float] = {}
  finalize_ts: Dict[Tuple[int, Any], float] = {}
  for e in _complete_spans(events):
    args = e.get('args') or {}
    if 'pack' not in args:
      continue
    key = (int(e.get('pid', 0)), args['pack'])
    if e.get('name') == trace_lib.STAGE_DEVICE_COMPUTE:
      compute_ts[key] = float(e['ts'])
    elif e.get('name') == trace_lib.STAGE_FINALIZE:
      finalize_ts[key] = float(e['ts'])
  n_overlapped = 0
  n_direct = 0
  for key, ts in compute_ts.items():
    fin = finalize_ts.get(key)
    if fin is None:
      # A pack with no finalize_drain span of its own (its drain was
      # not traced): its launch preceded any drain, so it overlapped.
      n_overlapped += 1
      continue
    if ts < fin:
      n_overlapped += 1
    else:
      n_direct += 1
  launches = n_overlapped + n_direct
  return {
      'n_packs': launches,
      'n_overlapped': n_overlapped,
      'n_direct': n_direct,
      'span_overlap_fraction': (
          round(n_overlapped / launches, 4) if launches else 0.0),
  }


def device_gaps(events: List[Dict[str, Any]]) -> Dict[str, Any]:
  """Host gaps between consecutive device_compute spans, per pid.

  Between pack N's compute and pack N+1's, the card should only be
  copying a later pack's uint8 planes in, so each gap should be covered
  by h2d_transfer spans. Uncovered time (host_gap_s) is host work on
  the critical path: pack assembly, triage, Python overhead.
  transfer_only_fraction is the covered share of all gap time (1.0
  when there are no gaps at all)."""
  compute: Dict[int, List[Tuple[float, float]]] = {}
  h2d: Dict[int, List[Tuple[float, float]]] = {}
  for e in _complete_spans(events):
    name = e.get('name')
    if name not in (trace_lib.STAGE_DEVICE_COMPUTE, trace_lib.STAGE_H2D):
      continue
    pid = int(e.get('pid', 0))
    ts = float(e['ts'])
    iv = (ts, ts + float(e.get('dur', 0.0)))
    (compute if name == trace_lib.STAGE_DEVICE_COMPUTE else h2d
     ).setdefault(pid, []).append(iv)
  n_gaps = 0
  gap_s = 0.0
  transfer_s = 0.0
  max_host_gap_s = 0.0
  for pid, intervals in compute.items():
    intervals.sort()
    transfers = h2d.get(pid, [])
    for (_lo_a, hi_a), (lo_b, _hi_b) in zip(intervals, intervals[1:]):
      if lo_b <= hi_a:
        continue  # overlapping/adjacent compute: no host gap at all
      n_gaps += 1
      gap = (lo_b - hi_a) / 1e6
      covered = _union_s([
          (max(lo, hi_a), min(hi, lo_b))
          for lo, hi in transfers if hi > hi_a and lo < lo_b])
      gap_s += gap
      transfer_s += covered
      max_host_gap_s = max(max_host_gap_s, gap - covered)
  host_gap_s = gap_s - transfer_s
  return {
      'n_gaps': n_gaps,
      'gap_s': round(gap_s, 6),
      'transfer_s': round(transfer_s, 6),
      'host_gap_s': round(host_gap_s, 6),
      'max_host_gap_s': round(max_host_gap_s, 6),
      'transfer_only_fraction': (
          round(transfer_s / gap_s, 4) if gap_s else 1.0),
  }


def summarize(events: List[Dict[str, Any]],
              straggler_decile: float = 0.9) -> Dict[str, Any]:
  """Full trace summary (the ``dctpu trace`` payload)."""
  spans = _complete_spans(events)
  if not spans:
    raise faults_lib.CorruptInputError(
        'trace contains no complete (ph=X) spans')
  t_min = min(float(e['ts']) for e in spans)
  t_max = max(float(e['ts']) + float(e.get('dur', 0.0)) for e in spans)
  wall_s = (t_max - t_min) / 1e6

  stage_totals: Dict[str, float] = {}
  stage_counts: Dict[str, int] = {}
  stage_intervals: Dict[str, List[Tuple[float, float]]] = {}
  for e in spans:
    if e.get('cat') != 'stage':
      continue
    name = str(e.get('name', ''))
    ts = float(e['ts'])
    dur = float(e.get('dur', 0.0))
    stage_totals[name] = stage_totals.get(name, 0.0) + dur / 1e6
    stage_counts[name] = stage_counts.get(name, 0) + 1
    stage_intervals.setdefault(name, []).append((ts, ts + dur))

  coverage = {name: _union_s(iv) for name, iv in stage_intervals.items()}
  critical_path = sorted(
      ({'stage': name,
        'coverage_s': round(cov, 6),
        'fraction_of_wall': round(cov / wall_s, 4) if wall_s else 0.0}
       for name, cov in coverage.items()),
      key=lambda row: -row['coverage_s'])

  compute_spans = sorted(
      (e for e in spans
       if e.get('name') == trace_lib.STAGE_DEVICE_COMPUTE),
      key=lambda e: float(e.get('dur', 0.0)))
  stragglers = []
  if compute_spans:
    cut = int(len(compute_spans) * straggler_decile)
    for e in compute_spans[cut:]:
      args = e.get('args') or {}
      stragglers.append({
          'pack': args.get('pack'),
          'dur_s': round(float(e.get('dur', 0.0)) / 1e6, 6),
          'bucket': args.get('bucket'),
          'dp': args.get('dp'),
          'n_rows': args.get('n_rows'),
          'pid': e.get('pid'),
      })
    stragglers.sort(key=lambda row: -row['dur_s'])

  return {
      'n_events': len(events),
      'n_spans': len(spans),
      'wall_s': round(wall_s, 6),
      'tiers': tier_names(events),
      'stage_totals_s': {k: round(v, 6)
                         for k, v in sorted(stage_totals.items())},
      'stage_counts': dict(sorted(stage_counts.items())),
      'stage_coverage_s': {k: round(v, 6)
                           for k, v in sorted(coverage.items())},
      'critical_path': critical_path,
      'stragglers': stragglers,
      'overlap': span_overlap(events),
      'device_gaps': device_gaps(events),
      'n_traces': len(trace_groups(events)),
  }


def format_summary(summary: Dict[str, Any]) -> str:
  """Human-readable rendering for the CLI."""
  lines = [
      f'trace: {summary["n_spans"]} spans over '
      f'{summary["wall_s"]:.3f}s wall',
  ]
  if summary.get('tiers'):
    tiers = ', '.join(f'{pid}={name}'
                      for pid, name in sorted(summary['tiers'].items()))
    lines.append(f'tiers: {tiers}')
  lines.append('per-stage breakdown (critical-path order):')
  totals = summary['stage_totals_s']
  counts = summary['stage_counts']
  for row in summary['critical_path']:
    stage = row['stage']
    lines.append(
        f'  {stage:<16} coverage {row["coverage_s"]:>10.4f}s '
        f'({100 * row["fraction_of_wall"]:5.1f}% of wall)  '
        f'total {totals.get(stage, 0.0):>10.4f}s  '
        f'n={counts.get(stage, 0)}')
  overlap = summary['overlap']
  lines.append(
      f'transfer overlap (span-derived): '
      f'{overlap["n_overlapped"]}/{overlap["n_packs"]} packs '
      f'(fraction {overlap["span_overlap_fraction"]})')
  gaps = summary.get('device_gaps')
  if gaps:
    lines.append(
        f'device gaps: {gaps["n_gaps"]} gaps totalling '
        f'{gaps["gap_s"]:.4f}s, host (non-transfer) '
        f'{gaps["host_gap_s"]:.4f}s, transfer-only fraction '
        f'{gaps["transfer_only_fraction"]} '
        f'(max host gap {gaps["max_host_gap_s"]:.4f}s)')
  if summary['stragglers']:
    lines.append('straggler packs (slowest decile of device compute):')
    for row in summary['stragglers'][:10]:
      lines.append(
          f'  pack {row["pack"]} {row["dur_s"]:.4f}s '
          f'bucket={row["bucket"]} dp={row["dp"]} '
          f'n_rows={row["n_rows"]} pid={row["pid"]}')
  if summary.get('n_traces'):
    lines.append(f'distinct request traces: {summary["n_traces"]}')
  return '\n'.join(lines)
