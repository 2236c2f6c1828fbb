"""Observability of `run` and `serve`: metrics registry, trace spans,
trace summarization and, in obs/profiler.py, the on-demand
torch.profiler capture (port of deepconsensus_tpu/obs).

``record_stage`` is the helper every instrumentation site calls: it
feeds the same measured interval to the stage histogram
(``stage_<name>_s`` on the run's MetricsRegistry) and to the trace
span, so span totals and histogram sums reconcile by construction.
"""
from __future__ import annotations

from typing import Any, Optional

from deepconsensus_tpu_torch.obs import metrics
from deepconsensus_tpu_torch.obs import summarize
from deepconsensus_tpu_torch.obs import trace
from deepconsensus_tpu_torch.obs.metrics import (DEFAULT_LATENCY_BUCKETS,
                                                 MetricsRegistry)


def stage_histogram_name(stage: str) -> str:
  return f'stage_{stage}_s'


def record_stage(registry: Optional[MetricsRegistry], stage: str,
                 t0: float, t1: float, **args: Any) -> None:
  """Records one pipeline-stage interval [t0, t1] (time.time() stamps)
  as a histogram observation and a trace span."""
  if registry is not None:
    registry.observe(stage_histogram_name(stage), t1 - t0)
  trace.complete_event(stage, 'stage', t0, t1, args)


__all__ = [
    'DEFAULT_LATENCY_BUCKETS',
    'MetricsRegistry',
    'metrics',
    'record_stage',
    'stage_histogram_name',
    'summarize',
    'trace',
]
