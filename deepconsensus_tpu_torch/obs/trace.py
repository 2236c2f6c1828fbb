"""Structured trace spans: Chrome-trace-event JSONL.

Port of deepconsensus_tpu/obs/trace.py. A traced `run` writes one span
per featurize batch, per pack (pack_wait, h2d_transfer, device_compute,
finalize_drain) and per emitted batch (stitch), each stamped with the
run's trace id; dead letters carry the same id. Load the file into
Perfetto or chrome://tracing, or summarize it with `cli trace`.

File format. Chrome's JSON trace format tolerates a missing closing
``]`` and a trailing comma, so the file is a ``[`` header line and one
complete-event object per line, each ending ``,``. Each line is one
O_APPEND write, so several processes can share one file: the process
that wins the O_CREAT|O_EXCL race writes the header, every other
writer only appends.

Tracing is on when ``DCTPU_TRACE=<path>`` is set (`cli run --trace`
sets it) or after ``configure(path)``. Off, ``enabled()`` is one
module-global ``is None`` check and ``complete_event`` returns at once.

Timestamps are wall-clock microseconds (``time.time()``). The card's
spans (h2d_transfer, device_compute) come from the CUDA events each
pack records, placed on this clock through one anchor event recorded
with a host timestamp (inference/runner.py), so they show when the
card worked, not when the host waited.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Any, Dict, Iterator, Optional

ENV_TRACE = 'DCTPU_TRACE'

# Stage-span names; their `cat` is 'stage'.
STAGE_FEATURIZE = 'featurize'
STAGE_PACK_WAIT = 'pack_wait'
STAGE_H2D = 'h2d_transfer'
STAGE_DEVICE_COMPUTE = 'device_compute'
STAGE_FINALIZE = 'finalize_drain'
STAGE_STITCH = 'stitch'
STAGES = (STAGE_FEATURIZE, STAGE_PACK_WAIT, STAGE_H2D,
          STAGE_DEVICE_COMPUTE, STAGE_FINALIZE, STAGE_STITCH)


class TraceWriter:
  """Appends Chrome trace events to one (possibly shared) file."""

  def __init__(self, path: str, tier: str = ''):
    self.path = path
    self.tier = tier
    self._lock = threading.Lock()
    self._pid = os.getpid()
    try:
      # Exactly one process wins the create and owns the `[` header;
      # everyone else appends events only.
      fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o644)
      try:
        os.write(fd, b'[\n')
      finally:
        os.close(fd)
    except FileExistsError:
      pass
    self._fd = os.open(path, os.O_WRONLY | os.O_APPEND)  # guarded by: self._lock
    if tier:
      self._emit_raw({
          'name': 'process_name', 'ph': 'M', 'pid': self._pid, 'tid': 0,
          'args': {'name': f'dctpu-{tier}'},
      })

  def _emit_raw(self, event: Dict[str, Any]) -> None:
    line = (json.dumps(event, separators=(',', ':')) + ',\n').encode()
    with self._lock:
      os.write(self._fd, line)

  def complete_event(self, name: str, cat: str, ts_s: float, dur_s: float,
                     args: Optional[Dict[str, Any]] = None) -> None:
    """One 'X' (complete) event; ts/dur in seconds of time.time()."""
    self._emit_raw({
        'name': name, 'cat': cat, 'ph': 'X',
        'ts': ts_s * 1e6, 'dur': max(0.0, dur_s) * 1e6,
        'pid': self._pid, 'tid': threading.get_ident() & 0xffffffff,
        'args': args or {},
    })

  def close(self) -> None:
    with self._lock:
      if self._fd >= 0:
        os.close(self._fd)
        self._fd = -1


# Module state: one writer per process. `_writer is None` is the
# tracing-off fast path read on every span() call.
# configure() runs before a run's threads start; they only read it.
_writer: Optional[TraceWriter] = None
_local = threading.local()


def configure(path: Optional[str], tier: str = '') -> Optional[TraceWriter]:
  """Enables tracing to `path` (None/'' disables). Returns the writer."""
  global _writer
  if _writer is not None:
    _writer.close()
    _writer = None
  if path:
    _writer = TraceWriter(path, tier=tier)
  return _writer


def configure_from_env(tier: str = '') -> Optional[TraceWriter]:
  """Enables tracing when DCTPU_TRACE names a path."""
  return configure(os.environ.get(ENV_TRACE) or None, tier=tier)


def enabled() -> bool:
  return _writer is not None


def writer() -> Optional[TraceWriter]:
  return _writer


def mint_trace_id() -> str:
  """16-hex-char trace id (half a UUID)."""
  return os.urandom(8).hex()


def set_trace_id(trace_id: Optional[str]) -> None:
  """Binds `trace_id` to the current thread; span() stamps it into
  every event's args until cleared."""
  _local.trace_id = trace_id


def get_trace_id() -> Optional[str]:
  return getattr(_local, 'trace_id', None)


def complete_event(name: str, cat: str, t0: float, t1: float,
                   args: Optional[Dict[str, Any]] = None) -> None:
  """After-the-fact span from two time.time() stamps. No-op when
  tracing is off, so instrumentation sites call it unconditionally."""
  w = _writer
  if w is None:
    return
  args = dict(args or {})
  trace_id = get_trace_id()
  if trace_id and 'trace_id' not in args:
    args['trace_id'] = trace_id
  w.complete_event(name, cat, t0, t1 - t0, args)


@contextlib.contextmanager
def span(name: str, cat: str = 'stage',
         **args: Any) -> Iterator[None]:
  """Context-managed stage span. The tracing-off path is one global
  read and an empty yield."""
  if _writer is None:
    yield
    return
  t0 = time.time()
  try:
    yield
  finally:
    complete_event(name, cat, t0, time.time(), args)
