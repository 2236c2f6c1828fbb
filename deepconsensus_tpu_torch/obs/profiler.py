"""On-demand torch.profiler capture (port of deepconsensus_tpu/obs/profiler.py).

``/debugz/profile?seconds=N`` on a serve replica (serve/server.py)
calls ``capture_profile``: an operator takes a trace of a live replica
without restarting it. The capture records the host and, where a card
is present, the card's kernels (CUPTI), and writes one Chrome trace
file into ``out_dir``.

torch is imported inside the capture, so this module stays importable
on the torch-free tiers (router, featurize worker), and a second
capture while one runs is refused (one profiler per process) rather
than crashing the first. The SIGUSR2 hook the reference installs on
batch ``run`` / ``train`` is not ported yet.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Dict

log = logging.getLogger(__name__)

_MAX_CAPTURE_S = 120.0

# One capture at a time per process (the profiler is a singleton).
_capture_lock = threading.Lock()


def capture_profile(out_dir: str, seconds: float) -> Dict[str, Any]:
  """Runs one bounded torch.profiler capture into `out_dir`.

  Returns a status dict and never raises: the debug endpoint reports an
  unavailable or failing profiler instead of failing the replica.
  Blocks for `seconds`, so callers own threading."""
  seconds = min(max(0.1, float(seconds)), _MAX_CAPTURE_S)
  if not _capture_lock.acquire(blocking=False):
    return {'ok': False, 'error': 'a profiler capture is already running'}
  try:
    try:
      import torch
      from torch import profiler as torch_profiler
    except Exception as e:  # the error is the endpoint's payload
      return {'ok': False, 'error': f'torch unavailable: {e}'}
    os.makedirs(out_dir, exist_ok=True)
    activities = [torch_profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
      activities.append(torch_profiler.ProfilerActivity.CUDA)
    path = os.path.join(out_dir, f'trace-{os.getpid()}-{time.time_ns()}.json')
    t0 = time.time()
    try:
      with torch_profiler.profile(activities=activities) as prof:
        time.sleep(seconds)
      prof.export_chrome_trace(path)
    except Exception as e:  # profiler backends fail per environment
      return {'ok': False, 'error': f'{type(e).__name__}: {e}'}
    return {
        'ok': True,
        'out_dir': out_dir,
        'trace': path,
        'seconds': round(time.time() - t0, 3),
    }
  finally:
    _capture_lock.release()
