"""A test-only device spin (csrc/device_spin.cu): fault injection's hang.

ModelRunner launches it when faults.ENV_DEVICE_HANG_AT_PACK targets a
pack on the card: on a side stream, after the pack's output copy and
before the event the dispatch watchdog polls. It ports no TPU kernel.
The CPU has no counterpart: there the injected hang waits on the host
clock (inference/runner.py).
"""
from __future__ import annotations

import ctypes

from deepconsensus_tpu_torch.ops import _build

# Launches of the spin kernel (one per injected hang).
n_launches = 0


def spin(seconds: float, device) -> None:
  """Holds `device`'s current stream busy for `seconds` on the card."""
  global n_launches
  lib = _build.load('device_spin')
  _build.launch(lib.dc_device_spin, 'device_spin', device,
                ctypes.c_double(seconds))
  n_launches += 1
