"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
  """None means the card. A CUDA device with no card present raises:
  the port never falls back to the CPU on its own; pass device='cpu'
  to ask for it."""
  device = torch.device('cuda' if device is None else device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(
        'no CUDA device is available; pass device="cpu" (--device cpu) '
        'to run the port on the CPU')
  if device.type not in ('cuda', 'cpu', 'meta'):
    raise ValueError(f'unsupported device {device}')
  return device
