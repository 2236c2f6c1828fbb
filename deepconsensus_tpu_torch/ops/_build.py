"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each `csrc/*.cu` compiles with nvcc into its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), under
`build/torch_kernels/` at the repository root. Every source starts
compiling at once, one nvcc process each. A library's file name carries
a hash of its sources and flags, so an edited kernel rebuilds and a
stale one is never loaded. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'torch_kernels'
SOURCES = ('gemm', 'ffn', 'embed_condense', 'ragged_attention',
           'phred_epilogue', 'wavefront', 'banded_attention',
           'flash_band_attention')
NVCC_FLAGS = (
    '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
    '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the entry points (each returns its cudaError_t).
SIGNATURES = {
    'gemm': {'dc_gemm': (_P, _I, _I, _P, _I, _I, _I, _I, _I, _F, _I, _P, _P,
                         _I, _P, _I, _P, _P, _I, _P)},
    'ffn': {'dc_ffn': (_P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                       _P, _P, _P, _I, _P)},
    'embed_condense': {
        'dc_embed_condense': (_P, _I, _I, _P, _I, ctypes.POINTER(_P),
                              ctypes.POINTER(_I), ctypes.POINTER(_F),
                              ctypes.POINTER(_I), ctypes.POINTER(_I), _I, _P,
                              _I, _P, _I, _I, _I, _P, _P, _P, _I, _P),
        'dc_embed_condense_smem_bytes': (_I, _I, _I, _I),
    },
    'ragged_attention': {
        'dc_attention': (_P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P),
        'dc_attention_smem_bytes': (_I, _I, _I, _I),
    },
    'phred_epilogue': {'dc_phred_epilogue': (_P, ctypes.c_int64, _I, _P, _I,
                                             _P, _P, _P)},
    'wavefront': {
        'dc_wavefront_fwd': (_P, _P, _P, _I, _I, _I, _F, _F, _I, _F, _P, _P,
                             _P),
        'dc_wavefront_bwd': (_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _P,
                             _P, _P),
        'dc_band_fwd': (_P, _P, _P, _I, _I, _I, _F, _F, _I, _F, _P, _P, _P),
        'dc_band_bwd': (_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _F, _P,
                        _P, _P),
    },
    'banded_attention': {
        'dc_banded_attention_smem_bytes': (_I, _I, _I),
        'dc_banded_attention_fwd': (_P, _P, _P, _P, _F, _P, _I, _I, _I, _I,
                                    _I, _I, _P),
        'dc_banded_attention_bwd': (_P, _P, _P, _P, _P, _F, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _P),
        'dc_banded_attention_bwd_pass': (_I, _P, _P, _P, _P, _P, _F, _P, _P,
                                         _P, _P, _I, _I, _I, _I, _I, _I, _P),
        'dc_banded_attention_blocks_per_sm': (_I, _I, _I),
    },
    'flash_band_attention': {
        'dc_flash_band_smem_bytes': (_I,),
        'dc_flash_band_blocks_per_sm': (_I, _I, _I),
        'dc_flash_band_fwd': (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _P),
        'dc_flash_band_dq': (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _P),
        'dc_flash_band_dkdv': (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _P),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
  for home in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
    if home and os.path.exists(os.path.join(home, 'bin', 'nvcc')):
      return os.path.join(home, 'bin', 'nvcc')
  found = shutil.which('nvcc')
  if found is None:
    raise RuntimeError(
        'nvcc not found (set CUDA_HOME); the port builds its CUDA kernels '
        'at first use')
  return found


def _lib_path(name: str) -> Path:
  digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
  for src in sorted(CSRC.glob('*.cuh')) + [CSRC / f'{name}.cu']:
    digest.update(src.read_bytes())
  return BUILD_DIR / f'lib{name}-{digest.hexdigest()[:16]}.so'


def build_all() -> Dict[str, Path]:
  """Compiles every missing library in parallel; returns name -> path.
  nvcc's resource report (-Xptxas -v) lands in <library>.log."""
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  nvcc = nvcc_path()
  paths = {name: _lib_path(name) for name in SOURCES}
  procs = {}
  for name, path in paths.items():
    if path.exists():
      continue
    tmp = path.with_suffix(f'.{os.getpid()}.tmp')
    log = open(path.with_suffix('.log'), 'w')
    procs[name] = (subprocess.Popen(
        [nvcc, *NVCC_FLAGS, '-I', str(CSRC), '-o', str(tmp),
         str(CSRC / f'{name}.cu')],
        stdout=log, stderr=subprocess.STDOUT), tmp, log)
  failed = []
  for name, (proc, tmp, log) in procs.items():
    rc = proc.wait()
    log.close()
    if rc == 0:
      os.replace(tmp, paths[name])
    else:
      failed.append(name)
  if failed:
    details = '\n'.join(
        paths[n].with_suffix('.log').read_text()[-4000:] for n in failed)
    raise RuntimeError(f'nvcc failed for {failed}:\n{details}')
  return paths


def load(name: str) -> ctypes.CDLL:
  """The ctypes handle of one kernel library, building all on first use."""
  with _lock:
    if name not in _libs:
      paths = build_all()
      for lib_name, path in paths.items():
        lib = ctypes.CDLL(str(path))
        for fn_name, argtypes in SIGNATURES[lib_name].items():
          fn = getattr(lib, fn_name)
          fn.argtypes = argtypes
          fn.restype = ctypes.c_int
        _libs[lib_name] = lib
    return _libs[name]


def check(err: int, what: str) -> None:
  """Raises when a launch wrapper returned a non-zero cudaError_t."""
  if err:
    raise RuntimeError(f'{what}: CUDA launch failed with cudaError_t {err}')


def launch(fn, what: str, device, *args) -> None:
  """Calls the C entry point fn(*args, stream) with `device` (the
  operands' card) current and its current stream as the last argument,
  and raises if it returned a non-zero cudaError_t. The entry points set
  function attributes, size persistent grids and launch on the current
  device, so on a host with several cards an operand on cuda:1 must make
  cuda:1 current first."""
  import torch

  with torch.cuda.device(device):
    check(fn(*args, stream_ptr(device)), what)


def ptr(t) -> ctypes.c_void_p:
  return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def stream_ptr(device) -> ctypes.c_void_p:
  """The device's current CUDA stream, as the raw handle a launch takes
  (torch.cuda.current_stream would build a Stream object around it on
  every launch)."""
  import torch

  index = device.index if device.index is not None else (
      torch.cuda.current_device())
  return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(index))
