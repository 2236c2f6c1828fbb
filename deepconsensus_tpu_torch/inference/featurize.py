"""Featurization of ZMWs, in-process or in a worker pool over shared memory.

Port of the reference runner's featurization pool
(deepconsensus_tpu/inference/runner.py, `preprocess_zmw_shm`,
`_pool_worker`, `_features_from_shm`): each worker featurizes one ZMW
and writes its window tensors into one POSIX shared-memory segment; the
result pickle carries only names, offsets and small metadata, and the
parent views the tensors in place and unlinks the segment once they
are consumed. The pool runs under inference.faults.PoolWatchdog: a
batch that times out (a hung or killed worker) re-spawns the pool,
reclaims the batch's segments by name prefix and retries.

This module imports neither torch nor the runner, so a worker started
by `make_pool` (a `spawn` context: the parent has initialised CUDA and
started threads by the time the pool starts, and fork after that is
unsafe) loads only numpy and the featurizer, and never touches the
card.
"""
from __future__ import annotations

import collections
import itertools
import multiprocessing
import os
import traceback
from multiprocessing import resource_tracker, shared_memory
from typing import Any, Dict, List, Tuple

import numpy as np

from deepconsensus_tpu_torch import faults
from deepconsensus_tpu_torch.inference.faults import reclaim_shm_segments
from deepconsensus_tpu_torch.preprocess.feeder import reads_to_pileup

# Feature-dict fields shipped as pickled metadata by the shm transport
# (everything except the bulk 'subreads' tensor).
_SHM_META_FIELDS = (
    'subreads/num_passes', 'name', 'window_pos',
    'ccs_base_quality_scores', 'overflow', 'ec', 'np_num_passes', 'rq',
    'rg',
)


def preprocess_zmw(zmw_input) -> Tuple[List[Dict[str, Any]],
                                       collections.Counter]:
  """One ZMW -> (window feature dicts, counter)
  (reference: quick_inference.py:535-564)."""
  subreads, name, layout, _split, window_widths = zmw_input
  pileup = reads_to_pileup(subreads, name, layout, window_widths)
  return list(pileup.iter_window_features()), pileup.counter


def _create_shm(size: int, prefix: str) -> shared_memory.SharedMemory:
  """One segment, named under `prefix` so a run's segments can be
  counted (and found) by name."""
  for attempt in itertools.count():
    name = f'{prefix}{os.getpid()}_{attempt}'
    try:
      return shared_memory.SharedMemory(name=name, create=True, size=size)
    except FileExistsError:
      continue


def preprocess_zmw_shm(zmw_input, shm_prefix: str):
  """Worker side: featurizes one ZMW into one shared-memory segment.
  Returns (shm_name or None, window metadata, counter); the parent owns
  the segment from then on (the worker unregisters it from its resource
  tracker)."""
  features, counter = preprocess_zmw(zmw_input)
  total = sum(f['subreads'].nbytes for f in features)
  if not total:
    return None, [{k: f[k] for k in _SHM_META_FIELDS} for f in features
                  ], counter
  shm = _create_shm(total, shm_prefix)
  try:
    meta = []
    offset = 0
    for f in features:
      arr = f['subreads']
      view = np.ndarray(arr.shape, arr.dtype, buffer=shm.buf, offset=offset)
      view[...] = arr
      entry = {k: f[k] for k in _SHM_META_FIELDS}
      # bq values fit int16 (-1..93); int64 would dominate the pickle.
      entry['ccs_base_quality_scores'] = (
          entry['ccs_base_quality_scores'].astype(np.int16))
      entry['_shape'] = arr.shape
      entry['_dtype'] = arr.dtype.str
      entry['_offset'] = offset
      offset += arr.nbytes
      meta.append(entry)
  except BaseException:
    # Packing failed: this worker still owns the segment.
    shm.close()
    shm.unlink()
    raise
  name = shm.name
  shm.close()
  # The worker's resource tracker would unlink the segment when the
  # worker exits; ownership passes to the parent instead.
  resource_tracker.unregister(f'/{name}', 'shared_memory')
  return name, meta, counter


def _pool_worker(zmw_input, shm_prefix: str):
  """starmap payload: never raises, so the parent always receives every
  created segment's name (a raising task would make starmap discard
  all results and orphan the other workers' segments). Honors the
  faults.ENV_KILL_ZMW injection."""
  try:
    faults.maybe_kill_worker(zmw_input[1])
    return 'ok', preprocess_zmw_shm(zmw_input, shm_prefix)
  except Exception:
    return 'error', traceback.format_exc()


def features_from_shm(result):
  """Parent side: (features, counter, segment or None). The features
  view the segment; the caller closes and unlinks it once they are
  consumed."""
  shm_name, meta, counter = result
  shm = None
  features = []
  if shm_name is not None:
    shm = shared_memory.SharedMemory(name=shm_name)
  for entry in meta:
    f = {k: entry[k] for k in _SHM_META_FIELDS}
    f['ccs_base_quality_scores'] = (
        f['ccs_base_quality_scores'].astype(np.int64))
    if shm is not None:
      f['subreads'] = np.ndarray(
          entry['_shape'], np.dtype(entry['_dtype']), buffer=shm.buf,
          offset=entry['_offset'])
    features.append(f)
  return features, counter, shm


def release_segments(segments) -> None:
  """Closes and unlinks shared-memory segments (attached handles, or
  names of segments never attached)."""
  for shm in segments:
    try:
      if isinstance(shm, str):
        shm = shared_memory.SharedMemory(name=shm)
      shm.close()
      shm.unlink()
    except (FileNotFoundError, OSError):
      pass


def make_pool(processes: int):
  """A featurization pool from a `spawn` context: its workers start from
  a fresh interpreter, never forked from this process (which may hold a
  CUDA context and threads); as with any such pool, a calling script
  needs an `if __name__ == '__main__'` guard."""
  return multiprocessing.get_context('spawn').Pool(processes)


def featurize_with_pool(watchdog, zmws, shm_prefix: str):
  """Featurizes `zmws` in the watchdog's pool. Returns (pairs, failed,
  attached): [(zmw_input, features, counter)] in input order, the
  [(zmw_input, traceback text)] whose worker raised, and the attached
  segments the features view. Raises inference.faults.WatchdogTimeout
  when the batch exhausted its retries (its segments reclaimed). On any
  other failure every segment the batch created is released before the
  error propagates."""
  raw = watchdog.run_batch(_pool_worker, [(z, shm_prefix) for z in zmws],
                           chunksize=4, shm_prefix=shm_prefix)
  pairs = []
  failed = []
  attached = []
  try:
    for zmw_input, (status, payload) in zip(zmws, raw):
      if status != 'ok':
        failed.append((zmw_input, payload))
        continue
      features, counter, shm = features_from_shm(payload)
      pairs.append((zmw_input, features, counter))
      if shm is not None:
        attached.append(shm)
  except BaseException:
    names = {s.name for s in attached}
    release_segments(attached)
    release_segments([payload[0] for status, payload in raw
                      if status == 'ok' and payload[0] is not None
                      and payload[0] not in names])
    reclaim_shm_segments(shm_prefix)
    raise
  return pairs, failed, attached
