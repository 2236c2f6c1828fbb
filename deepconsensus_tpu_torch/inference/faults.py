"""Fault tolerance of `run`: per-ZMW quarantine, the pool watchdog and
the resumable progress manifest.

Port of deepconsensus_tpu/inference/faults.py:

* the per-ZMW quarantine under --on_zmw_error={fail,skip,ccs-fallback},
  which writes every quarantined ZMW to <output>.failed.jsonl
  (faults.DeadLetterWriter) and, under ccs-fallback, hands back the
  draft CCS read to emit in its place;
* a watchdog for the featurization worker pool (per-batch timeout,
  bounded retry with backoff, pool re-spawn, shared-memory reclaim);
* a crash-consistent progress manifest for the atomic <output>.tmp
  write that --resume continues.

The shared error taxonomy, dead-letter writer and injection hooks live
in deepconsensus_tpu_torch/faults.py.
"""
from __future__ import annotations

import collections
import dataclasses
import glob
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

from deepconsensus_tpu_torch.faults import DeadLetterWriter, classify_error

log = logging.getLogger(__name__)


class FaultStage:
  """Pipeline stage where a fault surfaced."""

  DECODE = 'decode'        # BAM/BGZF stream decoding (feeder)
  FEATURIZE = 'featurize'  # alignment expansion / pileup / windows
  MODEL = 'model'          # device dispatch / forward pass
  STITCH = 'stitch'        # window stitching / output formatting

  ALL = (DECODE, FEATURIZE, MODEL, STITCH)


class OnZmwError:
  """--on_zmw_error policy values."""

  FAIL = 'fail'
  SKIP = 'skip'
  CCS_FALLBACK = 'ccs-fallback'

  CHOICES = (FAIL, SKIP, CCS_FALLBACK)


@dataclasses.dataclass
class ZmwFault(Exception):
  """A classified per-ZMW failure."""

  zmw: Optional[str]
  stage: str
  kind: str
  message: str

  def __str__(self) -> str:
    return (f'[{self.stage}/{self.kind}] zmw={self.zmw or "<stream>"}: '
            f'{self.message}')


class WatchdogTimeout(RuntimeError):
  """A featurization batch exhausted its watchdog retries."""


# ----------------------------------------------------------------------
# CCS fallback payloads


@dataclasses.dataclass
class CcsFallback:
  """The draft CCS read emitted in place of a quarantined ZMW."""

  molecule_name: str
  sequence: str
  quality_scores: np.ndarray  # int array, one per base
  ec: Optional[float] = None
  np_num_passes: Optional[int] = None
  rq: Optional[float] = None
  rg: Optional[str] = None


def fallback_from_record(record) -> CcsFallback:
  """A fallback from a raw CCS BamRecord (feeder stage)."""
  n = len(record.seq)
  quals = (np.asarray(record.quals, dtype=np.int64)
           if record.quals is not None else np.zeros(n, dtype=np.int64))
  tags = record.tags
  return CcsFallback(
      molecule_name=record.qname, sequence=record.seq,
      quality_scores=quals, ec=tags.get('ec'), np_num_passes=tags.get('np'),
      rq=tags.get('rq'), rg=tags.get('RG'))


def fallback_from_ccs_read(ccs_read) -> CcsFallback:
  """A fallback from an expanded draft CCS AlignedRead (featurize
  stage: a zmw_input's subreads[-1])."""
  from deepconsensus_tpu_torch.utils import phred

  return CcsFallback(
      molecule_name=ccs_read.name,
      sequence=phred.encoded_sequence_to_string(ccs_read.bases),
      quality_scores=np.asarray(ccs_read.base_quality_scores,
                                dtype=np.int64),
      ec=ccs_read.ec, np_num_passes=ccs_read.np_num_passes,
      rq=ccs_read.rq, rg=ccs_read.rg)


# ----------------------------------------------------------------------
# Quarantine


class Quarantine:
  """Applies the --on_zmw_error policy to per-ZMW faults.

  handle() re-raises under 'fail'; otherwise it records a dead letter,
  bumps counters and returns the CcsFallback to emit (or None).
  Thread-safe: the producer thread (decode, featurize), the model stage
  and the emit thread (stitch) all report faults."""

  def __init__(self, policy: str, dead_letter: Optional[DeadLetterWriter]):
    if policy not in OnZmwError.CHOICES:
      raise ValueError(f'on_zmw_error must be one of {OnZmwError.CHOICES}, '
                       f'got {policy!r}')
    self.policy = policy
    self.dead_letter = dead_letter
    self.counters: collections.Counter = collections.Counter()
    self._lock = threading.Lock()

  def handle(self, zmw: Optional[str], stage: str,
             error: 'BaseException | str',
             fallback: Optional[Callable[[], Optional[CcsFallback]]] = None,
             extra: Optional[Dict[str, Any]] = None
             ) -> Optional[CcsFallback]:
    """Quarantines one ZMW. fallback is a thunk, evaluated only under
    ccs-fallback, producing the draft-CCS payload (None: no draft is
    recoverable and the action downgrades to skip). extra rides into
    the dead letter (a failed pack's id and window count)."""
    if self.policy == OnZmwError.FAIL:
      if isinstance(error, BaseException):
        raise error
      raise ZmwFault(zmw, stage, classify_error(error), error)
    text = (error if isinstance(error, str)
            else f'{type(error).__name__}: {error}')
    kind = classify_error(text)
    payload = None
    action = OnZmwError.SKIP
    if self.policy == OnZmwError.CCS_FALLBACK and fallback is not None:
      try:
        payload = fallback()
      except Exception as fb_err:  # the draft itself is unrecoverable
        log.warning('ccs-fallback for %s failed (%s); skipping', zmw, fb_err)
      if payload is not None:
        action = OnZmwError.CCS_FALLBACK
    with self._lock:
      self.counters['n_zmw_quarantined'] += 1
      self.counters[f'n_fault_{stage}'] += 1
      if action == OnZmwError.CCS_FALLBACK:
        self.counters['n_zmw_ccs_fallback'] += 1
      else:
        self.counters['n_zmw_skipped_on_error'] += 1
      if self.dead_letter is not None:
        self.dead_letter.record(zmw, stage, kind, text, action, extra=extra)
    log.warning('quarantined zmw=%s stage=%s kind=%s action=%s: %s',
                zmw, stage, kind, action,
                text.splitlines()[-1] if text else text)
    return payload

  def bump(self, key: str, n: int = 1) -> None:
    with self._lock:
      self.counters[key] += n


# ----------------------------------------------------------------------
# Worker-pool watchdog


def reclaim_shm_segments(prefix: str) -> int:
  """Unlinks every /dev/shm segment carrying this run or batch prefix:
  the only record left of a SIGKILLed worker's segments (workers hand
  their segments' ownership to the parent)."""
  if not prefix:
    return 0
  n = 0
  for path in glob.glob(f'/dev/shm/{glob.escape(prefix)}*'):
    try:
      os.unlink(path)
      n += 1
    except OSError:
      pass
  if n:
    log.warning('reclaimed %d leaked shm segment(s) with prefix %s',
                n, prefix)
  return n


class PoolWatchdog:
  """Supervises the featurization pool.

  run_batch() bounds each starmap with a timeout: a pool silently loses
  the task of a worker that died, so a hung or SIGKILLed worker shows
  as a timeout. The watchdog then reclaims the batch's shared-memory
  segments, terminates and re-spawns the pool, backs off and retries
  the whole batch; after `retries` retries it raises WatchdogTimeout
  for the quarantine to apply --on_zmw_error."""

  # Pool-machinery failures that merit a respawn and retry.
  _POOL_ERRORS = (BrokenPipeError, EOFError, ConnectionError)

  def __init__(self, make_pool: Callable[[], Any], timeout: float = 0.0,
               retries: int = 2, backoff: float = 0.5,
               quarantine: Optional[Quarantine] = None):
    self._make_pool = make_pool
    self.timeout = timeout
    self.retries = max(0, retries)
    self.backoff = backoff
    self.quarantine = quarantine
    self.pool = make_pool()

  def _bump(self, key: str) -> None:
    if self.quarantine is not None:
      self.quarantine.bump(key)

  def run_batch(self, func, tasks, chunksize: int, shm_prefix: str = ''):
    """starmap with watchdog semantics; returns the results."""
    import multiprocessing

    if not self.timeout:
      return self.pool.starmap(func, tasks, chunksize=chunksize)
    last_error = 'timeout'
    for attempt in range(self.retries + 1):
      if attempt:
        self._bump('n_watchdog_retries')
        time.sleep(self.backoff * (2 ** (attempt - 1)))
      async_result = self.pool.starmap_async(func, tasks, chunksize=chunksize)
      try:
        return async_result.get(self.timeout)
      except multiprocessing.TimeoutError:
        last_error = f'no result within {self.timeout}s'
      except self._POOL_ERRORS as e:
        last_error = f'pool failure: {type(e).__name__}: {e}'
      self._bump('n_watchdog_timeouts')
      log.warning('featurization batch watchdog fired (attempt %d/%d): %s; '
                  're-spawning the worker pool', attempt + 1,
                  self.retries + 1, last_error)
      self.respawn(shm_prefix)
    raise WatchdogTimeout(
        f'featurization batch failed the watchdog {self.retries + 1} '
        f'time(s): {last_error}')

  def respawn(self, shm_prefix: str = '') -> None:
    """Terminates the (possibly hung) pool, reclaims this batch's
    segments and brings up a fresh pool."""
    try:
      self.pool.terminate()
      self.pool.join()
    except Exception as e:  # the pool is being replaced either way
      log.warning('pool terminate failed: %s', e)
    reclaim_shm_segments(shm_prefix)
    self._bump('n_pool_respawns')
    self.pool = self._make_pool()

  def close(self) -> None:
    """Stops the pool: its batches are done, or the run is failing."""
    self.pool.terminate()
    self.pool.join()


# ----------------------------------------------------------------------
# Resumable, atomic output


class ProgressManifest:
  """Crash-consistent progress record for <output>.tmp.

  A commit (write + fsync + rename) records the feeder groups fully
  written and the flushed tmp size, so --resume can truncate the tmp
  output to the last committed byte and skip exactly the committed
  groups. `source` pins the inputs; resuming against others fails."""

  VERSION = 1

  def __init__(self, path: str):
    self.path = path

  def commit(self, groups_done: int, tmp_size: int, source: Dict[str, Any],
             last_zmw: Optional[str] = None,
             extra: Optional[Dict[str, Any]] = None) -> None:
    state = {
        'version': self.VERSION,
        'groups_done': groups_done,
        'tmp_size': tmp_size,
        'last_zmw': last_zmw,
        'source': source,
        'time': time.time(),
    }
    if extra:
      state.update(extra)
    tmp = self.path + '.tmp'
    with open(tmp, 'w') as f:
      json.dump(state, f)
      f.flush()
      os.fsync(f.fileno())
    os.replace(tmp, self.path)

  def load(self) -> Optional[Dict[str, Any]]:
    try:
      with open(self.path) as f:
        state = json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
      return None
    if state.get('version') != self.VERSION:
      log.warning('ignoring %s with unknown version %s', self.path,
                  state.get('version'))
      return None
    return state

  def delete(self) -> None:
    for path in (self.path, self.path + '.tmp'):
      try:
        os.unlink(path)
      except FileNotFoundError:
        pass


def validate_resume_source(state: Dict[str, Any],
                           source: Dict[str, Any]) -> None:
  """A manifest written for other inputs or options must not graft a
  resumed run onto them."""
  recorded = state.get('source') or {}
  for key, value in source.items():
    if recorded.get(key) != value:
      raise ValueError(
          f'--resume manifest mismatch for {key!r}: run was started '
          f'with {recorded.get(key)!r}, resume requested {value!r} '
          f'(delete the .progress.json to restart from scratch)')
