"""Shared fault taxonomy, dead-letter sidecars and injection hooks.

Port of the reference package's faults.py, trimmed to what `run`,
`validate`, `trace`, `train`, `serve`, `route` and `featurize-worker`
use: the transient/permanent classification, the typed input, device,
training, serve and fleet faults, the dead-letter JSONL sidecar and the
env-var fault-injection hooks. The flywheel and elastic-pod types and
hooks are not part of the port yet. The serve and fleet rejections keep
the reference's messages, `kind` and HTTP status, so clients of either
package see the same errors.

Besides the reference's message markers, classify_device_error maps
PyTorch's own device errors: `torch.cuda.OutOfMemoryError` to
DeviceOomError, and a dead CUDA context (an illegal memory access, a
device-side assert, a failed launch) to DeviceLostError.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any, Dict, List, Optional

log = logging.getLogger(__name__)


# ----------------------------------------------------------------------
# Error taxonomy


class FaultKind:
  TRANSIENT = 'transient'
  PERMANENT = 'permanent'


# Device-runtime signatures plus host-side pool/timeout signatures.
_TRANSIENT_MARKERS = (
    'UNAVAILABLE', 'DEADLINE_EXCEEDED', 'RESOURCE_EXHAUSTED', 'PREEMPT',
    'timed out', 'Timeout', 'Connection reset', 'Broken pipe',
    'watchdog',
)


def classify_error(error_text: str) -> str:
  """Transient (worth retrying) vs permanent (bad data/config) by
  message."""
  if any(marker in error_text for marker in _TRANSIENT_MARKERS):
    return FaultKind.TRANSIENT
  return FaultKind.PERMANENT


class CorruptInputError(IOError):
  """Untrusted input bytes failed decode-layer validation.

  Carries machine-readable context so callers can report file, byte
  offset and ZMW without parsing the message:

  * path:   the input file
  * offset: byte offset of the bad frame (decompressed-stream offset
            for BGZF-compressed inputs, raw file offset otherwise)
  * zmw:    per-molecule context when known (read name / ZMW)
  * recoverable: True when the stream is positioned past the damaged
            record so the caller may keep reading; False when the
            stream cannot be advanced.

  Permanent by construction: the message carries no transient markers.
  """

  def __init__(self, message: str, *, path: Optional[str] = None,
               offset: Optional[int] = None, zmw: Optional[str] = None,
               recoverable: bool = False):
    context = [
        f'file={path}' if path else None,
        f'offset={offset}' if offset is not None else None,
        f'zmw={zmw}' if zmw else None,
    ]
    context = [c for c in context if c]
    super().__init__(
        f'{message} [{" ".join(context)}]' if context else message)
    self.path = path
    self.offset = offset
    self.zmw = zmw
    self.recoverable = recoverable


class WindowBucketError(ValueError):
  """A window's width is not one the model was configured for."""


class NotPortedError(NotImplementedError):
  """An option the reference offers that the port does not run yet:
  multi-card serving (`serve --dp/--tp`) and exported artifacts (`cli
  export`). Permanent: the same flags fail the same way."""


class ServeRejection(RuntimeError):
  """Base for typed `serve` admission rejections. Carries an HTTP status
  so the server maps taxonomy to wire code without parsing messages;
  `kind` feeds the transient/permanent classification (clients retry
  transient rejections with backoff)."""

  http_status = 500

  @property
  def kind(self) -> str:
    return classify_error(str(self))


class BackpressureError(ServeRejection):
  """Admission queue full: the service sheds load instead of growing
  without bound. Transient (RESOURCE_EXHAUSTED): retry after backoff."""

  http_status = 429

  def __init__(self, detail: str):
    super().__init__(f'RESOURCE_EXHAUSTED: {detail}')


class DrainingError(ServeRejection):
  """The service stopped admitting (SIGTERM or a preemption notice);
  admitted work is finishing. Transient (UNAVAILABLE): retry against
  another replica."""

  http_status = 503

  def __init__(self, detail: str = 'service is draining'):
    super().__init__(f'UNAVAILABLE: {detail}')


class DeadlineExceededError(ServeRejection):
  """The request's deadline passed before its result was ready; its
  remaining windows were cancelled. Transient (DEADLINE_EXCEEDED)."""

  http_status = 504

  def __init__(self, detail: str):
    super().__init__(f'DEADLINE_EXCEEDED: {detail}')


class BadRequestError(ServeRejection):
  """Malformed request payload (undecodable npz, missing fields, shapes
  that do not match the loaded model). Permanent: clients must not
  retry the same bytes."""

  http_status = 400


class RequestTooLargeError(BadRequestError):
  """Request body over the byte or window cap, rejected before decode."""

  http_status = 413


class FleetRejection(ServeRejection):
  """`route` could not place the request: every eligible replica of the
  tier is saturated, draining or dead. Transient (UNAVAILABLE)."""

  http_status = 503

  def __init__(self, detail: str):
    super().__init__(f'UNAVAILABLE: {detail}')


class ReplicaLostError(FleetRejection):
  """A replica died after the router finished sending it a request (it
  may have accepted the work), so the router does not place it again:
  a retry could duplicate an accepted request. A transient 503."""

  http_status = 503


class QuotaExceededError(FleetRejection):
  """A client is at its per-client concurrent-request quota at the
  router's admission gate. Transient (RESOURCE_EXHAUSTED), and charged
  to that one tenant, never to fleet capacity."""

  http_status = 429

  def __init__(self, detail: str):
    # Not FleetRejection's UNAVAILABLE prefix: the quota is the client's
    # own concurrency, not fleet capacity.
    ServeRejection.__init__(self, f'RESOURCE_EXHAUSTED: {detail}')


class CrashLoopError(RuntimeError):
  """Raised by run_training_with_retry when restarts stop making
  progress: the same resume step across K consecutive transient
  failures means retrying cannot help."""


class NonFiniteTrainingError(RuntimeError):
  """Raised when the NaN sentinel exhausts its rollback budget (or has
  no valid checkpoint to roll back to). Permanent by construction: the
  message carries no transient markers, so the retry loop re-raises
  instead of looping on a diverged model."""


class DeviceFault(RuntimeError):
  """Base for device-runtime failures surfaced at pack dispatch or
  finalize. classify_device_error() wraps what the forward raises into
  this family, so the engine's fault policy matches on types; `kind`
  feeds the transient/permanent classification."""

  @property
  def kind(self) -> str:
    return classify_error(str(self))


class DeviceOomError(DeviceFault):
  """Device memory exhausted while running a pack (RESOURCE_EXHAUSTED).
  Transient by construction: the same windows fit at a smaller batch,
  so `--on_device_error degrade` bisects the pack."""

  def __init__(self, detail: str):
    if 'RESOURCE_EXHAUSTED' not in detail:
      detail = f'RESOURCE_EXHAUSTED: {detail}'
    super().__init__(detail)


class DeviceLostError(DeviceFault):
  """The device halted or lost its state. Permanent: no transient
  markers, so a retry at the same shape re-raises."""


class DispatchTimeoutError(DeviceFault):
  """The dispatch watchdog gave up waiting for a pack
  (`--dispatch_timeout`). Transient by construction ('watchdog'
  marker): the device may recover, but this pack's tickets are failed
  so the model loop never wedges."""

  def __init__(self, detail: str):
    if 'watchdog' not in detail:
      detail = f'{detail} (dispatch watchdog)'
    super().__init__(detail)


# Message signatures of a halted or lost device: the reference's XLA
# markers, then a dead CUDA context as PyTorch reports it.
_DEVICE_LOST_MARKERS = (
    'DATA_LOSS', 'INTERNAL:', 'halted', 'DEVICE_LOST', 'device is lost',
    'illegal memory access', 'device-side assert', 'cudaErrorLaunchFailure',
    'unspecified launch failure',
)
_OOM_MARKERS = ('RESOURCE_EXHAUSTED', 'CUDA out of memory')


def _is_torch_oom(error: BaseException) -> bool:
  """True for torch.cuda.OutOfMemoryError, looked up without importing
  torch (this module stays importable where torch is absent)."""
  torch = sys.modules.get('torch')
  oom = getattr(torch, 'OutOfMemoryError', None) if torch else None
  return oom is not None and isinstance(error, oom)


def classify_device_error(error: BaseException) -> BaseException:
  """Wraps a device-runtime error into the typed DeviceFault family.

  DeviceFaults pass through untouched. An out-of-memory error becomes
  DeviceOomError; a halted device or dead CUDA context DeviceLostError;
  anything else returns unchanged (host-side bugs keep their type). The
  original error is chained via __cause__."""
  if isinstance(error, DeviceFault):
    return error
  text = f'{type(error).__name__}: {error}'
  wrapped: Optional[DeviceFault] = None
  if _is_torch_oom(error) or any(m in text for m in _OOM_MARKERS):
    wrapped = DeviceOomError(text)
  elif any(marker in text for marker in _DEVICE_LOST_MARKERS):
    wrapped = DeviceLostError(text)
  if wrapped is None:
    return error
  wrapped.__cause__ = error
  return wrapped


# ----------------------------------------------------------------------
# Dead-letter sidecar (JSONL, one object per line)


class DeadLetterWriter:
  """Streams quarantined-item records to a .failed.jsonl sidecar.

  One JSON object per line: {zmw, stage, kind, error, action, time}
  plus any `extra` fields and the thread's trace id. The file is
  created at the first record, so clean runs leave no sidecar; every
  line is flushed so a later crash cannot lose it."""

  def __init__(self, path: str, append: bool = False):
    self.path = path
    self._append = append
    self._f = None
    self.count = 0

  def record(self, zmw: Optional[str], stage: str, kind: str, error: str,
             action: str, extra: Optional[Dict[str, Any]] = None) -> None:
    if self._f is None:
      self._f = open(self.path, 'a' if self._append else 'w')
    entry = {
        'zmw': zmw,
        'stage': stage,
        'kind': kind,
        'error': error[:4000],
        'action': action,
        'time': time.time(),
    }
    if extra:
      entry.update(extra)
    if 'trace_id' not in entry:
      # Imported here: obs.summarize reads this module's fault types.
      from deepconsensus_tpu_torch.obs import trace as trace_lib

      trace_id = trace_lib.get_trace_id()
      if trace_id:
        entry['trace_id'] = trace_id
    json.dump(entry, self._f)
    self._f.write('\n')
    self._f.flush()
    self.count += 1

  def close(self) -> None:
    if self._f is not None:
      self._f.close()
      self._f = None


def read_dead_letters(path: str) -> List[Dict[str, Any]]:
  """Parses a dead-letter sidecar back into records."""
  entries = []
  with open(path) as f:
    for line in f:
      line = line.strip()
      if line:
        entries.append(json.loads(line))
  return entries


# ----------------------------------------------------------------------
# Fault-injection hooks
#
# ENV_KILL_ZMW SIGKILLs the featurization worker that takes the named
# ZMW; with ENV_KILL_TOKEN pointing at a path it fires exactly once
# (the first process to create the token file dies, the retry then
# succeeds). ENV_CRASH_AFTER_BATCHES makes the run raise after that
# many emitted featurize batches (just after a manifest commit).
# ENV_POISON_WINDOW names a ZMW substring: the first model window of
# the first matching molecule poisons its pack, which then fails at
# dispatch. The device hooks target a 1-based pack ordinal in dispatch
# order and fire once per process: OOM_AT_PACK raises
# RESOURCE_EXHAUSTED inside the pack's dispatch, LOST_AT_PACK a
# halted-device error, HANG_AT_PACK holds the pack's last event back
# ENV_DEVICE_HANG_S seconds (default 30) so the dispatch watchdog must
# fire. ENV_KILL_SHARD_READER SIGKILLs the streaming loader's worker
# process that is about to read a shard whose path contains the value
# (once, with ENV_KILL_TOKEN set). The training hooks target a 1-based
# step: NAN_AT_STEP fills that step's batch rows with NaN (once a
# process), SIGTERM_AT_STEP sends this process SIGTERM after the step
# (once a process), KILL_TRAIN_AT_STEP SIGKILLs it after the step (once
# across restarts with ENV_KILL_TOKEN set). The serve hooks: with
# ENV_POISON_WINDOW set, a serve request whose molecule name contains it
# poisons its pack and its isolation retry, so it is quarantined;
# ENV_SERVE_CLIENT_FAULT makes ServeClient misbehave on the wire
# (disconnect, garbage, oversized or slowloris) for molecule names
# containing ENV_SERVE_CLIENT_FAULT_ZMW (every request when unset);
# ENV_PREEMPT_AT_S makes a serve replica deliver itself a preemption
# notice that many seconds after it starts (it then drains as after
# SIGUSR1).

ENV_KILL_ZMW = 'DCTPU_FAULT_KILL_ZMW'
ENV_KILL_TOKEN = 'DCTPU_FAULT_KILL_TOKEN'
ENV_CRASH_AFTER_BATCHES = 'DCTPU_FAULT_CRASH_AFTER_BATCHES'
ENV_POISON_WINDOW = 'DCTPU_FAULT_POISON_WINDOW'
ENV_DEVICE_OOM_AT_PACK = 'DCTPU_FAULT_DEVICE_OOM_AT_PACK'
ENV_DEVICE_LOST_AT_PACK = 'DCTPU_FAULT_DEVICE_LOST_AT_PACK'
ENV_DEVICE_HANG_AT_PACK = 'DCTPU_FAULT_DEVICE_HANG_AT_PACK'
ENV_DEVICE_HANG_S = 'DCTPU_FAULT_DEVICE_HANG_S'
ENV_KILL_SHARD_READER = 'DCTPU_FAULT_KILL_SHARD_READER'
ENV_NAN_AT_STEP = 'DCTPU_FAULT_NAN_AT_STEP'
ENV_SIGTERM_AT_STEP = 'DCTPU_FAULT_SIGTERM_AT_STEP'
ENV_KILL_TRAIN_AT_STEP = 'DCTPU_FAULT_KILL_TRAIN_AT_STEP'
ENV_SERVE_CLIENT_FAULT = 'DCTPU_FAULT_SERVE_CLIENT'
ENV_SERVE_CLIENT_FAULT_ZMW = 'DCTPU_FAULT_SERVE_CLIENT_ZMW'
ENV_PREEMPT_AT_S = 'DCTPU_FAULT_PREEMPT_AT_S'

# Hooks that already fired in this process (consume-once semantics).
_fired: set = set()


def _env_int(name: str) -> int:
  try:
    return int(os.environ.get(name, '0'))
  except ValueError:
    return 0


def _claim_token() -> bool:
  """True when this process may fire a once-only kill (no token file
  configured, or this process created it first)."""
  token = os.environ.get(ENV_KILL_TOKEN)
  if not token:
    return True
  try:
    fd = os.open(token, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
  except FileExistsError:
    return False
  os.close(fd)
  return True


def _fire_once(env_name: str, step: int) -> bool:
  target = _env_int(env_name)
  if target <= 0 or step != target or env_name in _fired:
    return False
  _fired.add(env_name)
  return True


def maybe_kill_worker(zmw_name: str) -> None:
  """SIGKILLs the current process when fault injection targets this
  ZMW (once, with ENV_KILL_TOKEN set)."""
  target = os.environ.get(ENV_KILL_ZMW)
  if not target or target != zmw_name:
    return
  if not _claim_token():
    return
  import signal

  os.kill(os.getpid(), signal.SIGKILL)


def maybe_kill_shard_reader(shard_path: str) -> None:
  """SIGKILLs the current (shard-reader worker) process when
  ENV_KILL_SHARD_READER is a substring of the shard path about to be
  read (once, with ENV_KILL_TOKEN set)."""
  target = os.environ.get(ENV_KILL_SHARD_READER)
  if not target or target not in shard_path:
    return
  if not _claim_token():
    return
  import signal

  os.kill(os.getpid(), signal.SIGKILL)


def injected_crash_after_batches() -> int:
  """>0: the run raises after this many emitted batches."""
  return _env_int(ENV_CRASH_AFTER_BATCHES)


def maybe_poison_batch(step: int, batch: Dict[str, Any]) -> bool:
  """Overwrites the batch's rows with NaN when ENV_NAN_AT_STEP targets
  this step (once per process)."""
  if not _fire_once(ENV_NAN_AT_STEP, step):
    return False
  import numpy as np

  batch['rows'] = np.full_like(batch['rows'], np.nan)
  log.warning('fault injection: poisoned training batch at step %d', step)
  return True


def maybe_sigterm_at_step(step: int) -> bool:
  """Delivers SIGTERM to this process at the target step (once per
  process): a preemption notice."""
  if not _fire_once(ENV_SIGTERM_AT_STEP, step):
    return False
  import signal

  log.warning('fault injection: SIGTERM at step %d', step)
  os.kill(os.getpid(), signal.SIGTERM)
  return True


def maybe_kill_train_at_step(step: int) -> None:
  """SIGKILLs the training process at the target step: a preemption
  with no grace period (once across restarts with ENV_KILL_TOKEN)."""
  if _env_int(ENV_KILL_TRAIN_AT_STEP) != step:
    return
  if not _claim_token():
    return
  import signal

  os.kill(os.getpid(), signal.SIGKILL)


def injected_device_fault(pack_ordinal: int) -> None:
  """Raises a synthetic device fault when an injection hook targets
  this pack (1-based dispatch ordinal; fires once per process)."""
  if _fire_once(ENV_DEVICE_OOM_AT_PACK, pack_ordinal):
    log.warning('fault injection: device OOM at pack %d', pack_ordinal)
    raise DeviceOomError(f'injected device OOM at pack {pack_ordinal}')
  if _fire_once(ENV_DEVICE_LOST_AT_PACK, pack_ordinal):
    log.warning('fault injection: device lost at pack %d', pack_ordinal)
    raise DeviceLostError(f'injected halted device at pack {pack_ordinal}')


def injected_device_hang(pack_ordinal: int) -> float:
  """Seconds the targeted pack should hang (0.0 when this pack is not
  targeted; fires once per process)."""
  if not _fire_once(ENV_DEVICE_HANG_AT_PACK, pack_ordinal):
    return 0.0
  try:
    hang_s = float(os.environ.get(ENV_DEVICE_HANG_S, '30.0'))
  except ValueError:
    hang_s = 30.0
  log.warning('fault injection: device hang %.1fs at pack %d',
              hang_s, pack_ordinal)
  return hang_s


def preempt_notice_after_s() -> float:
  """Seconds after serve start at which the replica delivers itself a
  preemption notice (0.0: the hook is unarmed); serve/server.py's
  _PreemptionWatch arms a timer with it."""
  raw = os.environ.get(ENV_PREEMPT_AT_S, '')
  if not raw:
    return 0.0
  try:
    return max(0.0, float(raw))
  except ValueError:
    return 0.0
