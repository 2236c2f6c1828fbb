"""Training checkpoints of the port: the state on disk, its integrity
manifest, validation and quarantine.

Port of deepconsensus_tpu/models/checkpoints.py (manifests, validation,
quarantine, the newest valid checkpoint) with its directory layout:

  checkpoints/checkpoint-<step>/state.pt            model, LAMB, dropout
                                                    generator and step
  checkpoints/.manifests/checkpoint-<step>.json     the commit record
  checkpoints/.quarantine/checkpoint-<step>[.N]     with .reason.txt

save_checkpoint writes the state into a temporary directory (fsync),
renames it into place, and only then commits the manifest (atomic write
+ rename): a checkpoint directory without a manifest is one whose save
never finished, and one whose file sizes disagree with the manifest's
inventory was truncated. latest_valid_checkpoint therefore never hands
training a half-written resume source: invalid candidates move to
.quarantine/ and the newest valid one wins. The JAX package's
validate_checkpoint judges these directories the same way.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

log = logging.getLogger(__name__)

_CKPT_NAME_RE = re.compile(r'^checkpoint-(\d+)$')
MANIFEST_DIRNAME = '.manifests'
QUARANTINE_DIRNAME = '.quarantine'
MANIFEST_VERSION = 1
STATE_FILE = 'state.pt'


def _leaves(tree: Any) -> List[Any]:
  """The leaves of nested dicts, lists and tuples (any order: the
  digest sorts them)."""
  if isinstance(tree, dict):
    return [leaf for v in tree.values() for leaf in _leaves(v)]
  if isinstance(tree, (list, tuple)):
    return [leaf for v in tree for leaf in _leaves(v)]
  return [tree]


def _as_numpy(leaf: Any):
  import numpy as np

  if hasattr(leaf, 'detach'):  # a torch tensor
    return leaf.detach().cpu().numpy()
  return np.asarray(leaf)


def tree_digest(tree: Any) -> str:
  """sha256 over a state's leaf contents: dtype, shape and raw bytes of
  each leaf as a numpy array, the leaf digests sorted (so the structure
  and its order do not enter; the reference's tree_digest gives the
  same hex over the same arrays)."""
  leaf_digests = []
  for leaf in _leaves(tree):
    arr = _as_numpy(leaf)
    h = hashlib.sha256()
    h.update(str(arr.dtype).encode())
    h.update(str(arr.shape).encode())
    h.update(arr.tobytes())
    leaf_digests.append(h.hexdigest())
  return hashlib.sha256(''.join(sorted(leaf_digests)).encode()).hexdigest()


def checkpoint_step(ckpt_path: str) -> Optional[int]:
  """Step number encoded in a checkpoint-N directory name, else None."""
  m = _CKPT_NAME_RE.match(os.path.basename(ckpt_path.rstrip(os.sep)))
  return int(m.group(1)) if m else None


def manifest_path(ckpt_path: str) -> str:
  ckpt_path = ckpt_path.rstrip(os.sep)
  return os.path.join(
      os.path.dirname(ckpt_path), MANIFEST_DIRNAME,
      os.path.basename(ckpt_path) + '.json')


def _file_inventory(ckpt_path: str) -> Dict[str, int]:
  """{relative path: size} for every regular file under ckpt_path."""
  inventory: Dict[str, int] = {}
  for root, _, files in os.walk(ckpt_path):
    for name in files:
      full = os.path.join(root, name)
      inventory[os.path.relpath(full, ckpt_path)] = os.path.getsize(full)
  return inventory


def write_manifest(ckpt_path: str, step: int,
                   digest: Optional[str] = None) -> str:
  """Commits the manifest of a checkpoint whose files are on disk
  (atomic write + rename): the manifest's existence is the commit
  record."""
  path = manifest_path(ckpt_path)
  os.makedirs(os.path.dirname(path), exist_ok=True)
  manifest = {
      'version': MANIFEST_VERSION,
      'step': int(step),
      'digest': digest,
      'time': time.time(),
      'files': _file_inventory(ckpt_path),
  }
  tmp = path + '.tmp'
  with open(tmp, 'w') as f:
    json.dump(manifest, f)
    f.flush()
    os.fsync(f.fileno())
  os.replace(tmp, path)
  return path


def read_manifest(ckpt_path: str) -> Optional[Dict[str, Any]]:
  try:
    with open(manifest_path(ckpt_path)) as f:
      return json.load(f)
  except (FileNotFoundError, json.JSONDecodeError):
    return None


def validate_checkpoint(ckpt_path: str) -> Tuple[bool, str]:
  """(ok, reason). Structural validation without loading any tensor: a
  committed manifest whose step matches the directory name and whose
  file inventory matches what is on disk (existence and exact sizes)."""
  if not os.path.isdir(ckpt_path):
    return False, 'not a directory'
  step = checkpoint_step(ckpt_path)
  if step is None:
    return False, 'name does not match checkpoint-<step>'
  manifest = read_manifest(ckpt_path)
  if manifest is None:
    return False, 'no committed manifest (save did not finish?)'
  if manifest.get('version') != MANIFEST_VERSION:
    return False, f'unknown manifest version {manifest.get("version")!r}'
  if manifest.get('step') != step:
    return False, (
        f'manifest step {manifest.get("step")} != directory step {step}')
  recorded = manifest.get('files') or {}
  if not recorded:
    return False, 'manifest records no files'
  for rel, size in recorded.items():
    full = os.path.join(ckpt_path, rel)
    if not os.path.exists(full):
      return False, f'missing file {rel}'
    actual = os.path.getsize(full)
    if actual != size:
      return False, f'size mismatch for {rel}: {actual} != {size}'
  return True, 'ok'


def load_state(ckpt_path: str) -> Dict[str, Any]:
  """The saved state dict of a checkpoint directory (tensors on the
  CPU): 'model', 'optimizer', 'generator', 'step'."""
  import torch

  path = os.path.join(ckpt_path, STATE_FILE)
  if not os.path.exists(path):
    raise FileNotFoundError(f'checkpoint {ckpt_path!r} has no {STATE_FILE}')
  return torch.load(path, map_location='cpu')


def verify_digest(ckpt_path: str) -> bool:
  """Deep verification: reload the state and compare its digest with
  the manifest's (loads every tensor; forensic use, not the resume
  path)."""
  manifest = read_manifest(ckpt_path)
  if manifest is None or not manifest.get('digest'):
    return False
  return tree_digest(load_state(ckpt_path)) == manifest['digest']


def save_checkpoint(ckpt_dir: str, step: int, state: Dict[str, Any]) -> str:
  """Writes checkpoints/checkpoint-<step>/state.pt and commits its
  manifest; returns the checkpoint path.

  The state goes to a temporary directory first (fsync), which is then
  renamed into place. A checkpoint already at this step (the final
  save on an eval boundary) is replaced so that a crash at any moment
  leaves one that latest_valid_checkpoint accepts: its manifest is
  dropped first (an uncommitted directory is skipped), then the
  directories swap, then the new manifest commits."""
  import torch

  os.makedirs(ckpt_dir, exist_ok=True)
  path = os.path.join(ckpt_dir, f'checkpoint-{step}')
  tmp = os.path.join(ckpt_dir, f'.tmp-checkpoint-{step}-{os.getpid()}')
  shutil.rmtree(tmp, ignore_errors=True)
  os.makedirs(tmp)
  with open(os.path.join(tmp, STATE_FILE), 'wb') as f:
    torch.save(state, f)
    f.flush()
    os.fsync(f.fileno())
  digest = tree_digest(state)
  old = None
  if os.path.exists(path):
    try:
      os.remove(manifest_path(path))
    except FileNotFoundError:
      pass
    old = os.path.join(ckpt_dir, f'.old-checkpoint-{step}-{os.getpid()}')
    shutil.rmtree(old, ignore_errors=True)
    os.rename(path, old)
  os.rename(tmp, path)
  write_manifest(path, step, digest=digest)
  if old is not None:
    shutil.rmtree(old, ignore_errors=True)
  return path


def quarantine_checkpoint(ckpt_path: str, reason: str) -> str:
  """Moves a corrupt or uncommitted checkpoint (and its manifest, if
  any) into <ckpt_dir>/.quarantine/ with a .reason.txt beside it, so the
  resume scan never considers it again; returns the new path."""
  ckpt_path = ckpt_path.rstrip(os.sep)
  qdir = os.path.join(os.path.dirname(ckpt_path), QUARANTINE_DIRNAME)
  os.makedirs(qdir, exist_ok=True)
  dest = os.path.join(qdir, os.path.basename(ckpt_path))
  suffix = 0
  while os.path.exists(dest):
    suffix += 1
    dest = os.path.join(qdir, f'{os.path.basename(ckpt_path)}.{suffix}')
  os.rename(ckpt_path, dest)
  src_manifest = manifest_path(ckpt_path)
  if os.path.exists(src_manifest):
    os.rename(src_manifest, dest + '.manifest.json')
  with open(dest + '.reason.txt', 'w') as f:
    f.write(reason + '\n')
  log.warning('quarantined checkpoint %s -> %s (%s)',
              ckpt_path, dest, reason)
  return dest


def _candidate_steps(ckpt_dir: str) -> List[Tuple[int, str]]:
  """(step, path) for checkpoint-N subdirectories, newest first."""
  if not os.path.isdir(ckpt_dir):
    return []
  out = []
  for name in os.listdir(ckpt_dir):
    m = _CKPT_NAME_RE.match(name)
    path = os.path.join(ckpt_dir, name)
    if m and os.path.isdir(path):
      out.append((int(m.group(1)), path))
  return sorted(out, reverse=True)


def latest_valid_checkpoint(ckpt_dir: str,
                            quarantine: bool = True) -> Optional[str]:
  """Newest checkpoint that passes validation; invalid newer ones are
  quarantined (or skipped with quarantine=False), so training falls
  back instead of crash-looping on a half-written resume source.

  A directory where no candidate has a manifest (written before
  manifests) keeps the newest-step rule rather than quarantining a
  whole run's history."""
  candidates = _candidate_steps(ckpt_dir)
  if not candidates:
    return None
  if not any(read_manifest(path) is not None for _, path in candidates):
    newest = candidates[0][1]
    log.warning(
        'checkpoint dir %s has no manifests (written by an older '
        'version?); falling back to newest-step resume: %s',
        ckpt_dir, newest)
    return newest
  for _, path in candidates:
    ok, reason = validate_checkpoint(path)
    if ok:
      return path
    if quarantine:
      try:
        quarantine_checkpoint(path, reason)
      except OSError as e:
        log.warning('could not quarantine %s: %s', path, e)
    else:
      log.warning('skipping invalid checkpoint %s (%s)', path, reason)
  return None


def latest_valid_step(ckpt_dir: str) -> Optional[int]:
  """Step of the newest valid checkpoint, without quarantining
  (read-only: the crash-loop breaker's view of the resume position)."""
  candidates = _candidate_steps(ckpt_dir)
  if candidates and not any(
      read_manifest(path) is not None for _, path in candidates):
    return candidates[0][0]
  for step, path in candidates:
    if validate_checkpoint(path)[0]:
      return step
  return None


def require_valid(ckpt_path: str) -> None:
  """Raises ValueError with validate_checkpoint's reason unless the
  checkpoint is valid (a manifest-less directory included: a source
  handed to `run` or a warm start has nothing to fall back to)."""
  ok, reason = validate_checkpoint(ckpt_path.rstrip(os.sep))
  if not ok:
    raise ValueError(f'invalid checkpoint {ckpt_path!r}: {reason}')
