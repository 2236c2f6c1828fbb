"""Training loop of the port: LAMB, warmup + polynomial decay, periodic
eval with checkpoints, and the reference's fault tolerance.

A port of deepconsensus_tpu/models/train.py for one device. The step is
the reference's: training forward with dropout (each encoder sublayer
recomputed in the backward pass with params.remat), AlignmentLoss (K11
with rows, then K12 in the backward on the card; K13/K14 with
band_width), autograd through the costs and the model, then LAMB
written out per parameter leaf as optax.lamb composes it. Eval metrics
are the reference's run_eval keys: loss, per-example and per-class
accuracy, identity of the CCS and of the prediction, yield over CCS.

Input: the in-memory DatasetIterator, or with params.streaming the
StreamingDataset (loader_workers processes, epochs of n_examples_train
// batch_size steps, reseeded by the resume step); with several
params.window_buckets each batch holds one width and takes its own
step over the one parameter set and LAMB state (the K5-K7 route at 100,
K8-K10 past 128 with use_pallas_attention, K11/K12 at each width);
params.augment applies data.augment_batch to training batches. Two
prefetch layers as in the reference: data.prefetch_iterator runs the
host loader on a thread, and TrainBatchPrefetcher copies batch i + 1
to the card on a copy stream while step i runs.

Fault tolerance, as the reference's single-process Trainer:

* checkpoints (models/checkpoints.py): checkpoints/checkpoint-<step>/
  with a manifest committed after the state is on disk; resume and
  rollback take the newest valid one, invalid ones are quarantined;
* NanSentinel: a non-finite loss or gradient norm is dead-lettered to
  training.failed.jsonl (window ids with params.track_window_ids, else
  the batch's sha1); after nan_sentinel_steps consecutive ones the state
  rolls back to the last valid checkpoint, at most nan_max_rollbacks
  times (then NonFiniteTrainingError). Verdicts are read one step late
  (`pending`), and no checkpoint is written while a non-finite step is
  unresolved;
* PreemptionGuard: SIGTERM or SIGINT saves at the next step boundary
  (manifest, no TSV row) and returns {'preempted': 1.0, 'stop_step'};
* errors of the step reach the caller as faults.classify_device_error
  makes them (CUDA out of memory: DeviceOomError, transient);
  run_training_with_retry restarts on transient errors with backoff and
  a crash-loop breaker;
* warm start (weights only, LAMB fresh at step 0), best_checkpoint.txt
  by params.best_checkpoint_metric, the train tier's MetricsRegistry
  and TensorBoard scalars where the tensorboard package imports;
* fault hooks DCTPU_FAULT_NAN_AT_STEP (in the prefetcher),
  _SIGTERM_AT_STEP and _KILL_TRAIN_AT_STEP (after each step).

Not ported: multi-GPU and elastic training (the preemption stop vote,
--on_device_error degrade), checkpoint_every_n_steps, profile_dir.

Outputs under out_dir: params.json, metrics.jsonl (one JSON object per
logged step, eval, the final summary and a 'faults' split with the
loader's, the prefetcher's and the sentinel's counters and the step
time percentiles), checkpoint_metrics.tsv (eval metrics per
checkpoint), best_checkpoint.txt, checkpoints/, training.failed.jsonl
(non-finite steps), tensorboard/<split>/ and, at the end, weights.npz
for `cli run --weights`.
"""
from __future__ import annotations

import collections
import hashlib
import json
import logging
import os
import queue as queue_lib
import socket
import statistics
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from deepconsensus_tpu_torch import constants
from deepconsensus_tpu_torch import faults as faults_lib
from deepconsensus_tpu_torch.devices import resolve_device
from deepconsensus_tpu_torch.faults import WindowBucketError
from deepconsensus_tpu_torch.io import tfrecord
from deepconsensus_tpu_torch.models import checkpoints as checkpoints_lib
from deepconsensus_tpu_torch.models import config as config_lib
from deepconsensus_tpu_torch.models import data as data_lib
from deepconsensus_tpu_torch.models import losses as losses_lib
from deepconsensus_tpu_torch.models import metrics as metrics_lib
from deepconsensus_tpu_torch.models import model as model_lib
from deepconsensus_tpu_torch.models import weights as weights_lib
from deepconsensus_tpu_torch.obs import metrics as obs_metrics
from deepconsensus_tpu_torch.preprocess.pileup import row_indices

log = logging.getLogger(__name__)


def create_learning_rate_fn(params, decay_steps: int
                            ) -> Callable[[int], float]:
  """Linear warmup into polynomial (power 1) decay: optax's
  polynomial_schedule, and below warmup_steps poly(warmup_steps) *
  (step + 1) / warmup_steps."""
  decay_steps = max(int(decay_steps), 1)
  init = float(params.initial_learning_rate)
  end = float(params.end_learning_rate)

  def poly(step: int) -> float:
    count = min(max(int(step), 0), decay_steps)
    return (init - end) * (1.0 - count / decay_steps) + end

  warmup_steps = int(params.warmup_steps)
  if warmup_steps <= 0:
    return poly

  def schedule(step: int) -> float:
    if step < warmup_steps:
      return poly(warmup_steps) * (step + 1) / warmup_steps
    return poly(step)

  return schedule


def weight_decay_mask(name: str) -> bool:
  """Whether a parameter decays: not biases, ReZero alphas or
  normalization parameters (the reference's rule, on the port's
  '.'-joined names)."""
  parts = name.split('.')
  if parts[-1] in ('bias', 'alpha'):
    return False
  return 'norm' not in '/'.join(parts).lower()


def global_norm(tensors) -> torch.Tensor:
  """sqrt of the sum of squares over every tensor (optax.global_norm)."""
  return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


class Lamb:
  """optax.lamb per parameter leaf: scale_by_adam (eps_root 0), then
  add_decayed_weights where weight_decay_mask allows, then
  scale_by_trust_ratio (ratio 1 where either norm is 0), then -lr(count)
  with the schedule read at the pre-increment count. Parameters update
  in place; the step reads no value back to the host."""

  def __init__(self, named_params, params, decay_steps: int):
    self.params = dict(named_params)
    self.lr_fn = create_learning_rate_fn(params, decay_steps)
    self.b1, self.b2 = float(params.beta_1), float(params.beta_2)
    self.eps = float(params.epsilon)
    self.weight_decay = float(params.weight_decay_rate)
    self.decays = {n: weight_decay_mask(n) for n in self.params}
    self.count = 0
    self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
    self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}

  @torch.no_grad()
  def step(self, grads: Dict[str, torch.Tensor]) -> None:
    b1, b2 = self.b1, self.b2
    count = self.count + 1
    lr = self.lr_fn(self.count)
    c1 = 1.0 - b1 ** count
    c2 = 1.0 - b2 ** count
    for name, p in self.params.items():
      g = grads[name]
      mu = (1.0 - b1) * g + b1 * self.mu[name]
      nu = (1.0 - b2) * (g * g) + b2 * self.nu[name]
      self.mu[name], self.nu[name] = mu, nu
      u = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
      if self.decays[name]:
        u = u + self.weight_decay * p
      p_norm = torch.linalg.vector_norm(p)
      u_norm = torch.linalg.vector_norm(u)
      ratio = torch.where((p_norm == 0) | (u_norm == 0),
                          torch.ones_like(p_norm), p_norm / u_norm)
      p.add_(u * ratio * -lr)
    self.count = count

  def state_dict(self) -> dict:
    return {'count': self.count, 'mu': dict(self.mu), 'nu': dict(self.nu)}

  def load_state_dict(self, state: dict) -> None:
    self.count = int(state['count'])
    for name in self.params:
      self.mu[name].copy_(state['mu'][name])
      self.nu[name].copy_(state['nu'][name])


def make_loss(params, plain: bool = False) -> losses_lib.AlignmentLoss:
  return losses_lib.AlignmentLoss(
      del_cost=params.del_cost, loss_reg=params.loss_reg,
      width=params.get('band_width'), plain=plain)


def ccs_row_from_batch(rows: torch.Tensor, params) -> torch.Tensor:
  """The CCS base row [B, L] of [B, R, L, 1] rows."""
  ccs_row = row_indices(params.max_passes, params.use_ccs_bq)[4][0]
  return rows[:, ccs_row, :, 0]


def batch_to_device(batch: Dict[str, np.ndarray], device
                    ) -> Dict[str, torch.Tensor]:
  return {
      'rows': torch.from_numpy(np.ascontiguousarray(batch['rows'])).to(
          device),
      'label': torch.from_numpy(batch['label']).to(device).long(),
  }


class TrainBatchPrefetcher:
  """Double-buffered batch transfer, the reference's TrainBatchPrefetcher
  on one card: a thread takes host batches, pops their window ids,
  applies the batch fault hook (DCTPU_FAULT_NAN_AT_STEP at the step the
  batch is consumed at on a run without rollback: poison_base_step plus
  its ordinal), pins them and copies them to the card on a copy stream,
  recording an event, while the card runs the step before; the consumer
  makes the compute stream wait on the event. A queue of one ready batch
  plus the one in use: depth two. On the CPU the thread just converts.
  Each item is (window ids or None, host batch, device batch).

  stats(): n_batch_launches, n_batches_prefetched (launches after the
  first, each made while the step before was in flight) and
  train_transfer_overlap_fraction (their ratio; (N - 1) / N on a clean
  N-step run). An error of the host side re-raises at the consumer;
  close() stops the thread and closes the host iterator.
  """

  def __init__(self, batches, device: torch.device,
               poison_base_step: int = 0):
    self._cuda = device.type == 'cuda'
    if self._cuda and device.index is None:
      # The thread makes the device current, which takes an index.
      device = torch.device('cuda', torch.cuda.current_device())
    self._batches = batches
    self._device = device
    self._poison_base = poison_base_step
    self._copy_stream = (torch.cuda.Stream(device) if self._cuda else None)
    self._lock = threading.Lock()
    self._n_launched = 0  # guarded by: self._lock
    self._stop = threading.Event()
    self._queue: queue_lib.Queue = queue_lib.Queue(maxsize=1)
    self._thread = threading.Thread(target=self._produce, daemon=True,
                                    name='train-batch-prefetch')
    self._thread.start()

  def _launch(self, host: Dict[str, np.ndarray]):
    arrays = {'rows': np.ascontiguousarray(host['rows'], np.float32),
              'label': np.asarray(host['label'], np.int64)}
    with self._lock:
      self._n_launched += 1
    if not self._cuda:
      return {k: torch.from_numpy(v) for k, v in arrays.items()}, None
    with torch.cuda.stream(self._copy_stream):
      out = {k: torch.from_numpy(v).pin_memory().to(
          self._device, non_blocking=True) for k, v in arrays.items()}
      event = torch.cuda.Event()
      event.record(self._copy_stream)
    return out, event

  def _put(self, item) -> bool:
    while not self._stop.is_set():
      try:
        self._queue.put(item, timeout=0.1)
        return True
      except queue_lib.Full:
        continue
    return False

  def _produce(self):
    ordinal = self._poison_base
    try:
      if self._cuda:
        torch.cuda.set_device(self._device)
      for host in self._batches:
        if self._stop.is_set():
          return
        names = host.pop('name', None)
        ordinal += 1
        faults_lib.maybe_poison_batch(ordinal, host)
        if not self._put(('batch', (names, host, self._launch(host)))):
          return
      self._put(('end', None))
    except BaseException as e:  # noqa: BLE001 - re-raised at the consumer
      self._put(('error', e))

  def __iter__(self):
    return self

  def __next__(self):
    kind, payload = self._queue.get()
    if kind == 'end':
      raise StopIteration
    if kind == 'error':
      raise payload
    names, host, (batch, event) = payload
    if event is not None:
      compute = torch.cuda.current_stream(self._device)
      compute.wait_event(event)
      for t in batch.values():
        t.record_stream(compute)
    return names, host, batch

  def stats(self) -> Dict[str, float]:
    with self._lock:
      launched = self._n_launched
    overlapped = max(launched - 1, 0)
    return {
        'n_batch_launches': float(launched),
        'n_batches_prefetched': float(overlapped),
        'train_transfer_overlap_fraction': (
            round(overlapped / launched, 4) if launched else 0.0),
    }

  def close(self) -> None:
    self._stop.set()
    while self._thread.is_alive():
      try:
        self._queue.get(timeout=0.1)
      except queue_lib.Empty:
        pass
    self._thread.join()
    close = getattr(self._batches, 'close', None)
    if close is not None:
      close()


def train_step(model: model_lib.DeepConsensusModel, optimizer: Lamb,
               loss_fn: losses_lib.AlignmentLoss,
               batch: Dict[str, torch.Tensor],
               generator: torch.Generator) -> Dict[str, torch.Tensor]:
  """One step on a device batch; returns device scalars under the
  reference's keys (loss, grad_norm, accuracy_correct/total)."""
  for p in model.parameters():
    p.grad = None
  preds = model.forward_train(batch['rows'], generator)
  loss = loss_fn(batch['label'], preds)
  loss.backward()
  grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
           for n, p in model.named_parameters()}
  grad_norm = global_norm(grads.values())
  optimizer.step(grads)
  correct, total = metrics_lib.per_example_accuracy_counts(
      batch['label'], preds.detach())
  return {'loss': loss.detach(), 'grad_norm': grad_norm,
          'accuracy_correct': correct, 'accuracy_total': total}


@torch.no_grad()
def eval_step(model: model_lib.DeepConsensusModel,
              loss_fn: losses_lib.AlignmentLoss,
              batch: Dict[str, torch.Tensor], params,
              alignment_metric: metrics_lib.AlignmentMetric
              ) -> Dict[str, float]:
  """Loss, accuracy counts and the CCS / prediction identities of one
  batch, no dropout (the DP runs K11 without rows)."""
  preds = model.forward_train(batch['rows'])
  loss = loss_fn(batch['label'], preds)
  correct, total = metrics_lib.per_example_accuracy_counts(
      batch['label'], preds)
  id_ccs, id_pred = metrics_lib.batch_identity_ccs_pred(
      ccs_row_from_batch(batch['rows'], params), preds, batch['label'],
      alignment_metric)
  out = {'loss': loss, 'accuracy_correct': correct, 'accuracy_total': total,
         'identity_ccs': id_ccs, 'identity_pred': id_pred}
  for cls in range(constants.SEQ_VOCAB_SIZE):
    c, t = metrics_lib.per_class_accuracy_counts(batch['label'], preds, cls)
    out[f'class{cls}_correct'] = c
    out[f'class{cls}_total'] = t
  return {k: float(v) for k, v in out.items()}


def run_eval(model, loss_fn, eval_ds: data_lib.DatasetIterator, device,
             params) -> Dict[str, float]:
  """One eval epoch aggregated to the reference's eval/* metrics: loss
  and identities as batch means, yield over CCS from YieldOverCCS
  updated per batch, and every class key."""
  sums: Dict[str, float] = {}
  batches = 0
  alignment_metric = metrics_lib.AlignmentMetric()
  yield_metric = metrics_lib.YieldOverCCS()
  for batch in eval_ds.epoch():
    out = eval_step(model, loss_fn, batch_to_device(batch, device), params,
                    alignment_metric)
    yield_metric.update(out['identity_ccs'], out['identity_pred'])
    for k, v in out.items():
      sums[k] = sums.get(k, 0.0) + v
    batches += 1
  if not batches:
    return {}
  result = {
      'eval/loss': sums['loss'] / batches,
      constants.MAIN_EVAL_METRIC_NAME: (
          sums['accuracy_correct'] / max(sums['accuracy_total'], 1)),
      'eval/identity_ccs': sums['identity_ccs'] / batches,
      'eval/identity_pred': sums['identity_pred'] / batches,
      'eval/yield_over_ccs': yield_metric.result(),
  }
  for cls in range(constants.SEQ_VOCAB_SIZE):
    total = sums.get(f'class{cls}_total', 0.0)
    result[f'eval/class{cls}_accuracy'] = (
        sums[f'class{cls}_correct'] / total if total else 0.0)
  return result


class _Sidecars:
  """The reference Trainer's log and save side under out_dir:
  metrics.jsonl, checkpoint_metrics.tsv (its header taken at the first
  write), best_checkpoint.txt (the row with the highest
  params.best_checkpoint_metric; the best value recovered from the TSV
  after a restart), the train tier's MetricsRegistry (a gauge per
  logged scalar, the train_step_s histogram) and TensorBoard scalars
  under tensorboard/<split> where the tensorboard package imports
  (imported at the first log)."""

  def __init__(self, out_dir: str, params):
    self.out_dir = out_dir
    self.jsonl = os.path.join(out_dir, 'metrics.jsonl')
    self.tsv = os.path.join(out_dir, 'checkpoint_metrics.tsv')
    self.best_file = os.path.join(out_dir, 'best_checkpoint.txt')
    self.obs = obs_metrics.MetricsRegistry(tier='train')
    self.step_time_hist = self.obs.histogram(
        'train_step_s', help='wall time per training step')
    self.best_metric_name = (params.get('best_checkpoint_metric')
                             or constants.MAIN_EVAL_METRIC_NAME)
    self.best_metric = -1.0
    self.tsv_columns = None
    self._tb_writers: Dict[str, Any] = {}
    if os.path.exists(self.tsv):
      with open(self.tsv) as f:
        self.tsv_columns = f.readline().strip().split('\t')[1:]
        if self.best_metric_name in self.tsv_columns:
          idx = 1 + self.tsv_columns.index(self.best_metric_name)
          for line in f:
            parts = line.strip().split('\t')
            try:
              self.best_metric = max(self.best_metric, float(parts[idx]))
            except (IndexError, ValueError):
              continue

  def log(self, step: int, split: str, metrics: Dict[str, float]) -> None:
    for name, value in metrics.items():
      try:
        self.obs.set_gauge(f'{split}/{name}', float(value))
      except (TypeError, ValueError):
        continue
    entry = {'step': step, 'split': split, 'time': time.time(), **metrics}
    with open(self.jsonl, 'a') as f:
      f.write(json.dumps(entry) + '\n')
    self._write_tensorboard(step, split, metrics)

  def _write_tensorboard(self, step: int, split: str,
                         metrics: Dict[str, float]) -> None:
    """Scalars as TensorBoard Event protos (the tensorboard package's)
    in a TFRecord events file under tensorboard/<split>; a no-op without
    the package. tensorboard's own writer is not used: where TensorFlow
    is installed it imports it, tens of seconds in every process."""
    if split not in self._tb_writers:
      try:
        from tensorboard.compat.proto import event_pb2
      except ImportError:
        self._tb_writers[split] = None
      else:
        logdir = os.path.join(self.out_dir, 'tensorboard', split)
        os.makedirs(logdir, exist_ok=True)
        writer = tfrecord.TFRecordWriter(os.path.join(
            logdir, f'events.out.tfevents.{time.time_ns()}.'
            f'{socket.gethostname()}'))
        writer.write(event_pb2.Event(
            wall_time=time.time(),
            file_version='brain.Event:2').SerializeToString())
        self._tb_writers[split] = (writer, event_pb2)
    if self._tb_writers[split] is None:
      return
    writer, event_pb2 = self._tb_writers[split]
    event = event_pb2.Event(wall_time=time.time(), step=step)
    for name, value in metrics.items():
      try:
        event.summary.value.add(tag=name, simple_value=float(value))
      except (TypeError, ValueError):
        continue
    writer.write(event.SerializeToString())
    writer.flush()

  def checkpoint_row(self, step: int, eval_metrics: Dict[str, float]
                     ) -> None:
    """The TSV row and best_checkpoint.txt of a checkpoint saved after
    an eval."""
    if self.tsv_columns is None or not os.path.exists(self.tsv):
      self.tsv_columns = sorted(eval_metrics)
      with open(self.tsv, 'a') as f:
        f.write('checkpoint\t' + '\t'.join(self.tsv_columns) + '\n')
    with open(self.tsv, 'a') as f:
      f.write(f'checkpoint-{step}\t' + '\t'.join(
          str(eval_metrics.get(k, 'nan')) for k in self.tsv_columns) + '\n')
    if self.best_metric_name not in eval_metrics:
      log.warning(
          'best_checkpoint_metric %r not among eval metrics %s; '
          'best_checkpoint.txt will not update',
          self.best_metric_name, sorted(eval_metrics))
    main = eval_metrics.get(self.best_metric_name, -1.0)
    if main > self.best_metric:
      self.best_metric = main
      with open(self.best_file, 'w') as f:
        f.write(f'checkpoint-{step}\n')

  def close(self) -> None:
    for entry in self._tb_writers.values():
      if entry is not None:
        entry[0].close()
    self._tb_writers = {}


class PreemptionGuard:
  """SIGTERM / SIGINT -> a checkpoint at the next step boundary, then a
  clean return (the reference's guard on one process). The handler only
  sets a flag, which the loop reads once a step; a second signal raises
  KeyboardInterrupt. restore() puts the previous handlers back. Outside
  the main thread the handlers cannot be installed, and training keeps
  the default ones."""

  def __init__(self):
    self._event = threading.Event()
    self._prev: Dict[int, Any] = {}

  def install(self) -> 'PreemptionGuard':
    import signal

    for sig in (signal.SIGTERM, signal.SIGINT):
      try:
        self._prev[sig] = signal.signal(sig, self._handle)
      except ValueError:
        pass
    return self

  def _handle(self, signum, frame):
    del frame
    if self._event.is_set():
      raise KeyboardInterrupt(
          f'second signal {signum} during checkpoint-and-exit')
    self._event.set()
    log.warning('signal %s received; will checkpoint and exit at the next '
                'step boundary (send again to abort immediately)', signum)

  def requested(self) -> bool:
    return self._event.is_set()

  def restore(self) -> None:
    import signal

    for sig, prev in self._prev.items():
      try:
        signal.signal(sig, prev)
      except ValueError:
        pass
    self._prev = {}


class NanSentinel:
  """Watches each step's loss and gradient norm; after `limit`
  consecutive non-finite steps the loop rolls back to the last valid
  checkpoint (LAMB updates the parameters in place, so a NaN update
  poisons them for good). Every non-finite step is dead-lettered to
  <out_dir>/training.failed.jsonl with the batch's window ids
  (params.track_window_ids) or a fingerprint of its rows."""

  def __init__(self, params, out_dir: str):
    self.limit = int(params.get('nan_sentinel_steps', 3) or 0)
    self.max_rollbacks = int(params.get('nan_max_rollbacks', 2) or 0)
    self.enabled = self.limit > 0
    self.consecutive = 0
    self.rollbacks = 0
    self.counters: collections.Counter = collections.Counter()
    self._dead_letter = None
    if self.enabled:
      self._dead_letter = faults_lib.DeadLetterWriter(
          os.path.join(out_dir, 'training.failed.jsonl'), append=True)

  def observe(self, step: int, metrics: Dict[str, Any], names,
              batch: Optional[Dict[str, np.ndarray]]) -> bool:
    """True (and a dead letter) when this step's loss or gradient norm
    is not finite."""
    loss = float(metrics['loss'])
    grad_norm = float(metrics.get('grad_norm', 0.0))
    if np.isfinite(loss) and np.isfinite(grad_norm):
      self.consecutive = 0
      return False
    self.consecutive += 1
    self.counters['n_nonfinite_steps'] += 1
    extra: Dict[str, Any] = {'step': step, 'loss': loss,
                             'grad_norm': grad_norm}
    if names is not None:
      extra['window_ids'] = [
          n.decode('utf-8', 'replace') if isinstance(n, bytes) else str(n)
          for n in names]
    elif batch is not None and 'rows' in batch:
      extra['batch_sha1'] = hashlib.sha1(
          np.ascontiguousarray(batch['rows']).tobytes()).hexdigest()[:16]
    will_roll = self.consecutive >= self.limit
    if self._dead_letter is not None:
      self._dead_letter.record(
          None, 'train', faults_lib.FaultKind.TRANSIENT,
          f'non-finite training step: loss={loss} grad_norm={grad_norm}',
          'rollback' if will_roll else 'recorded', extra=extra)
    log.warning('non-finite training step %d (loss=%s grad_norm=%s; %d/%d '
                'consecutive)', step, loss, grad_norm, self.consecutive,
                self.limit)
    return True

  def should_rollback(self) -> bool:
    return self.enabled and self.consecutive >= self.limit

  def rolled_back(self, checkpoint: str) -> None:
    self.rollbacks += 1
    self.consecutive = 0
    self.counters['n_nan_rollbacks'] += 1
    log.warning('NaN sentinel: rolled back to %s (rollback %d/%d)',
                checkpoint, self.rollbacks, self.max_rollbacks)

  def close(self) -> None:
    if self._dead_letter is not None:
      self._dead_letter.close()


def run_training(
    params,
    out_dir: str,
    train_patterns=None,
    eval_patterns=None,
    num_epochs: Optional[int] = None,
    device=None,
    plain: bool = False,
    warm_start: Optional[str] = None,
) -> Dict[str, float]:
  """Trains on the card (device='cpu' for the CPU); resumes from the
  newest valid checkpoint in out_dir. plain=True runs the alignment DP's
  plain version on any device (the on-card reference run). warm_start:
  a checkpoint directory whose weights seed the first start (LAMB
  fresh, step 0), ignored once out_dir has a valid checkpoint. Returns
  the final eval metrics, or {'preempted': 1.0, 'stop_step': step}
  after SIGTERM / SIGINT."""
  device = resolve_device(device)
  train_patterns = train_patterns or params.get('train_path')
  eval_patterns = eval_patterns or params.get('eval_path')
  if not train_patterns or not eval_patterns:
    raise ValueError('training needs train and eval TFRecord patterns '
                     '(--train_path, --eval_path)')
  try:
    # One step a bucket width over one parameter set: the set must be
    # valid (strictly ascending, the smallest max_length) from the start.
    config_lib.resolve_window_buckets(params)
  except ValueError as e:
    raise WindowBucketError(str(e)) from e
  num_epochs = int(num_epochs or params.num_epochs)
  loss_fn = make_loss(params, plain)
  streaming = bool(params.get('streaming', False))
  train_ds = None
  if streaming:
    # Epochs become fixed step counts; the stream itself is made after
    # the checkpoint restore, reseeded by the resume step.
    n_train = int(params.get('n_examples_train', 0) or 0)
    if n_train < params.batch_size:
      raise ValueError(
          'streaming training requires params.n_examples_train (>= one '
          'batch) to size the step budget')
    steps_per_epoch = n_train // params.batch_size
  else:
    train_ds = data_lib.DatasetIterator(
        patterns=train_patterns, params=params,
        batch_size=params.batch_size, seed=params.seed)
    steps_per_epoch = train_ds.steps_per_epoch
  eval_ds = data_lib.DatasetIterator(
      patterns=eval_patterns, params=params, batch_size=params.batch_size,
      shuffle=False)
  decay_steps = steps_per_epoch * params.get('num_epochs_for_decay',
                                             num_epochs)
  os.makedirs(out_dir, exist_ok=True)
  config_lib.save_params_as_json(out_dir, params)
  sidecars = _Sidecars(out_dir, params)
  ckpt_dir = os.path.join(os.path.abspath(out_dir), 'checkpoints')

  model = model_lib.DeepConsensusModel(params, device=device)
  # Flax initializes the ReZero alphas at zero.
  model.init_weights(torch.Generator().manual_seed(int(params.seed)),
                     alpha_range=(0.0, 0.0))
  model.requires_grad_(True)
  optimizer = Lamb(model.named_parameters(), params, decay_steps)
  generator = torch.Generator(device=device).manual_seed(int(params.seed))

  def restore(path: str) -> int:
    saved = checkpoints_lib.load_state(path)
    model.load_state_dict(saved['model'])
    optimizer.load_state_dict(saved['optimizer'])
    generator.set_state(saved['generator'])
    return int(saved['step'])

  save_seconds = []

  def save(at_step: int, eval_metrics: Dict[str, float]) -> None:
    """The checkpoint and its manifest; with eval metrics (not at an
    emergency save) the TSV row and best_checkpoint.txt."""
    t0 = time.perf_counter()
    checkpoints_lib.save_checkpoint(ckpt_dir, at_step, {
        'model': model.state_dict(), 'optimizer': optimizer.state_dict(),
        'generator': generator.get_state(), 'step': at_step})
    save_seconds.append(time.perf_counter() - t0)
    if eval_metrics:
      sidecars.checkpoint_row(at_step, eval_metrics)

  # Crash resume from the newest VALID checkpoint (a truncated or
  # uncommitted one is quarantined and the one before wins); it always
  # wins over warm_start, which seeds only the very first start.
  step = 0
  resume_from = checkpoints_lib.latest_valid_checkpoint(ckpt_dir)
  if warm_start and resume_from is not None:
    log.warning('warm_start=%s ignored: %s already has checkpoints; '
                'resuming from the latest instead', warm_start, out_dir)
  elif warm_start:
    checkpoints_lib.require_valid(warm_start)
    model.load_state_dict(checkpoints_lib.load_state(warm_start)['model'])
  if resume_from:
    step = restore(resume_from)

  stream_ds = None
  if streaming:
    # A restarted run draws a fresh stream, not the corpus' head again.
    stream_ds = data_lib.StreamingDataset(
        patterns=train_patterns, params=params,
        batch_size=params.batch_size,
        buffer_size=int(params.get('buffer_size', 100_000)),
        workers=int(params.get('loader_workers', 0) or 0),
        seed=int(params.seed) + step,
        on_shard_error=params.get('on_shard_error', 'fail'))

  def train_batches() -> Iterator[Dict[str, np.ndarray]]:
    if streaming:
      it = iter(stream_ds)
      try:
        for _ in range(max(steps_per_epoch * num_epochs - step, 0)):
          yield next(it)
      finally:
        it.close()
      return
    steps_to_skip = step
    for _ in range(num_epochs):
      for batch in train_ds.epoch():
        if steps_to_skip > 0:  # already covered by the checkpoint
          steps_to_skip -= 1
          continue
        yield batch

  def maybe_augmented() -> Iterator[Dict[str, np.ndarray]]:
    # Training batches only; seeded by the resume step, so a resumed run
    # draws a fresh augmentation stream.
    batches = train_batches()
    if not params.get('augment', False):
      yield from batches
      return
    aug_rng = np.random.default_rng(int(params.seed) + 7919 * (step + 1))
    try:
      for b in batches:
        yield data_lib.augment_batch(b, params, aug_rng)
    finally:
      batches.close()

  eval_every = int(params.get('eval_every_n_steps', 3000))
  log_every = int(params.get('log_every_n_steps', 100))
  if device.type == 'cuda':
    torch.cuda.reset_peak_memory_stats(device)
  step_seconds = []
  seconds_by_width: Dict[int, list] = {}
  final_metrics: Dict[str, float] = {}
  guard = PreemptionGuard().install()
  sentinel = NanSentinel(params, out_dir)
  # The sentinel reads each verdict one step late, as the reference
  # does: pending is (step, metrics, window ids, host batch) of the step
  # not yet judged. After a rollback the batch stream does not rewind,
  # so when the verdict lands decides which batches follow.
  pending = None

  def rollback() -> None:
    nonlocal step, pending
    if sentinel.rollbacks >= sentinel.max_rollbacks:
      raise faults_lib.NonFiniteTrainingError(
          f'training diverged: non-finite steps persisted through '
          f'{sentinel.rollbacks} rollback(s); refusing to roll back again '
          f'(params.nan_max_rollbacks={sentinel.max_rollbacks})')
    latest = checkpoints_lib.latest_valid_checkpoint(ckpt_dir)
    if latest is None:
      raise faults_lib.NonFiniteTrainingError(
          f'training diverged after {sentinel.consecutive} consecutive '
          f'non-finite step(s) at step {step} and no valid checkpoint '
          'exists to roll back to')
    step = restore(latest)
    pending = None
    sentinel.rolled_back(latest)

  preempted = False
  prefetcher = None
  try:
    # Two prefetch layers: the host loader on a thread, and the H2D copy
    # of batch i + 1 under step i.
    prefetcher = TrainBatchPrefetcher(
        data_lib.prefetch_iterator(maybe_augmented()), device,
        poison_base_step=step)
    for names, host_batch, batch in prefetcher:
      width = int(batch['rows'].shape[2])
      t0 = time.perf_counter()
      try:
        m = train_step(model, optimizer, loss_fn, batch, generator)
        if device.type == 'cuda':
          torch.cuda.synchronize(device)
      except Exception as e:  # noqa: BLE001 - typed for the retry loop
        err = faults_lib.classify_device_error(e)
        if err is e:
          raise
        raise err
      step_seconds.append(time.perf_counter() - t0)
      seconds_by_width.setdefault(width, []).append(step_seconds[-1])
      sidecars.step_time_hist.observe(step_seconds[-1])
      step += 1
      faults_lib.maybe_kill_train_at_step(step)
      faults_lib.maybe_sigterm_at_step(step)
      if sentinel.enabled:
        if pending is not None and sentinel.observe(*pending):
          if sentinel.should_rollback():
            rollback()
            continue
        pending = (step, m, names, host_batch)
      if step % log_every == 0:
        m_host = {k: float(v) for k, v in m.items()}
        m_host['train/accuracy'] = m_host['accuracy_correct'] / max(
            m_host['accuracy_total'], 1)
        m_host['step_seconds'] = step_seconds[-1]
        m_host['window_width'] = width
        sidecars.log(step, 'train', m_host)
      if step % eval_every == 0:
        # Resolve the delayed verdict before checkpointing: a save made
        # while the state holds a non-finite update would become the
        # checkpoint a rollback restores.
        if sentinel.enabled and pending is not None:
          sentinel.observe(*pending)
          pending = None
        if sentinel.should_rollback():
          rollback()
          continue
        if sentinel.consecutive:
          log.warning('skipping eval/checkpoint at step %d: state '
                      'contaminated by a non-finite update (%d/%d '
                      'consecutive)', step, sentinel.consecutive,
                      sentinel.limit)
        else:
          final_metrics = run_eval(model, loss_fn, eval_ds, device, params)
          sidecars.log(step, 'eval', final_metrics)
          save(step, final_metrics)
      if guard.requested():
        # An emergency checkpoint at the step boundary (no eval, no TSV
        # row), then a clean return; a restart resumes from it.
        if sentinel.enabled and pending is not None:
          sentinel.observe(*pending)
          pending = None
        if sentinel.consecutive:
          log.warning('skipping emergency checkpoint at step %d: state '
                      'contaminated by a non-finite update; resume will '
                      'fall back to the last valid checkpoint', step)
        else:
          save(step, {})
        final_metrics = {'preempted': 1.0, 'stop_step': float(step)}
        preempted = True
        log.warning('preemption checkpoint saved at step %d; exiting '
                    'cleanly', step)
        break
    if not preempted:
      if sentinel.enabled and pending is not None:
        sentinel.observe(*pending)
        pending = None
      if sentinel.enabled and sentinel.consecutive:
        # Out of data with a contaminated state: roll back even below
        # the threshold rather than finish (and save) a NaN state.
        rollback()
      final_metrics = run_eval(model, loss_fn, eval_ds, device, params)
      sidecars.log(step, 'eval', final_metrics)
      save(step, final_metrics)
      weights_lib.save_npz(os.path.join(out_dir, 'weights.npz'),
                           weights_lib.to_flax_params(model.state_dict()))
    summary = {'steps_run': float(len(step_seconds))}
    if step_seconds:
      p50 = statistics.median(step_seconds)
      summary.update(train_step_p50_s=p50,
                     train_examples_per_s=params.batch_size / p50)
      for width, seconds in sorted(seconds_by_width.items()):
        summary[f'train_step_p50_s_width_{width}'] = statistics.median(
            seconds)
    if save_seconds:
      summary.update(checkpoint_saves=float(len(save_seconds)),
                     checkpoint_save_p50_s=statistics.median(save_seconds))
    if device.type == 'cuda':
      summary['peak_bytes'] = float(torch.cuda.max_memory_allocated(device))
    sidecars.log(step, 'summary', summary)
  finally:
    if prefetcher is not None:
      prefetcher.close()
    guard.restore()
    sentinel.close()
    # The loader's counters (batches per bucket, padding, shard faults,
    # parses per worker), the distinct step geometries (one per bucket
    # width on a clean run), the transfer overlap, the sentinel's counts
    # and the step time percentiles.
    counters: Dict[str, float] = {k: float(v)
                                  for k, v in sentinel.counters.items()}
    counters.update({k: float(v) for k, v in (
        stream_ds or train_ds).counters.items()})
    counters['n_train_forward_shapes'] = float(len(seconds_by_width))
    total = counters.get('n_train_window_positions', 0.0)
    if total:
      counters['train_padding_fraction'] = (
          counters.get('n_train_padded_positions', 0.0) / total)
    if prefetcher is not None:
      counters.update(prefetcher.stats())
    step_times = sidecars.step_time_hist.percentiles()
    if step_times['count']:
      counters['train_step_p50_s'] = step_times['p50']
      counters['train_step_p99_s'] = step_times['p99']
    sidecars.log(step, 'faults', counters)
    sidecars.close()
  return final_metrics


_UNSET = object()


def run_training_with_retry(*args, max_retries: int = 1_000_000,
                            backoff_base: float = 0.5,
                            backoff_max: float = 60.0,
                            max_stalled_restarts: int = 3, **kwargs):
  """run_training, restarted from the newest valid checkpoint on a
  transient failure (faults.classify_error of 'Type: message'; a CUDA
  out-of-memory step arrives as DeviceOomError, transient), with the
  reference's brakes: a permanent error (bad config or data, a diverged
  model, a lost device) raises at once; backoff_base * 2^k seconds
  between attempts, capped at backoff_max; and when the resume step
  (checkpoints.latest_valid_step, read-only) has not advanced across
  max_stalled_restarts consecutive restarts, CrashLoopError."""
  out_dir = kwargs.get('out_dir')
  if out_dir is None and len(args) >= 2 and isinstance(args[1], str):
    out_dir = args[1]
  attempts = 0
  last_step = _UNSET
  stalled = 0
  while True:
    try:
      return run_training(*args, **kwargs)
    except Exception as e:  # noqa: BLE001 - classified below
      message = f'{type(e).__name__}: {e}'
      attempts += 1
      if faults_lib.classify_error(message) != faults_lib.FaultKind.TRANSIENT:
        raise
      if attempts > max_retries:
        raise
      if out_dir is not None:
        resume_step = checkpoints_lib.latest_valid_step(
            os.path.join(os.path.abspath(out_dir), 'checkpoints'))
        if last_step is not _UNSET and resume_step == last_step:
          stalled += 1
          if stalled >= max_stalled_restarts:
            raise faults_lib.CrashLoopError(
                f'training failed {stalled + 1} consecutive time(s) '
                f'without the resume step advancing past {resume_step}; '
                'aborting instead of crash-looping (last error: '
                f'{message.splitlines()[0]})') from e
        else:
          stalled = 0
        last_step = resume_step
      delay = min(backoff_max, backoff_base * (2 ** (attempts - 1)))
      log.warning('transient failure (%s); restarting from latest valid '
                  'checkpoint in %.1fs (attempt %d)',
                  message.splitlines()[0], delay, attempts)
      time.sleep(delay)
