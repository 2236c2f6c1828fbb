"""Training loop of the port: LAMB, warmup + polynomial decay, periodic
eval with checkpoints, crash resume.

A trimmed port of deepconsensus_tpu/models/train.py for one device. The
step is the reference's: training forward with dropout, AlignmentLoss
(K11 with rows, then K12 in the backward on the card; K13/K14 with
band_width), autograd through the costs and the model, then LAMB
written out per parameter leaf as optax.lamb composes it. Metrics keep
the reference's keys, minus the identity metrics. Not ported (ROADMAP:
training features): streaming loader and workers, augmentation,
bucketed training, the NaN sentinel and rollback, multi-GPU and
elastic training, preemption, TensorBoard and the metrics registry,
warm start.

Outputs under out_dir: params.json, metrics.jsonl (one JSON object per
logged step, eval and the final summary), checkpoint_metrics.tsv (eval
metrics per checkpoint), checkpoints/checkpoint-<step>.pt (model,
optimizer, step and dropout generator; a restart resumes from the
newest) and, at the end, weights.npz for `cli run --weights`.
"""
from __future__ import annotations

import json
import os
import re
import statistics
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from deepconsensus_tpu_torch import constants
from deepconsensus_tpu_torch.devices import resolve_device
from deepconsensus_tpu_torch.models import config as config_lib
from deepconsensus_tpu_torch.models import data as data_lib
from deepconsensus_tpu_torch.models import losses as losses_lib
from deepconsensus_tpu_torch.models import metrics as metrics_lib
from deepconsensus_tpu_torch.models import model as model_lib
from deepconsensus_tpu_torch.models import weights as weights_lib
from deepconsensus_tpu_torch.preprocess.pileup import row_indices


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
              batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
  """Loss and accuracy counts of one batch, no dropout (the DP runs K11
  without rows)."""
  preds = model.forward_train(batch['rows'])
  loss = loss_fn(batch['label'], preds)
  correct, total = metrics_lib.per_example_accuracy_counts(
      batch['label'], preds)
  out = {'loss': loss, 'accuracy_correct': correct, 'accuracy_total': total}
  for cls in range(constants.SEQ_VOCAB_SIZE):
    c, t = metrics_lib.per_class_accuracy_counts(batch['label'], preds, cls)
    out[f'class{cls}_correct'] = c
    out[f'class{cls}_total'] = t
  return {k: float(v) for k, v in out.items()}


def run_eval(model, loss_fn, eval_ds: data_lib.DatasetIterator,
             device) -> Dict[str, float]:
  """One eval epoch aggregated to the eval/* metrics."""
  sums: Dict[str, float] = {}
  batches = 0
  for batch in eval_ds.epoch():
    for k, v in eval_step(model, loss_fn, batch_to_device(batch,
                                                          device)).items():
      sums[k] = sums.get(k, 0.0) + v
    batches += 1
  if not batches:
    return {}
  result = {
      'eval/loss': sums['loss'] / batches,
      constants.MAIN_EVAL_METRIC_NAME: (
          sums['accuracy_correct'] / max(sums['accuracy_total'], 1)),
  }
  for cls in range(constants.SEQ_VOCAB_SIZE):
    total = sums[f'class{cls}_total']
    result[f'eval/class{cls}_accuracy'] = (
        sums[f'class{cls}_correct'] / total if total else 0.0)
  return result


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
  """The checkpoint-<step>.pt with the highest step, or None."""
  if not os.path.isdir(ckpt_dir):
    return None
  steps = [int(m.group(1)) for m in (
      re.fullmatch(r'checkpoint-(\d+)\.pt', f) for f in os.listdir(ckpt_dir))
           if m]
  if not steps:
    return None
  return os.path.join(ckpt_dir, f'checkpoint-{max(steps)}.pt')


class _Sidecars:
  """metrics.jsonl and checkpoint_metrics.tsv under out_dir."""

  def __init__(self, out_dir: str):
    self.jsonl = os.path.join(out_dir, 'metrics.jsonl')
    self.tsv = os.path.join(out_dir, 'checkpoint_metrics.tsv')

  def log(self, step: int, split: str, metrics: Dict[str, float]) -> None:
    entry = {'step': step, 'split': split, 'time': time.time(), **metrics}
    with open(self.jsonl, 'a') as f:
      f.write(json.dumps(entry) + '\n')

  def checkpoint_row(self, step: int, metrics: Dict[str, float]) -> None:
    if not metrics:
      return
    if os.path.exists(self.tsv):
      with open(self.tsv) as f:
        columns = f.readline().rstrip('\n').split('\t')[1:]
    else:
      columns = sorted(metrics)
      with open(self.tsv, 'w') as f:
        f.write('checkpoint\t' + '\t'.join(columns) + '\n')
    with open(self.tsv, 'a') as f:
      f.write(f'checkpoint-{step}\t' + '\t'.join(
          str(metrics.get(k, 'nan')) for k in columns) + '\n')


def run_training(
    params,
    out_dir: str,
    train_patterns=None,
    eval_patterns=None,
    num_epochs: Optional[int] = None,
    device=None,
    plain: bool = False,
) -> Dict[str, float]:
  """Trains on the card (device='cpu' for the CPU); resumes from the
  newest checkpoint in out_dir. plain=True runs the alignment DP's plain
  version on any device (the on-card reference run). Returns the final
  eval metrics."""
  device = resolve_device(device)
  train_patterns = train_patterns or params.get('train_path')
  eval_patterns = eval_patterns or params.get('eval_path')
  if not train_patterns or not eval_patterns:
    raise ValueError('training needs train and eval TFRecord patterns '
                     '(--train_path, --eval_path)')
  num_epochs = int(num_epochs or params.num_epochs)
  loss_fn = make_loss(params, plain)
  train_ds = data_lib.DatasetIterator(
      patterns=train_patterns, params=params, batch_size=params.batch_size,
      seed=params.seed)
  eval_ds = data_lib.DatasetIterator(
      patterns=eval_patterns, params=params, batch_size=params.batch_size,
      shuffle=False)
  decay_steps = train_ds.steps_per_epoch * params.get('num_epochs_for_decay',
                                                      num_epochs)
  os.makedirs(out_dir, exist_ok=True)
  config_lib.save_params_as_json(out_dir, params)
  sidecars = _Sidecars(out_dir)
  ckpt_dir = os.path.join(out_dir, 'checkpoints')

  model = model_lib.DeepConsensusModel(params, device=device)
  # Flax initializes the ReZero alphas at zero.
  model.init_weights(torch.Generator().manual_seed(int(params.seed)),
                     alpha_range=(0.0, 0.0))
  model.requires_grad_(True)
  optimizer = Lamb(model.named_parameters(), params, decay_steps)
  generator = torch.Generator(device=device).manual_seed(int(params.seed))
  step = 0
  resume_from = latest_checkpoint(ckpt_dir)
  if resume_from:
    saved = torch.load(resume_from, map_location='cpu')
    model.load_state_dict(saved['model'])
    optimizer.load_state_dict(saved['optimizer'])
    generator.set_state(saved['generator'])
    step = int(saved['step'])

  def save(at_step: int, eval_metrics: Dict[str, float]) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f'checkpoint-{at_step}.pt')
    torch.save({'model': model.state_dict(),
                'optimizer': optimizer.state_dict(), 'step': at_step,
                'generator': generator.get_state()}, path + '.tmp')
    os.replace(path + '.tmp', path)
    sidecars.checkpoint_row(at_step, eval_metrics)

  def train_batches() -> Iterator[Dict[str, np.ndarray]]:
    steps_to_skip = step
    for _ in range(num_epochs):
      for batch in train_ds.epoch():
        if steps_to_skip > 0:  # already covered by the checkpoint
          steps_to_skip -= 1
          continue
        yield batch

  eval_every = int(params.get('eval_every_n_steps', 3000))
  log_every = int(params.get('log_every_n_steps', 100))
  if device.type == 'cuda':
    torch.cuda.reset_peak_memory_stats(device)
  step_seconds = []
  final_metrics: Dict[str, float] = {}
  for host_batch in train_batches():
    t0 = time.perf_counter()
    m = train_step(model, optimizer, loss_fn,
                   batch_to_device(host_batch, device), generator)
    if device.type == 'cuda':
      torch.cuda.synchronize(device)
    step_seconds.append(time.perf_counter() - t0)
    step += 1
    if step % log_every == 0:
      m_host = {k: float(v) for k, v in m.items()}
      m_host['train/accuracy'] = m_host['accuracy_correct'] / max(
          m_host['accuracy_total'], 1)
      m_host['step_seconds'] = step_seconds[-1]
      sidecars.log(step, 'train', m_host)
    if step % eval_every == 0:
      final_metrics = run_eval(model, loss_fn, eval_ds, device)
      sidecars.log(step, 'eval', final_metrics)
      save(step, final_metrics)
  final_metrics = run_eval(model, loss_fn, eval_ds, device)
  sidecars.log(step, 'eval', final_metrics)
  save(step, final_metrics)
  weights_lib.save_npz(os.path.join(out_dir, 'weights.npz'),
                       weights_lib.to_flax_params(model.state_dict()))
  summary = {'steps_run': float(len(step_seconds))}
  if step_seconds:
    p50 = statistics.median(step_seconds)
    summary.update(train_step_p50_s=p50,
                   train_examples_per_s=params.batch_size / p50)
  if device.type == 'cuda':
    summary['peak_bytes'] = float(torch.cuda.max_memory_allocated(device))
  sidecars.log(step, 'summary', summary)
  return final_metrics
