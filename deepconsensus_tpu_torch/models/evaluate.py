"""Offline evaluation over labeled TFRecords -> inference.csv.

Port of deepconsensus_tpu/models/evaluate.py (`run_evaluation`, the
counterpart of the reference's model_inference binary): sweeps an eval
set with the inference forward (`DeepConsensusModel.forward`: on the
card K1 and K2, int8 under quantize_matmuls; on the CPU the module
route unless use_fused_hotpath), takes the alignment loss (K11 on the
card) and the metrics of models/metrics.py per batch, and writes one
CSV row of their means. Its `alignment_identity` is the int8 lever's
accuracy gate (config.INT8_IDENTITY_GATE).
"""
from __future__ import annotations

import csv
import os
from typing import Dict, Optional

import torch

from deepconsensus_tpu_torch import constants
from deepconsensus_tpu_torch.devices import resolve_device
from deepconsensus_tpu_torch.models import data as data_lib
from deepconsensus_tpu_torch.models import metrics as metrics_lib
from deepconsensus_tpu_torch.models import model as model_lib
from deepconsensus_tpu_torch.models import train as train_lib


def load_checkpoint_state(path: str) -> Dict[str, torch.Tensor]:
  """The model state dict of a `cli train` checkpoint-<step>.pt."""
  return torch.load(path, map_location='cpu')['model']


@torch.no_grad()
def run_evaluation(
    params,
    checkpoint_path: Optional[str],
    eval_patterns,
    out_dir: str,
    state: Optional[Dict[str, torch.Tensor]] = None,
    limit: int = -1,
    device=None,
) -> Dict[str, float]:
  """Evaluates and writes <out_dir>/inference.csv; returns the metrics.
  state: a state dict ready for the model (after
  models/quantize.prepare_inference_variables when params carry the
  levers), or None to read checkpoint_path. Runs on the card unless
  device says otherwise."""
  device = resolve_device(device)
  if state is None:
    state = load_checkpoint_state(checkpoint_path)
  model = model_lib.inference_model(params, state, device)
  loss_fn = train_lib.make_loss(params)
  align_metric = metrics_lib.AlignmentMetric()

  def eval_step(batch):
    preds = model(batch['rows'])
    label = batch['label']
    correct, total = metrics_lib.per_example_accuracy_counts(label, preds)
    id_ccs, id_pred = metrics_lib.batch_identity_ccs_pred(
        train_lib.ccs_row_from_batch(batch['rows'], params), preds, label,
        align_metric)
    out = {'loss': loss_fn(label, preds), 'accuracy_correct': correct,
           'accuracy_total': total, 'identity_ccs': id_ccs,
           'identity_pred': id_pred}
    for cls in range(constants.SEQ_VOCAB_SIZE):
      c, t = metrics_lib.per_class_accuracy_counts(label, preds, cls)
      out[f'class{cls}_correct'] = c
      out[f'class{cls}_total'] = t
    return {k: float(v) for k, v in out.items()}

  ds = data_lib.DatasetIterator(
      patterns=eval_patterns, params=params, batch_size=params.batch_size,
      shuffle=False, limit=limit)
  sums: Dict[str, float] = {}
  batches = 0
  yield_metric = metrics_lib.YieldOverCCS()
  for batch in ds.epoch():
    out = eval_step(train_lib.batch_to_device(batch, device))
    yield_metric.update(out['identity_ccs'], out['identity_pred'])
    for k, v in out.items():
      sums[k] = sums.get(k, 0.0) + v
    batches += 1
  if not batches:
    raise ValueError(
        f'no complete eval batches: {eval_patterns!r} yielded fewer '
        f'than batch_size={params.batch_size} examples '
        '(limit counts examples, not batches)')
  metrics = {
      'loss': sums['loss'] / batches,
      'per_example_accuracy': (
          sums['accuracy_correct'] / max(sums['accuracy_total'], 1)),
      'alignment_identity': sums['identity_pred'] / batches,
      'ccs_identity': sums['identity_ccs'] / batches,
      'yield_over_ccs': yield_metric.result(),
  }
  for cls in range(constants.SEQ_VOCAB_SIZE):
    total = sums.get(f'class{cls}_total', 0.0)
    if total:
      metrics[f'class{cls}_accuracy'] = sums[f'class{cls}_correct'] / total

  os.makedirs(out_dir, exist_ok=True)
  with open(os.path.join(out_dir, 'inference.csv'), 'w', newline='') as f:
    writer = csv.writer(f)
    writer.writerow(sorted(metrics))
    writer.writerow([metrics[k] for k in sorted(metrics)])
  return metrics
