"""Accuracy counts for training and eval (port of the reference's
models/metrics.py per_example_accuracy_counts and
per_class_accuracy_counts). AlignmentMetric's identity metrics are not
ported (ROADMAP: training features)."""
from __future__ import annotations

from typing import Tuple

import torch

from deepconsensus_tpu_torch.models.losses import left_shift_sequence


def per_example_accuracy_counts(
    y_true: torch.Tensor, y_pred_scores: torch.Tensor
) -> Tuple[torch.Tensor, int]:
  """(correct_examples, total_examples) after left-shifting both; the
  count stays a device tensor (no host sync)."""
  y_true = left_shift_sequence(y_true.to(device=y_pred_scores.device,
                                         dtype=torch.long))
  y_pred = left_shift_sequence(torch.argmax(y_pred_scores, dim=-1))
  row_correct = (y_true == y_pred).all(dim=-1)
  return row_correct.sum(), int(y_true.shape[0])


def per_class_accuracy_counts(
    y_true: torch.Tensor, y_pred_scores: torch.Tensor, class_value: int
) -> Tuple[torch.Tensor, torch.Tensor]:
  """(correct, total) over positions whose label is class_value."""
  y_true = y_true.to(device=y_pred_scores.device, dtype=torch.long)
  y_pred = torch.argmax(y_pred_scores, dim=-1)
  mask = y_true == class_value
  correct = (y_pred == y_true) & mask
  return correct.sum(), mask.sum()
