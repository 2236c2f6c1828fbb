"""Alignment identity and accuracy metrics (port of the reference's
models/metrics.py).

AlignmentMetric runs a Needleman-Wunsch alignment with affine gaps
(scores A=2, B=5, o=5, e=4 approximating pbmm2) as a wavefront scan with
three states (M/I/D), records per-antidiagonal argmax directions, then
backtracks to per-example match/insertion/deletion counts and percent
identity. Both recursions are Python loops of torch ops over
antidiagonals on the inputs' device; no TPU kernel backs them in the
reference (two lax.scans), so none is written here. models/evaluate.py
reads the identities; training reads the accuracy counts.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from deepconsensus_tpu_torch import constants
from deepconsensus_tpu_torch.models.losses import left_shift_sequence
from deepconsensus_tpu_torch.ops import wavefront

_INF = 1e9


def _preprocess_true(y_true: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
  y_true = left_shift_sequence(y_true.long())
  return y_true, (y_true != constants.GAP_INT).sum(-1)


def _preprocess_pred(y_pred_scores: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
  y_pred = left_shift_sequence(torch.argmax(y_pred_scores, dim=-1))
  return y_pred, (y_pred != constants.GAP_INT).sum(-1)


def _argmax_over_states(v: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
  """[B, S, X] -> (max, first argmax) over the states."""
  return v.amax(dim=1), torch.argmax(v, dim=1).to(torch.int8)


class AlignmentMetric:
  """NW affine-gap alignment + identity metrics."""

  def __init__(
      self,
      matching_score: float = 2.0,
      mismatch_penalty: float = 5.0,
      gap_open_penalty: float = 5.0,
      gap_extend_penalty: float = 4.0,
  ):
    self.matching_score = matching_score
    self.mismatch_penalty = mismatch_penalty
    # pbmm2 charges o + k*e; the DP uses o + (k-1)*e, so fold one extend
    # into the open.
    self.gap_open_penalty = gap_open_penalty + gap_extend_penalty
    self.gap_extend_penalty = gap_extend_penalty

  @torch.no_grad()
  def alignment(
      self, y_true: torch.Tensor, y_pred_scores: torch.Tensor
  ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """y_true [B, m] labels, y_pred_scores [B, n, V]. Returns (v_opt
    [B], paths [B, m+1, n+1] edge ids, metric dict of [B] tensors)."""
    dev = y_pred_scores.device
    f32 = torch.float32
    b, m = y_true.shape
    n = y_pred_scores.shape[1]
    y_true, y_true_lens = _preprocess_true(y_true.to(dev))
    y_pred, y_pred_lens = _preprocess_pred(y_pred_scores)

    subs_costs = torch.where(
        y_true[:, :, None] == y_pred[:, None, :],
        torch.tensor(self.matching_score, dtype=f32, device=dev),
        torch.tensor(-self.mismatch_penalty, dtype=f32, device=dev),
    )  # [B, m, n]
    subs_w = wavefront.wavefrontify(subs_costs)  # [m+n-1, B, m]
    go, ge = self.gap_open_penalty, self.gap_extend_penalty
    ins_pen = torch.tensor([go, ge], dtype=f32, device=dev)[None, :, None]
    del_pen = torch.tensor([go, go, ge], dtype=f32, device=dev)[None, :, None]
    i_range = torch.arange(m + 1, device=dev)
    k_end = y_true_lens + y_pred_lens
    samp = torch.arange(b, device=dev)

    # Diagonals 0 and 1; v_all_*: [B, 3, *] for states (M, I, D).
    v_all_p2 = torch.full((b, 3, m), -_INF, dtype=f32, device=dev)
    v_all_p2[:, 0, 0] = 0.0
    v_all_p1 = torch.full((b, 3, m + 1), -_INF, dtype=f32, device=dev)
    v_all_p1[:, 1, 0] = -go
    v_all_p1[:, 2, 1] = -go
    dir0 = torch.full((b, 3, m + 1), -2, dtype=torch.int8, device=dev)
    dir0[:, 0, 0] = -1
    dir1 = torch.full((b, 3, m + 1), -2, dtype=torch.int8, device=dev)
    dir1[:, 1, 0] = 0
    dir1[:, 2, 1] = 0

    v_opt = torch.zeros(b, dtype=f32, device=dev)
    m_opt = torch.full((b,), -1, dtype=torch.long, device=dev)

    def maybe_update(k, v_opt, m_opt, v_all):
      v_k, m_k = _argmax_over_states(v_all)  # [B, m+1]
      v_at = v_k[samp, y_true_lens]
      m_at = m_k[samp, y_true_lens].long()
      cond = k_end == k
      return torch.where(cond, v_at, v_opt), torch.where(cond, m_at, m_opt)

    v_opt, m_opt = maybe_update(1, v_opt, m_opt, v_all_p1)
    pad_val = torch.full((b, 1), -_INF, dtype=f32, device=dev)
    pad_dir = torch.full((b, 1), -2, dtype=torch.int8, device=dev)
    neg_inf = torch.tensor(-_INF, dtype=f32, device=dev)
    dir_all = [dir0, dir1]
    for k in range(2, m + n + 1):
      valid = ((k - i_range) >= 0) & ((k - i_range) <= n)  # [m+1]
      o_match = v_all_p2 + subs_w[k - 2][:, None, :]  # [B, 3, m]
      o_ins = v_all_p1[:, :2] - ins_pen  # [B, 2, m+1]
      v_all_p2 = v_all_p1[:, :, :-1]
      o_del = v_all_p2 - del_pen  # [B, 3, m]
      v_match, dir_match = _argmax_over_states(o_match)
      v_ins, dir_ins = _argmax_over_states(o_ins)
      v_del, dir_del = _argmax_over_states(o_del)
      v_all_p1 = torch.where(
          valid[None, None, :],
          torch.stack([torch.cat([pad_val, v_match], 1), v_ins,
                       torch.cat([pad_val, v_del], 1)], dim=1),
          neg_inf)
      dir_all.append(torch.stack([torch.cat([pad_dir, dir_match], 1),
                                  dir_ins, torch.cat([pad_dir, dir_del], 1)],
                                 dim=1))
      v_opt, m_opt = maybe_update(k, v_opt, m_opt, v_all_p1)

    # Backtracking from (k_end, y_true_len, m_opt) to the start.
    steps_k = torch.tensor([-2, -1, -1], device=dev)
    steps_i = torch.tensor([-1, 0, -1], device=dev)
    trans_enc = torch.tensor([[1, 1, 1], [2, 3, 2], [4, 4, 5]], device=dev)
    k_opt, i_opt = k_end.clone(), y_true_lens.clone()
    path_rows = []
    zeros = torch.zeros((b, 4), dtype=torch.long, device=dev)
    for k in range(m + n, -1, -1):
      safe_m = m_opt.clamp(min=0)
      safe_i = i_opt.clamp(min=0)
      k_opt_n = k_opt + steps_k[safe_m]
      i_opt_n = i_opt + steps_i[safe_m]
      m_opt_n = dir_all[k][samp, safe_m, safe_i].long()
      edges_n = trans_enc[safe_m, m_opt_n.clamp(min=0)]
      cond = (k_opt == k) & (m_opt_n != -1)
      path_rows.append(torch.where(
          cond[:, None],
          torch.stack([samp, i_opt, k_opt - i_opt, edges_n], dim=-1), zeros))
      k_opt = torch.where(cond, k_opt_n, k_opt)
      i_opt = torch.where(cond, i_opt_n, i_opt)
      m_opt = torch.where(cond, m_opt_n, m_opt)
    paths_sp = torch.cat(path_rows)
    paths = torch.zeros((b, m + 1, n + 1), dtype=torch.int32, device=dev)
    paths.index_put_((paths_sp[:, 0], paths_sp[:, 1], paths_sp[:, 2]),
                     paths_sp[:, 3].to(torch.int32), accumulate=True)

    matches_mask = paths == 1
    ins_mask = (paths == 2) | (paths == 3)
    del_mask = (paths == 4) | (paths == 5)
    correct = matches_mask[:, 1:, 1:] & (subs_costs > 0)

    def count(t):
      return t.sum(dim=(1, 2), dtype=torch.int32)

    metric_values = {
        'num_matches': count(matches_mask),
        'num_insertions': count(ins_mask),
        'num_deletions': count(del_mask),
        'num_correct_matches': count(correct),
    }
    metric_values['alignment_length'] = (
        metric_values['num_matches'] + metric_values['num_insertions']
        + metric_values['num_deletions'])
    length = metric_values['alignment_length']
    unsafe_pid = metric_values['num_correct_matches'] / length.clamp(min=1)
    metric_values['pid'] = torch.where(
        length > 0, unsafe_pid.to(f32), torch.ones((), device=dev))
    return v_opt, paths, metric_values


def per_batch_identity(metric_values: Dict[str, torch.Tensor]
                       ) -> torch.Tensor:
  """Batch-pooled identity: correct matches over alignment length,
  summed over the batch (1 for an empty alignment)."""
  total = metric_values['alignment_length'].sum()
  pid = metric_values['num_correct_matches'].sum() / total.clamp(min=1)
  return torch.where(total > 0, pid.to(torch.float32),
                     torch.ones((), device=total.device))


def batch_identity_ccs_pred(
    ccs: torch.Tensor,
    y_pred_scores: torch.Tensor,
    y_true: torch.Tensor,
    alignment_metric: AlignmentMetric,
) -> Tuple[torch.Tensor, torch.Tensor]:
  """(identity of the CCS, identity of the prediction) against the
  labels. The CCS row goes in as one-hot scores; an id outside the
  vocabulary gives a zero row, as jax.nn.one_hot does."""
  _, _, mv_pred = alignment_metric.alignment(y_true, y_pred_scores)
  vocab = torch.arange(constants.SEQ_VOCAB_SIZE, device=ccs.device)
  ccs_oh = (ccs.long()[..., None] == vocab).to(torch.float32)
  _, _, mv_ccs = alignment_metric.alignment(y_true, ccs_oh)
  return per_batch_identity(mv_ccs), per_batch_identity(mv_pred)


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


@dataclasses.dataclass
class YieldOverCCS:
  """Batches where identity >= threshold, DC over CCS."""

  quality_threshold: float = 0.997
  yield_dc: float = 0.0
  yield_ccs: float = 0.0

  def update(self, identity_ccs: float, identity_pred: float):
    self.yield_dc += float(identity_pred >= self.quality_threshold)
    self.yield_ccs += float(identity_ccs >= self.quality_threshold)

  def result(self) -> float:
    return self.yield_dc / self.yield_ccs if self.yield_ccs else 0.0
