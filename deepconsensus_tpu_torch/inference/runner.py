"""Serial inference: BAM -> windows -> model on the card -> FASTQ.

Port of deepconsensus_tpu/inference/runner.py as a serial runner:
featurize a batch of ZMWs, triage its windows (CCS adoption for
overflow and high-quality windows), run the rest through the model in
fixed-shape packs of batch_size windows, stitch each molecule, and write
FASTQ plus `<output>.inference.json` counters. The reference's
cross-batch packer, featurization worker pool, resume, tracing and
fault quarantine are not part of the port yet (ROADMAP); a decode or
model error fails the run.

Mixed-width windows (--use_ccs_smart_windows with --window_buckets, e.g.
100,200) run per bucket by default: each featurize batch's model
windows group by width, and each bucket runs in packs of batch_size
windows, padded to batch_size, in featurize order. Windows of at most
128 positions take the fused route (K1, K2), wider ones the encoder's
module route (K8 under use_pallas_attention). With --use_ragged_kernel
they pack instead into ragged slots of the largest bucket
(inference/engine.py) and run through the model's ragged forward (K4,
then K2 with lengths).

The inference levers (--inference_dtype bfloat16, --quantize_matmuls
int8) apply once when ModelRunner loads the weights
(models/quantize.py); the sidecar records `inference_dtype` and
`n_quantized_matmuls`. Under int8 each encoder block runs K2's int8
variant.

The model stage ships each pack to the card compactly, as in the
reference: uint8 rows (the ccs_bq row biased by +1 so its -1 gaps
survive) plus float SN scalars ([B, 4] per window, or [slots, wps, 4]
per window of a ragged slot), reassembled on the card. The output plane
(K3) leaves the card as two uint8 planes.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deepconsensus_tpu_torch.calibration import lib as calibration_lib
from deepconsensus_tpu_torch.devices import resolve_device
from deepconsensus_tpu_torch.inference import engine as engine_lib
from deepconsensus_tpu_torch.models import config as config_lib
from deepconsensus_tpu_torch.models import data as data_lib
from deepconsensus_tpu_torch.models import model as model_lib
from deepconsensus_tpu_torch.models import quantize as quantize_lib
from deepconsensus_tpu_torch.ops import output_plane
from deepconsensus_tpu_torch.ops import ragged_window_attention as rwa
from deepconsensus_tpu_torch.postprocess import stitch
from deepconsensus_tpu_torch.preprocess.feeder import (
    create_proc_feeder,
    reads_to_pileup,
)
from deepconsensus_tpu_torch.preprocess.pileup import FeatureLayout, row_indices
from deepconsensus_tpu_torch.utils import phred


@dataclasses.dataclass
class InferenceOptions:
  """Knobs of the serial inference pipeline (a subset of the
  reference's InferenceOptions)."""

  max_length: int = config_lib.DEFAULT_MAX_LENGTH
  max_passes: int = 20
  min_quality: int = 20
  min_length: int = 0
  batch_size: int = 1024
  batch_zmws: int = 100
  use_ccs_bq: bool = False
  use_ccs_smart_windows: bool = False
  # Window length buckets: None follows params.window_buckets (one
  # bucket, max_length, when that is unset too). Each bucket runs in its
  # own packs unless use_ragged_kernel.
  window_buckets: Optional[Tuple[int, ...]] = None
  # Pack mixed-width windows into ragged slots of the largest bucket
  # and run the ragged forward (the buckets must form a divisibility
  # chain).
  use_ragged_kernel: bool = False
  skip_windows_above: int = 45
  # Inference levers (models/quantize.py), folded into params by
  # ModelRunner (_apply_quant_levers) and applied once at load. inference_dtype: None
  # keeps the checkpoint's float32 weights and params.dtype; 'bfloat16'
  # casts the weights and runs the model in bfloat16. quantize_matmuls:
  # None or 'none' off; 'int8' quantizes the encoder matmuls.
  inference_dtype: Optional[str] = None
  quantize_matmuls: Optional[str] = None
  ins_trim: int = 5
  max_base_quality: int = 93
  limit: int = 0
  dc_calibration_values: calibration_lib.QualityCalibrationValues = (
      dataclasses.field(
          default_factory=lambda: calibration_lib.parse_calibration_string(
              'skip')))
  ccs_calibration_values: calibration_lib.QualityCalibrationValues = (
      dataclasses.field(
          default_factory=lambda: calibration_lib.parse_calibration_string(
              'skip')))


_SN_ROWS = 4  # trailing rows: per-window SN constants (layout: pileup.py)


def _assemble_rows(main_u8: torch.Tensor, sn: torch.Tensor,
                   bq_row: Optional[int] = None) -> torch.Tensor:
  """Device-side inverse of dispatch()'s compact split: uint8 rows
  [B, R-4, L] -> float32 [B, R, L], SN scalars re-broadcast across the
  window, the ccs_bq row's +1 transport bias undone."""
  b, _, length = main_u8.shape
  main = main_u8.to(torch.float32)
  if bq_row is not None:
    main[:, bq_row] -= 1.0
  sn_rows = sn.to(torch.float32)[:, :, None].expand(b, _SN_ROWS, length)
  return torch.cat([main, sn_rows], dim=1)


def _assemble_rows_ragged(main_u8: torch.Tensor, sn_w: torch.Tensor,
                          lengths: torch.Tensor,
                          bq_row: Optional[int] = None) -> torch.Tensor:
  """_assemble_rows for ragged slots: sn_w [B, wps, 4] per-window SN
  scalars; each position takes its own window's values through the
  lengths-derived segment map, and positions past the windows get zero
  SN."""
  b, _, length = main_u8.shape
  main = main_u8.to(torch.float32)
  if bq_row is not None:
    main[:, bq_row] -= 1.0
  seg, _, _, valid = rwa.slot_geometry(lengths, length)
  sn_pos = torch.gather(sn_w.to(torch.float32), 1,
                        seg.long()[:, :, None].expand(b, length, _SN_ROWS))
  sn_pos = sn_pos * valid[:, :, None]
  return torch.cat([main, sn_pos.transpose(1, 2)], dim=1)


def _bq_row_index(params) -> Optional[int]:
  """Row index of the ccs_bq row within the non-SN block, or None.
  Also guards the compact-transport assumption that every non-SN row
  fits 0..255 after the ccs_bq +1 bias."""
  if params.PW_MAX > 255 or params.IP_MAX > 255:
    raise ValueError(
        f'compact uint8 dispatch requires PW_MAX/IP_MAX <= 255, got '
        f'{params.PW_MAX}/{params.IP_MAX}')
  if not params.use_ccs_bq:
    return None
  return row_indices(params.max_passes, True)[5][0]


def _apply_quant_levers(params, options: InferenceOptions) -> None:
  """Folds the quantization levers of options into params (the
  reference's runner._apply_quant_levers): inference_dtype also sets
  the compute dtype, so activations run in it end to end. The weights
  are cast and quantized in ModelRunner.__init__, which calls this."""
  if options.inference_dtype:
    params.inference_dtype = options.inference_dtype
    params.dtype = options.inference_dtype
  if options.quantize_matmuls and options.quantize_matmuls != 'none':
    params.quantize_matmuls = options.quantize_matmuls


class ModelRunner:
  """The model stage: (formatted window rows) -> (base ids, qualities).

  device=None means the card and raises when none is present; tests
  pass device='cpu'. plain=True runs the fused route through the
  kernels' plain versions on the same device (the reference run that
  the kernels are held against on the card). The inference levers of
  options are folded into params (_apply_quant_levers), and those in
  params (params.inference_dtype, params.quantize_matmuls) are applied
  to state_dict here, before the weights go to the device.
  """

  def __init__(self, params, state_dict: Dict[str, torch.Tensor],
               options: Optional[InferenceOptions] = None,
               device=None, plain: bool = False):
    self.options = options or InferenceOptions()
    _apply_quant_levers(params, self.options)
    self.window_buckets = config_lib.normalize_window_buckets(
        self.options.window_buckets or params.get('window_buckets'),
        params.max_length)
    if len(self.window_buckets) > 1:
      params = config_lib.Params(params,
                                 window_buckets=list(self.window_buckets))
    self.options.window_buckets = self.window_buckets
    self.params = params
    self.device = resolve_device(device)
    self.plain = plain
    state_dict, self.n_quantized_matmuls = (
        quantize_lib.prepare_inference_variables(state_dict, params))
    self.inference_dtype = str(params.get('inference_dtype') or 'float32')
    self.model = model_lib.inference_model(params, state_dict, self.device)
    self._bq_row = _bq_row_index(params)
    self._configure_epilogue()
    self.n_packs = 0
    self.n_pack_rows = 0
    self.n_pad_rows = 0
    # Per bucket width, for dispatch(): windows, packs and pad rows.
    self.n_windows_by_bucket = collections.Counter(
        dict.fromkeys(self.window_buckets, 0))
    self.n_packs_by_bucket = collections.Counter()
    self.n_pad_rows_by_bucket = collections.Counter()
    self.model_seconds = 0.0
    self.d2h_bytes_per_pack = 0

  def _configure_epilogue(self) -> None:
    """Builds the exact threshold table for the device output plane
    (K3), or records the host fallback for a calibration whose quality
    map is not representable (non-monotone, or a top quality past the
    uint8 plane): then int32 ids and f32 max_prob leave the card and
    the host does the Phred math."""
    self._thresholds = None
    thresholds = output_plane.quality_thresholds(
        self.options.dc_calibration_values, self.options.max_base_quality)
    if thresholds is not None:
      self._thresholds = torch.from_numpy(thresholds).to(self.device)

  @property
  def device_epilogue(self) -> bool:
    return self._thresholds is not None

  def dispatch(self, rows: np.ndarray) -> Tuple[Tuple[torch.Tensor, ...], int]:
    """Runs one pack: rows [n, R, L, 1] formatted windows (n <=
    batch_size), padded to batch_size. Returns the device outputs and n;
    the card may still be working when this returns."""
    n = rows.shape[0]
    batch = self.options.batch_size
    if n > batch:
      raise ValueError(f'{n} windows exceed batch_size {batch}')
    if n < batch:
      pad = np.zeros((batch - n,) + rows.shape[1:], rows.dtype)
      rows = np.concatenate([rows, pad])
    sn = np.ascontiguousarray(rows[:, -_SN_ROWS:, 0, 0].astype(np.float32))
    main_dev = self._main_rows_to_device(rows)
    sn_dev = torch.from_numpy(sn).to(self.device)
    preds = self.model(_assemble_rows(main_dev, sn_dev, self._bq_row),
                       plain=self.plain)
    width = rows.shape[2]
    self.n_packs += 1
    self.n_pack_rows += n
    self.n_pad_rows += batch - n
    self.n_windows_by_bucket[width] += n
    self.n_packs_by_bucket[width] += 1
    self.n_pad_rows_by_bucket[width] += batch - n
    return self._epilogue(preds), n

  def _main_rows_to_device(self, rows: np.ndarray) -> torch.Tensor:
    """The non-SN rows of [B, R, L, 1] as uint8 on the device, the
    ccs_bq row biased by +1."""
    main = rows[:, :-_SN_ROWS, :, 0]
    main_u8 = main.astype(np.uint8)
    if self._bq_row is not None:
      main_u8[:, self._bq_row] = (main[:, self._bq_row] + 1.0).astype(
          np.uint8)
    return torch.from_numpy(main_u8).to(self.device)

  def _epilogue(self, preds: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    if self._thresholds is not None:
      epilogue = (output_plane.phred_epilogue_plain if self.plain
                  else output_plane.phred_epilogue)
      return epilogue(preds, self._thresholds)
    max_prob, pred_ids = preds.max(dim=-1)
    return pred_ids.to(torch.int32), max_prob

  def dispatch_ragged(self, rows: np.ndarray, lengths: np.ndarray
                      ) -> Tuple[Tuple[torch.Tensor, ...], int]:
    """dispatch() for one ragged pack: rows [n_slots, R, slot_len, 1]
    with mixed-width windows packed back to back per slot, lengths
    [n_slots, wps] int32 window widths (0 = unused capacity). The SN
    plane ships as per-window scalars [n_slots, wps, 4], sampled at each
    window's start column."""
    n_slots, _, slot_len, _ = rows.shape
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    starts = np.zeros_like(lengths)
    starts[:, 1:] = np.cumsum(lengths[:, :-1], axis=1)
    sn_planes = rows[:, -_SN_ROWS:, :, 0]  # [n_slots, 4, slot_len]
    sn_w = np.take_along_axis(
        sn_planes, np.clip(starts, 0, slot_len - 1)[:, None, :], axis=2)
    sn_w = sn_w.transpose(0, 2, 1) * (lengths > 0)[:, :, None]
    sn_dev = torch.from_numpy(
        np.ascontiguousarray(sn_w, dtype=np.float32)).to(self.device)
    len_dev = torch.from_numpy(lengths).to(self.device)
    rows_dev = _assemble_rows_ragged(self._main_rows_to_device(rows),
                                     sn_dev, len_dev, self._bq_row)
    preds = self.model(rows_dev, plain=self.plain, window_lengths=len_dev)
    return self._epilogue(preds), n_slots

  def finalize(self, dispatched) -> Tuple[np.ndarray, np.ndarray]:
    """Drains a dispatch into (base ids [n, L], qualities [n, L])."""
    (out_a, out_b), n = dispatched
    out_a = out_a.cpu().numpy()
    out_b = out_b.cpu().numpy()
    self.d2h_bytes_per_pack = int(out_a.nbytes + out_b.nbytes)
    out_a, out_b = out_a[:n], out_b[:n]
    if self.device_epilogue:
      return out_a, out_b
    quality = output_plane.host_quality_reference(
        out_b, self.options.dc_calibration_values,
        self.options.max_base_quality)
    return out_a, quality

  def predict(self, rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Synchronous dispatch + finalize, timed into model_seconds."""
    t0 = time.perf_counter()
    out = self.finalize(self.dispatch(rows))
    self.model_seconds += time.perf_counter() - t0
    return out

  def predict_ragged(self, rows: np.ndarray, lengths: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Synchronous dispatch_ragged + finalize: (ids, quals) planes
    [n_slots, slot_len], timed into model_seconds."""
    t0 = time.perf_counter()
    out = self.finalize(self.dispatch_ragged(rows, lengths))
    self.model_seconds += time.perf_counter() - t0
    return out


def preprocess_zmw(zmw_input) -> Tuple[List[Dict[str, Any]],
                                       collections.Counter]:
  """One ZMW -> list of window feature dicts."""
  subreads, name, layout, _split, window_widths = zmw_input
  pileup = reads_to_pileup(subreads, name, layout, window_widths)
  return list(pileup.iter_window_features()), pileup.counter


def triage_windows(
    feature_dicts: List[Dict[str, Any]],
    options: InferenceOptions,
    counter: collections.Counter,
) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]]]:
  """Splits windows into (model, skip) per overflow/quality rules
  (reference: quick_inference.py:653-678)."""
  to_model: List[Dict[str, Any]] = []
  to_skip: List[Dict[str, Any]] = []
  for fd in feature_dicts:
    if fd['overflow']:
      to_skip.append(fd)
      counter['n_windows_overflow_skipped'] += 1
      continue
    if options.skip_windows_above:
      avg_q = phred.avg_phred(fd['ccs_base_quality_scores'])
      # Strictly above, matching the reference (quick_inference.py:671).
      if avg_q > options.skip_windows_above:
        to_skip.append(fd)
        counter['n_windows_quality_skipped'] += 1
        continue
    to_model.append(fd)
    counter['n_windows_to_model'] += 1
  return to_model, to_skip


def ccs_quals_array(bq_scores, options: InferenceOptions) -> np.ndarray:
  """CCS base qualities -> emitted phred uint8 (calibration, cap at
  max_base_quality, floor at 0)."""
  quals = np.asarray(bq_scores)
  if options.ccs_calibration_values.enabled:
    quals = calibration_lib.calibrate_quality_scores(
        quals, options.ccs_calibration_values)
  quals = np.minimum(quals, options.max_base_quality).astype(np.int32)
  return np.maximum(quals, 0).astype(np.uint8)


def skipped_window_arrays(
    feature_dict: Dict[str, Any], options: InferenceOptions
) -> Tuple[np.ndarray, np.ndarray]:
  """(vocab ids uint8 [L], phred uint8 [L]) adopted from the draft CCS."""
  rows = feature_dict['subreads']
  ccs_range = row_indices(options.max_passes, options.use_ccs_bq)[4]
  ids = rows[ccs_range[0], :, 0].astype(np.uint8)
  return ids, ccs_quals_array(
      feature_dict['ccs_base_quality_scores'], options)


def _molecule_name(fd: Dict[str, Any]) -> str:
  return fd['name'] if isinstance(fd['name'], str) else fd['name'].decode()


def _polish_batch(windows: List[Dict[str, Any]], runner: ModelRunner,
                  options: InferenceOptions, counter: collections.Counter,
                  packer: Optional[engine_lib._RaggedPacker] = None
                  ) -> Dict[str, Dict[str, list]]:
  """Triage + model for one featurize batch: molecule name ->
  {'pos', 'ids', 'quals'} window lists. The model windows group by
  width, in featurize order within a width; with a packer they run
  through ragged slots, else each width in its own packs of
  batch_size."""
  mols: Dict[str, Dict[str, list]] = {}

  def add(fd, ids, quals):
    mol = mols.setdefault(_molecule_name(fd),
                          {'pos': [], 'ids': [], 'quals': []})
    mol['pos'].append(fd['window_pos'])
    mol['ids'].append(ids)
    mol['quals'].append(quals)

  to_model, to_skip = triage_windows(windows, options, counter)
  for fd in to_skip:
    add(fd, *skipped_window_arrays(fd, options))
  by_width: Dict[int, List[Dict[str, Any]]] = {}
  for fd in to_model:
    by_width.setdefault(fd['subreads'].shape[1], []).append(fd)
  for width in sorted(by_width):
    group = by_width[width]
    if packer is not None:
      rows = data_lib.format_rows_batch(
          np.stack([fd['subreads'] for fd in group]), runner.params,
          window_buckets=runner.window_buckets)
      packer.add(rows, [(add, fd) for fd in group])
      continue
    for start in range(0, len(group), options.batch_size):
      chunk = group[start:start + options.batch_size]
      rows = data_lib.format_rows_batch(
          np.stack([fd['subreads'] for fd in chunk]), runner.params,
          window_buckets=runner.window_buckets)
      ids, quals = runner.predict(rows)
      for fd, i, q in zip(chunk, ids, quals):
        add(fd, i, q)
  if packer is not None:
    packer.flush()
  return mols


def run_inference(
    subreads_to_ccs: str,
    ccs_bam: str,
    output: str,
    runner: ModelRunner,
) -> Dict[str, Any]:
  """Full serial pipeline with runner's model and options; writes
  `output` (FASTQ) and `<output>.inference.json`, returns the
  counters."""
  options = runner.options
  params = runner.params
  if output.endswith('.bam'):
    raise NotImplementedError(
        'BAM output is not ported yet (ROADMAP: tail modules)')
  options.max_passes = params.max_passes
  options.max_length = params.max_length
  options.use_ccs_bq = params.use_ccs_bq
  layout = FeatureLayout(
      max_passes=options.max_passes,
      max_length=options.max_length,
      use_ccs_bq=options.use_ccs_bq,
      window_buckets=runner.window_buckets,
  )
  feeder, counter = create_proc_feeder(
      subreads_to_ccs=subreads_to_ccs,
      ccs_bam=ccs_bam,
      layout=layout,
      ins_trim=options.ins_trim,
      use_ccs_smart_windows=options.use_ccs_smart_windows,
      limit=options.limit,
  )
  packer = None
  if options.use_ragged_kernel:
    packer = engine_lib._RaggedPacker(
        runner, options, runner.window_buckets,
        deliver=lambda ticket, ids, quals: ticket[0](ticket[1], ids, quals))
  outcome = stitch.OutcomeCounter()
  timings = collections.Counter()
  out_tmp = output + '.tmp'
  t_start = time.perf_counter()

  def flush(zmw_batch, sink) -> None:
    t0 = time.perf_counter()
    windows: List[Dict[str, Any]] = []
    for zmw_input in zmw_batch:
      features, zmw_counter = preprocess_zmw(zmw_input)
      counter.update(zmw_counter)
      windows.extend(features)
    t1 = time.perf_counter()
    model_before = runner.model_seconds
    mols = _polish_batch(windows, runner, options, counter, packer)
    t2 = time.perf_counter()
    for name in sorted(mols):
      mol = mols[name]
      result = stitch.stitch_arrays(
          name, np.asarray(mol['pos'], dtype=np.int64), mol['ids'],
          mol['quals'], max_length=options.max_length,
          min_quality=options.min_quality, min_length=options.min_length,
          outcome_counter=outcome)
      if result is not None:
        sink.write(stitch.format_fastq_bytes(name, result[0], result[1]))
    timings['featurize_seconds'] += t1 - t0
    timings['model_seconds'] += runner.model_seconds - model_before
    timings['triage_format_seconds'] += (
        t2 - t1 - (runner.model_seconds - model_before))
    timings['stitch_seconds'] += time.perf_counter() - t2

  with open(out_tmp, 'wb') as sink:
    zmw_batch = []
    for zmw_input in feeder():
      zmw_batch.append(zmw_input)
      if options.batch_zmws and len(zmw_batch) >= options.batch_zmws:
        flush(zmw_batch, sink)
        zmw_batch = []
    if zmw_batch:
      flush(zmw_batch, sink)
  os.replace(out_tmp, output)
  counters: Dict[str, Any] = dict(counter)
  counters.update(dataclasses.asdict(outcome))
  counters.update({k: round(v, 6) for k, v in timings.items()})
  packs = runner if packer is None else packer
  if packer is None:
    by_bucket = (runner.n_windows_by_bucket, runner.n_packs_by_bucket,
                 runner.n_pad_rows_by_bucket)
  else:  # every ragged pack is one slot_len-wide shape
    slot_len = runner.window_buckets[-1]
    by_bucket = (packer.n_windows_by_bucket, {slot_len: packer.n_packs},
                 {slot_len: packer.n_pad_rows})
  counters.update(
      total_seconds=round(time.perf_counter() - t_start, 6),
      window_buckets=list(runner.window_buckets),
      use_ragged_kernel=int(packer is not None),
      n_windows_by_bucket=dict(by_bucket[0]),
      n_model_packs=packs.n_packs,
      n_model_packs_by_bucket=dict(by_bucket[1]),
      n_model_pack_rows=packs.n_pack_rows,
      # Ragged packs count unused slot capacity in min-bucket units.
      n_model_pad_rows=packs.n_pad_rows,
      n_model_pad_rows_by_bucket=dict(by_bucket[2]),
      device_epilogue=int(runner.device_epilogue),
      d2h_bytes_per_pack=runner.d2h_bytes_per_pack,
      device=str(runner.device),
      dtype=str(runner.model.compute_dtype).replace('torch.', ''),
      inference_dtype=runner.inference_dtype,
      n_quantized_matmuls=runner.n_quantized_matmuls,
  )
  with open(output + '.inference.json', 'w') as f:
    json.dump(counters, f, indent=2, sort_keys=True)
  return counters
