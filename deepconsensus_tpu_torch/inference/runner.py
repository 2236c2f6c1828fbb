"""Inference: BAM -> windows -> model on the card -> FASTQ or BAM.

Port of deepconsensus_tpu/inference/runner.py. `run_inference` is a
three-stage pipeline:

1. a producer thread decodes the BAMs (natively, `native/`) and
   featurizes batches of `batch_zmws` ZMWs, in-process or in a
   featurization worker pool (`cpus` > 1, `inference/featurize.py`);
2. the model stage on the calling thread triages each batch's windows
   (CCS adoption for overflow and high-quality windows) and submits the
   rest to a `ConsensusEngine` (inference/engine.py), whose packers cut
   full packs across featurize batches (`pack_across_batches`) and keep
   up to `dispatch_depth` of them in flight on the card;
3. an emit thread behind a queue of `emit_queue_depth` batches stitches
   each completed batch's molecules and writes the reads.

`dispatch_depth=1, pack_across_batches=False, cpus=0` give the output
of a serial run. A run makes glibc keep freed heap memory in the
process (_keep_freed_heap), so the threads' batches reuse it. The reference's resume, sharding, tracing and fault
quarantine are not part of the port yet (ROADMAP); a decode or model
error fails the run.

The model stage ships each pack to the card compactly, as in the
reference: uint8 rows (the ccs_bq row biased by +1 so its -1 gaps
survive) plus float SN scalars ([B, 4] per window, or [slots, wps, 4]
per window of a ragged slot), reassembled on the card. On the card,
ModelRunner.dispatch formats each pack into a ring of pinned host
buffers, copies it to the card on a copy stream (the forward's stream
waits on the copy's event, so one pack's copy overlaps the forward
before it), launches the forward and copies the two output planes
back into pinned buffers without blocking; finalize waits only on that
pack's event. On the CPU the same code runs without pinning or
streams.

Mixed-width windows (--use_ccs_smart_windows with --window_buckets, e.g.
100,200) run per bucket by default: windows of at most 128 positions
take the fused route (K1, K2), wider ones the encoder's module route
(K8 under use_pallas_attention). With --use_ragged_kernel they pack
into ragged slots of the largest bucket and run through the model's
ragged forward (K4, then K2 with lengths). The output plane (K3) leaves
the card as two uint8 planes.

The inference levers (--inference_dtype bfloat16, --quantize_matmuls
int8) apply once when ModelRunner loads the weights
(models/quantize.py); the sidecar records `inference_dtype` and
`n_quantized_matmuls`. Under int8 each encoder block runs K2's int8
variant.

Besides the output, a run writes `<output>.inference.json` (counters,
each stage's seconds and what was not timed) and
`<output>.runtime.csv` (one row per batch and stage).
"""
from __future__ import annotations

import collections
import csv
import ctypes
import dataclasses
import itertools
import json
import os
import queue as queue_lib
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from deepconsensus_tpu_torch.calibration import lib as calibration_lib
from deepconsensus_tpu_torch.devices import resolve_device
from deepconsensus_tpu_torch.inference import engine as engine_lib
from deepconsensus_tpu_torch.inference import featurize as featurize_lib
from deepconsensus_tpu_torch.io import bam as bam_lib
from deepconsensus_tpu_torch.models import config as config_lib
from deepconsensus_tpu_torch.models import data as data_lib
from deepconsensus_tpu_torch.models import model as model_lib
from deepconsensus_tpu_torch.models import quantize as quantize_lib
from deepconsensus_tpu_torch.ops import output_plane
from deepconsensus_tpu_torch.ops import ragged_window_attention as rwa
from deepconsensus_tpu_torch.postprocess import stitch
from deepconsensus_tpu_torch.preprocess.feeder import create_proc_feeder
from deepconsensus_tpu_torch.preprocess.pileup import FeatureLayout, row_indices
from deepconsensus_tpu_torch.utils import phred

preprocess_zmw = featurize_lib.preprocess_zmw

STAGES = ('dc_input', 'tf_examples', 'run_model', 'full')


@dataclasses.dataclass
class InferenceOptions:
  """Knobs of the inference pipeline (a subset of the reference's
  InferenceOptions)."""

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
  # ModelRunner (_apply_quant_levers) and applied once at load.
  # inference_dtype: None keeps the checkpoint's float32 weights and
  # params.dtype; 'bfloat16' casts the weights and runs the model in
  # bfloat16. quantize_matmuls: None or 'none' off; 'int8' quantizes the
  # encoder matmuls.
  inference_dtype: Optional[str] = None
  quantize_matmuls: Optional[str] = None
  ins_trim: int = 5
  max_base_quality: int = 93
  limit: int = 0
  # > 1: featurization worker processes (tensors travel through shared
  # memory). The reference's measured caveat holds: the IPC can eat
  # the gain on a fast host.
  cpus: int = 0
  # Packs in flight on the card (per packer) before the oldest is
  # drained; also the number of pinned input buffers per pack shape.
  dispatch_depth: int = 8
  # Cut model packs from a window buffer spanning featurize batches, so
  # only the end-of-input tail pads (False pads each batch's tail).
  pack_across_batches: bool = True
  # Featurize batches queued between the model stage and the emit
  # thread before the model stage blocks.
  emit_queue_depth: int = 4
  # Debug stage truncation (reference DebugStage): dc_input stops after
  # BAM decode, tf_examples after featurize, run_model after the model.
  end_after_stage: str = 'full'  # dc_input | tf_examples | run_model | full
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


# glibc mallopt parameters (malloc.h) and what run_inference sets them
# to: keep up to 1 GiB of freed heap, grow the heap 1 GiB at a time,
# and serve blocks under 256 MiB from the heap rather than from mmap.
_MALLOPT = ((-1, 1 << 30),   # M_TRIM_THRESHOLD
            (-2, 1 << 30),   # M_TOP_PAD
            (-3, 256 << 20))  # M_MMAP_THRESHOLD


def _keep_freed_heap() -> bool:
  """Makes glibc keep freed memory in the process (_MALLOPT). The
  producer and emit threads build each batch's reads and features in
  per-thread arenas, which by default hand freed memory back to the
  system and fault it in again for the next batch; where page faults
  are dear (an H100 host's first runs: BAM decode 1.1-2.1 s against
  0.24-0.26 s with these settings) that cost more than the decode.
  Process-wide and idempotent; False where the C library is not
  glibc."""
  try:
    mallopt = ctypes.CDLL('libc.so.6').mallopt
    mallopt.argtypes = (ctypes.c_int, ctypes.c_int)
    mallopt.restype = ctypes.c_int
    return all(mallopt(param, value) == 1 for param, value in _MALLOPT)
  except (OSError, AttributeError):
    return False


def _union_seconds(spans: List[Tuple[float, float]]) -> float:
  """The length of the union of (start, end) intervals."""
  total, reach = 0.0, float('-inf')
  for start, end in sorted(spans):
    if end > reach:
      total += end - max(start, reach)
      reach = end
  return total


class _HostRing:
  """Host buffers of one pack shape, handed out round robin and
  allocated at first use (pinned on the card's host side). A slot is
  handed out again only after the event its last user left has
  completed (the H2D copy that read it), and an output slot whose pack
  is not finalized yet is first drained into that pack's own arrays."""

  def __init__(self, specs: Dict[str, Tuple[Tuple[int, ...], torch.dtype]],
               n_slots: int, pin: bool):
    self._specs = specs
    self._pin = pin
    self._slots: List[Optional[Dict[str, torch.Tensor]]] = [None] * n_slots
    self._free_after: List[Any] = [None] * n_slots
    self.owners: List[Any] = [None] * n_slots
    self._next = 0

  def take(self, owner=None) -> Tuple[int, Dict[str, torch.Tensor]]:
    i = self._next
    self._next = (i + 1) % len(self._slots)
    if self._free_after[i] is not None:
      self._free_after[i].synchronize()
      self._free_after[i] = None
    if self.owners[i] is not None:
      self.owners[i].drain()
    if self._slots[i] is None:
      self._slots[i] = {
          name: torch.empty(shape, dtype=dtype, pin_memory=self._pin)
          for name, (shape, dtype) in self._specs.items()}
    self.owners[i] = owner
    return i, self._slots[i]

  def free_after(self, i: int, event) -> None:
    self._free_after[i] = event


class _DispatchHandle:
  """One in-flight pack: the runner's dispatch contract. Holds the
  pack's pinned output slot and, on the card, its CUDA events (H2D
  start and end on the copy stream; forward start, forward end and D2H
  end on the compute stream). drain() waits on the last event only and
  copies the delivered rows out of the slot."""

  __slots__ = ('n', 'ragged', 'lengths', 'host_out', 'events', 'ring',
               'slot', 'result')

  def __init__(self, n: int, ragged: bool, lengths: Optional[np.ndarray]):
    self.n = n
    self.ragged = ragged
    self.lengths = lengths  # [n_slots, wps] for a ragged pack
    self.host_out: Tuple[torch.Tensor, ...] = ()
    self.events: Tuple[Any, ...] = ()
    self.ring: Optional[_HostRing] = None
    self.slot = -1
    self.result: Optional[Tuple[np.ndarray, np.ndarray]] = None

  @property
  def done(self) -> bool:
    return not self.events or self.events[-1].query()

  def drain(self) -> Tuple[np.ndarray, np.ndarray]:
    if self.result is None:
      if self.events:
        self.events[-1].synchronize()
      self.result = tuple(np.array(t.numpy()[:self.n])
                          for t in self.host_out)
      self.host_out = ()
      if self.ring is not None and self.ring.owners[self.slot] is self:
        self.ring.owners[self.slot] = None
    return self.result


class ModelRunner:
  """The model stage: (formatted window rows) -> (base ids, qualities).

  device=None means the card and raises when none is present; tests
  pass device='cpu'. plain=True runs the fused route through the
  kernels' plain versions on the same device (the reference run that
  the kernels are held against on the card). The inference levers of
  options are folded into params (_apply_quant_levers), and those in
  params (params.inference_dtype, params.quantize_matmuls) are applied
  to state_dict here, before the weights go to the device.

  dispatch()/dispatch_ragged() return a _DispatchHandle while the card
  may still be working; finalize() resolves one. One thread drives a
  runner.
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
    self._cuda = self.device.type == 'cuda'
    self._copy_stream = (torch.cuda.Stream(self.device) if self._cuda
                         else None)
    self._rings: Dict[Tuple[Any, ...], _HostRing] = {}
    self._last: Optional[_DispatchHandle] = None
    self.d2h_bytes_per_pack = 0
    self.reset_timing()

  def reset_timing(self) -> None:
    """Zeroes the model stage's clocks and transfer counters."""
    self.model_seconds = 0.0  # host time inside dispatch and finalize
    self._t_first_dispatch: Optional[float] = None
    self._t_last_finalize: Optional[float] = None
    self._pack_events: List[Tuple[Any, ...]] = []
    self.n_transfer_overlapped = 0
    self.n_transfer_direct = 0

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

  def _ring(self, key: Tuple[Any, ...], specs, n_slots: int) -> _HostRing:
    ring = self._rings.get(key)
    if ring is None:
      ring = self._rings[key] = _HostRing(specs, n_slots, pin=self._cuda)
    return ring

  def _format_main(self, rows: np.ndarray, main: np.ndarray) -> None:
    """Writes the non-SN rows of [n, R, L, 1] into main [B, R-4, L] as
    uint8, the ccs_bq row biased by +1; rows past n are zero (their
    ccs_bq row 1, as a zero row biased)."""
    n = rows.shape[0]
    np.copyto(main[:n], rows[:, :-_SN_ROWS, :, 0], casting='unsafe')
    main[n:] = 0
    if self._bq_row is not None:
      np.copyto(main[:n, self._bq_row], rows[:, self._bq_row, :, 0] + 1.0,
                casting='unsafe')
      main[n:, self._bq_row] = 1

  def _start(self) -> float:
    t0 = time.perf_counter()
    if self._t_first_dispatch is None:
      self._t_first_dispatch = t0
    return t0

  def dispatch(self, rows: np.ndarray) -> _DispatchHandle:
    """Starts one pack: rows [n, R, L, 1] formatted windows (n <=
    batch_size), padded to batch_size. The card may still be working
    when this returns."""
    t0 = self._start()
    n, total_rows, width, _ = rows.shape
    batch = self.options.batch_size
    if n > batch:
      raise ValueError(f'{n} windows exceed batch_size {batch}')
    main_rows = total_rows - _SN_ROWS
    ring = self._ring(
        ('pack', batch, main_rows, width),
        {'main': ((batch, main_rows, width), torch.uint8),
         'sn': ((batch, _SN_ROWS), torch.float32)},
        max(1, self.options.dispatch_depth))
    slot, bufs = ring.take()
    self._format_main(rows, bufs['main'].numpy())
    sn = bufs['sn'].numpy()
    sn[:n] = rows[:, -_SN_ROWS:, 0, 0]
    sn[n:] = 0

    def forward(dev):
      return self.model(_assemble_rows(dev['main'], dev['sn'], self._bq_row),
                        plain=self.plain)

    handle = self._launch(ring, slot, bufs, forward,
                          _DispatchHandle(n, False, None))
    self.model_seconds += time.perf_counter() - t0
    return handle

  def dispatch_ragged(self, rows: np.ndarray,
                      lengths: np.ndarray) -> _DispatchHandle:
    """dispatch() for one ragged pack: rows [n_slots, R, slot_len, 1]
    with mixed-width windows packed back to back per slot, lengths
    [n_slots, wps] int32 window widths (0 = unused capacity). The SN
    plane ships as per-window scalars [n_slots, wps, 4], sampled at each
    window's start column."""
    t0 = self._start()
    n_slots, total_rows, slot_len, _ = rows.shape
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    wps = lengths.shape[1]
    main_rows = total_rows - _SN_ROWS
    ring = self._ring(
        ('ragged', n_slots, main_rows, slot_len, wps),
        {'main': ((n_slots, main_rows, slot_len), torch.uint8),
         'sn': ((n_slots, wps, _SN_ROWS), torch.float32),
         'lengths': ((n_slots, wps), torch.int32)},
        max(1, self.options.dispatch_depth))
    slot, bufs = ring.take()
    self._format_main(rows, bufs['main'].numpy())
    starts = np.zeros_like(lengths)
    starts[:, 1:] = np.cumsum(lengths[:, :-1], axis=1)
    sn_planes = rows[:, -_SN_ROWS:, :, 0]  # [n_slots, 4, slot_len]
    sn_w = np.take_along_axis(
        sn_planes, np.clip(starts, 0, slot_len - 1)[:, None, :], axis=2)
    bufs['sn'].numpy()[...] = (
        sn_w.transpose(0, 2, 1) * (lengths > 0)[:, :, None])
    bufs['lengths'].numpy()[...] = lengths

    def forward(dev):
      rows_dev = _assemble_rows_ragged(dev['main'], dev['sn'],
                                       dev['lengths'], self._bq_row)
      return self.model(rows_dev, plain=self.plain,
                        window_lengths=dev['lengths'])

    handle = self._launch(ring, slot, bufs, forward,
                          _DispatchHandle(n_slots, True, lengths))
    self.model_seconds += time.perf_counter() - t0
    return handle

  def _launch(self, ring: _HostRing, slot: int, bufs, forward,
              handle: _DispatchHandle) -> _DispatchHandle:
    """Copies a formatted input slot to the device, runs the forward
    and the output plane, and queues the outputs' copy into a pinned
    output slot. On the card the copy runs on the copy stream; the
    compute stream waits on its event, and the device inputs are
    recorded on the compute stream so their memory outlives the
    forward."""
    events: Tuple[Any, ...] = ()
    if self._cuda:
      if self._last is not None and not self._last.done:
        self.n_transfer_overlapped += 1
      else:
        self.n_transfer_direct += 1
      compute = torch.cuda.current_stream(self.device)
      h2d_start = torch.cuda.Event(enable_timing=True)
      h2d_end = torch.cuda.Event(enable_timing=True)
      with torch.cuda.stream(self._copy_stream):
        h2d_start.record()
        dev = {k: v.to(self.device, non_blocking=True)
               for k, v in bufs.items()}
        h2d_end.record()
      ring.free_after(slot, h2d_end)
      compute.wait_event(h2d_end)
      for t in dev.values():
        t.record_stream(compute)
      fwd_start = torch.cuda.Event(enable_timing=True)
      fwd_start.record(compute)
      events = (h2d_start, h2d_end, fwd_start)
    else:
      self.n_transfer_direct += 1
      dev = bufs
    out = self._epilogue(forward(dev))
    if self._cuda:
      fwd_end = torch.cuda.Event(enable_timing=True)
      fwd_end.record()
      events += (fwd_end,)
    shapes = tuple((tuple(t.shape), t.dtype) for t in out)
    out_ring = self._ring(
        ('out',) + shapes, dict(zip(('a', 'b'), shapes)),
        max(1, self.options.dispatch_depth) + 1)
    handle.slot, host = out_ring.take(handle)
    handle.ring = out_ring
    handle.host_out = (host['a'], host['b'])
    for dst, src in zip(handle.host_out, out):
      dst.copy_(src, non_blocking=self._cuda)
    if self._cuda:
      d2h_end = torch.cuda.Event(enable_timing=True)
      d2h_end.record()
      events += (d2h_end,)
    handle.events = events
    self.d2h_bytes_per_pack = int(sum(t.nbytes for t in handle.host_out))
    self._last = handle
    return handle

  def _epilogue(self, preds: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    if self._thresholds is not None:
      epilogue = (output_plane.phred_epilogue_plain if self.plain
                  else output_plane.phred_epilogue)
      return epilogue(preds, self._thresholds)
    max_prob, pred_ids = preds.max(dim=-1)
    return pred_ids.to(torch.int32), max_prob

  def finalize(self, handle: _DispatchHandle) -> Tuple[np.ndarray, np.ndarray]:
    """Resolves a dispatch into (base ids [n, L], qualities [n, L]),
    waiting on that pack's own event only (ragged: [n_slots, slot_len]
    planes)."""
    t0 = time.perf_counter()
    out_a, out_b = handle.drain()
    if handle.events:
      self._pack_events.append(handle.events)
    if not self.device_epilogue:
      out_b = output_plane.host_quality_reference(
          out_b, self.options.dc_calibration_values,
          self.options.max_base_quality)
    self._t_last_finalize = time.perf_counter()
    self.model_seconds += self._t_last_finalize - t0
    return out_a, out_b

  def predict(self, rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Synchronous dispatch + finalize."""
    return self.finalize(self.dispatch(rows))

  def device_seconds(self) -> Dict[str, Optional[float]]:
    """The finalized packs' device time by CUDA events: H2D copies,
    forwards (with the output plane, from the moment the compute stream
    reached the pack) and D2H copies, each summed; the time the card was
    busy with packs (the union of those intervals, so an H2D copy that
    overlaps a forward counts once); the model stage's wall time (first
    dispatch to last finalize, host clock) and the share of it the card
    was not busy with packs. None off the card."""
    keys = ('h2d_seconds', 'device_forward_seconds', 'd2h_seconds',
            'model_device_seconds', 'model_stage_wall_seconds',
            'model_idle_share')
    if not self._cuda or not self._pack_events:
      return dict.fromkeys(keys)
    # Every event's time from the first pack's H2D start, the earliest.
    origin = self._pack_events[0][0]
    sums = [0.0, 0.0, 0.0]
    spans = []
    for events in self._pack_events:
      at = [origin.elapsed_time(e) / 1e3 for e in events]
      for i, (a, b) in enumerate(((0, 1), (2, 3), (3, 4))):
        sums[i] += events[a].elapsed_time(events[b]) / 1e3
        spans.append((at[a], at[b]))
    busy = _union_seconds(spans)
    wall = self._t_last_finalize - self._t_first_dispatch
    return dict(zip(keys, sums + [busy, wall, 1.0 - busy / wall]))

  def dispatch_stats(self) -> Dict[str, Any]:
    """Transfer counters for the sidecar. A transfer counts as
    overlapped when the pack before it had not finished on the card
    when its copy was queued."""
    launches = self.n_transfer_overlapped + self.n_transfer_direct
    return {
        'n_transfer_overlapped': self.n_transfer_overlapped,
        'n_transfer_direct': self.n_transfer_direct,
        'transfer_overlap_fraction': (
            round(self.n_transfer_overlapped / launches, 4)
            if launches else 0.0),
    }


def run_model_on_windows(
    feature_dicts: List[Dict[str, Any]],
    runner: ModelRunner,
    params,
    options: InferenceOptions,
) -> List[stitch.DCModelOutput]:
  """Formats, batches and runs windows through the model, keeping up to
  options.dispatch_depth packs in flight and draining them in order
  (reference: quick_inference.py:341-415)."""
  outputs: List[stitch.DCModelOutput] = []
  pending: collections.deque = collections.deque()
  depth = max(1, options.dispatch_depth)

  def drain(chunk, handle) -> None:
    pred_ids, quality = runner.finalize(handle)
    for c, ids, quals in zip(chunk, pred_ids, quality):
      outputs.append(stitch.DCModelOutput(
          window_pos=c['window_pos'],
          molecule_name=(c['name'] if isinstance(c['name'], str)
                         else c['name'].decode()),
          sequence=phred.encoded_sequence_to_string(ids),
          quality_string=phred.quality_scores_to_string(quals),
          ec=c['ec'], np_num_passes=c['np_num_passes'], rq=c['rq'],
          rg=c['rg']))

  for start in range(0, len(feature_dicts), options.batch_size):
    chunk = feature_dicts[start:start + options.batch_size]
    rows = data_lib.format_rows_batch(
        np.stack([c['subreads'] for c in chunk]), params)
    pending.append((chunk, runner.dispatch(rows)))
    if len(pending) > depth:
      drain(*pending.popleft())
  while pending:
    drain(*pending.popleft())
  return outputs


class _MolState:
  """One molecule's windows accumulating toward stitch/emit. Model
  windows are appended as placeholders and filled when their pack
  finalizes."""

  __slots__ = ('name', 'batch', 'meta', 'pos', 'ids', 'quals')

  def __init__(self, name: str, batch: '_BatchState', meta: Tuple):
    self.name = name
    self.batch = batch
    self.meta = meta  # (ec, np_num_passes, rq, rg)
    self.pos: List[int] = []
    self.ids: List[Optional[np.ndarray]] = []
    self.quals: List[Optional[np.ndarray]] = []

  def append_resolved(self, window_pos: int, ids: np.ndarray,
                      quals: np.ndarray) -> None:
    self.pos.append(window_pos)
    self.ids.append(ids)
    self.quals.append(quals)

  def append_pending(self, window_pos: int) -> int:
    idx = len(self.pos)
    self.append_resolved(window_pos, None, None)
    self.batch.pending += 1
    return idx

  def set_result(self, idx: int, ids: np.ndarray, quals: np.ndarray) -> None:
    self.ids[idx] = ids
    self.quals[idx] = quals
    self.batch.pending -= 1


class _BatchState:
  """Completion tracker for one featurize batch flowing through the
  packed model stage toward the emit thread."""

  __slots__ = ('feat', 'mols', 'pending', 'featurized', 'n_windows')

  def __init__(self, feat: Dict[str, Any]):
    self.feat = feat
    self.mols: Dict[str, _MolState] = {}
    self.pending = 0
    self.featurized = False
    self.n_windows = 0

  def mol(self, fd: Dict[str, Any]) -> _MolState:
    name = (fd['name'] if isinstance(fd['name'], str)
            else fd['name'].decode())
    state = self.mols.get(name)
    if state is None:
      state = self.mols[name] = _MolState(
          name, self, (fd['ec'], fd['np_num_passes'], fd['rq'], fd['rg']))
    return state

  @property
  def complete(self) -> bool:
    return self.featurized and self.pending == 0


def _open_sink(output: str, out_tmp: str, ccs_bam: str):
  """(emit_read(name, seq, quals, meta), close) for FASTQ, or for BAM
  when output ends in .bam: unaligned records with the ec/np/rq/RG/zm
  tags under the CCS BAM's header (reference:
  quick_inference.py:738-760, 894-897)."""
  if not output.endswith('.bam'):
    sink = open(out_tmp, 'wb')

    def emit_fastq(name: str, seq: bytes, quals: np.ndarray, meta) -> None:
      del meta
      sink.write(stitch.format_fastq_bytes(name, seq, quals))

    return emit_fastq, sink.close
  from deepconsensus_tpu_torch.io.bam_writer import BamWriter

  header_text = '@HD\tVN:1.5\tSO:unknown\n'
  with bam_lib.BamReader(ccs_bam) as ccs_reader:
    if ccs_reader.header_text:
      header_text = ccs_reader.header_text
      if not header_text.endswith('\n'):
        header_text += '\n'
  writer = BamWriter(out_tmp, header_text=header_text)

  def emit_bam(name: str, seq: bytes, quals: np.ndarray, meta) -> None:
    ec, np_passes, rq, rg = meta
    tags = {}
    if ec is not None:
      tags['ec'] = float(ec)
    if np_passes is not None:
      tags['np'] = int(np_passes)
    if rq is not None:
      tags['rq'] = float(rq)
    if rg is not None:
      tags['RG'] = str(rg)
    # Names without the movie/zmw/type structure get no zm tag.
    parts = name.split('/')
    if len(parts) >= 2:
      try:
        tags['zm'] = int(parts[1])
      except ValueError:
        pass
    writer.write(name, seq.decode('ascii'),
                 np.asarray(quals, dtype=np.uint8), tags=tags)

  return emit_bam, writer.close


def run_inference(
    subreads_to_ccs: str,
    ccs_bam: str,
    output: str,
    runner: ModelRunner,
) -> Dict[str, Any]:
  """The three-stage pipeline with runner's model and options; writes
  `output` (FASTQ, or BAM when it ends in .bam),
  `<output>.inference.json` and `<output>.runtime.csv`, and returns
  the counters.

  Counter discipline: the producer thread owns the feeder's counter,
  the model stage the window counts, the emit thread the outcome
  counts; they merge after both threads have joined.
  """
  options = runner.options
  params = runner.params
  stage = options.end_after_stage
  if stage not in STAGES:
    raise ValueError(f'end_after_stage must be one of {STAGES}, '
                     f'got {stage!r}')
  options.max_passes = params.max_passes
  options.max_length = params.max_length
  options.use_ccs_bq = params.use_ccs_bq
  runner.reset_timing()
  _keep_freed_heap()
  t_start = time.perf_counter()
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
  # Opening the BAMs inflates them (native) or reads their headers.
  open_seconds = time.perf_counter() - t_start
  model_mode = stage in ('run_model', 'full')
  full_mode = stage == 'full'
  outcome = stitch.OutcomeCounter()
  window_counter: collections.Counter = collections.Counter()
  timing_rows: List[Dict[str, Any]] = []
  # Seconds per stage, each entry written by one thread only.
  clock = {'decode': open_seconds, 'featurize': 0.0, 'ingest': 0.0,
           'stitch': 0.0}
  pool = None
  shm_prefix = f'dctorch_{os.getpid()}_{id(timing_rows)}_'
  out_tmp = output + '.tmp'
  emit_read, close_sink = _open_sink(output, out_tmp, ccs_bam)
  feat_queue: queue_lib.Queue = queue_lib.Queue(maxsize=2)
  stop = threading.Event()
  states: collections.deque = collections.deque()
  engine: Optional[engine_lib.ConsensusEngine] = None
  if model_mode:
    # Tickets are (molecule, index) slots; a delivered row resolves its
    # molecule's pending window.
    engine = engine_lib.ConsensusEngine(
        runner, options,
        deliver=lambda slot, ids, quals: slot[0].set_result(
            slot[1], ids, quals),
        timing_rows=timing_rows)

  def put(item) -> bool:
    """Bounded put that gives up once the model stage has stopped."""
    while not stop.is_set():
      try:
        feat_queue.put(item, timeout=0.5)
        return True
      except queue_lib.Full:
        continue
    return False

  def featurize_batch(zmw_batch, seq: int) -> Dict[str, Any]:
    t0 = time.perf_counter()
    segments = []
    if pool is not None:
      pairs, segments = featurize_lib.featurize_with_pool(
          pool, zmw_batch, f'{shm_prefix}b{seq}_')
    else:
      pairs = [(z, *preprocess_zmw(z)) for z in zmw_batch]
    elapsed = time.perf_counter() - t0
    clock['featurize'] += elapsed
    return {
        'windows': [w for _, features, _ in pairs for w in features],
        'counters': [c for _, _, c in pairs],
        'n_subreads': sum(len(z[0]) - 1 for z in zmw_batch),
        'n_zmws': len(zmw_batch),
        'preprocess_time': elapsed,
        'shm_handles': segments,
    }

  def producer() -> None:
    try:
      zmws = feeder()
      seq = 0
      while True:
        t0 = time.perf_counter()
        zmw_batch = list(itertools.islice(zmws, options.batch_zmws or None))
        decoded = time.perf_counter() - t0
        clock['decode'] += decoded
        if not zmw_batch:
          break
        if stage == 'dc_input':
          timing_rows.append(dict(
              stage='dc_input', runtime=decoded, n_zmws=len(zmw_batch),
              n_examples=0,
              n_subreads=sum(len(z[0]) - 1 for z in zmw_batch)))
          continue
        feat = featurize_batch(zmw_batch, seq)
        seq += 1
        if not put(('batch', feat)):
          # The model stage stopped: nobody else owns these segments.
          featurize_lib.release_segments(feat['shm_handles'])
          return
      put(('done', None))
    except BaseException as e:  # surfaced on the model stage's thread
      put(('error', e))

  def ingest_batch(feat: Dict[str, Any]) -> None:
    """Model stage: triage one featurize batch and submit its model
    windows. The batch completes (and may go to the emit thread) once
    every pack holding its windows has been finalized."""
    for zmw_counter in feat['counters']:
      window_counter.update(zmw_counter)
    windows = feat['windows']
    timing_rows.append(dict(
        stage='preprocess', runtime=feat['preprocess_time'],
        n_zmws=feat['n_zmws'], n_examples=len(windows),
        n_subreads=feat['n_subreads']))
    if not model_mode:
      return
    state = _BatchState(feat)
    state.n_windows = len(windows)
    to_model, to_skip = engine_lib.triage_windows(windows, options,
                                                  window_counter)
    for fd in to_skip:
      state.mol(fd).append_resolved(
          fd['window_pos'], *engine_lib.skipped_window_arrays(fd, options))
    slots = []
    for fd in to_model:
      mol = state.mol(fd)
      slots.append((mol, mol.append_pending(fd['window_pos'])))
    if to_model:
      # A list: widths may mix; the engine groups them per bucket in
      # featurize order (and copies the rows out of any shm segment).
      engine.submit([fd['subreads'] for fd in to_model], slots)
      if not options.pack_across_batches:
        engine.flush(drain=False)
    feat['windows'] = None
    state.featurized = True
    states.append(state)

  emit_queue: Optional[queue_lib.Queue] = None
  emit_thread: Optional[threading.Thread] = None
  emit_error: List[Optional[BaseException]] = [None]

  def check_emit() -> None:
    if emit_error[0] is not None:
      raise emit_error[0]

  def emit_batch_state(state: _BatchState) -> None:
    """Emit thread: stitch, filter and write one featurize batch's
    molecules, sorted by name."""
    t0 = time.perf_counter()
    for name in sorted(state.mols):
      mol = state.mols[name]
      result = stitch.stitch_arrays(
          name, np.asarray(mol.pos, dtype=np.int64), mol.ids, mol.quals,
          max_length=options.max_length, min_quality=options.min_quality,
          min_length=options.min_length, outcome_counter=outcome)
      if result is not None:
        emit_read(name, result[0], result[1], mol.meta)
    elapsed = time.perf_counter() - t0
    clock['stitch'] += elapsed
    feat = state.feat
    timing_rows.append(dict(
        stage='stitch_and_write_fastq', runtime=elapsed,
        n_zmws=feat['n_zmws'], n_examples=state.n_windows,
        n_subreads=feat['n_subreads']))

  def emit_worker() -> None:
    try:
      while True:
        state = emit_queue.get()
        if state is None:
          return
        emit_batch_state(state)
    except BaseException as e:  # surfaced by check_emit()
      emit_error[0] = e

  def emit_put(state) -> None:
    """Bounded put that surfaces an emit-thread death instead of
    blocking forever on its queue."""
    while True:
      check_emit()
      try:
        emit_queue.put(state, timeout=0.5)
        return
      except queue_lib.Full:
        continue

  def pop_ready() -> None:
    """Hands completed batches to the emit thread in featurize order
    (packs drain FIFO, so completion is monotone in that order)."""
    while states and states[0].complete:
      state = states.popleft()
      if emit_thread is not None:
        emit_put(state)

  thread = threading.Thread(target=producer, daemon=True)
  n_batches = 0
  try:
    if options.cpus and options.cpus > 1 and stage != 'dc_input':
      pool = featurize_lib.make_pool(options.cpus)
    if full_mode:
      emit_queue = queue_lib.Queue(maxsize=max(1, options.emit_queue_depth))
      emit_thread = threading.Thread(target=emit_worker, daemon=True)
      emit_thread.start()
    thread.start()
    while True:
      kind, payload = feat_queue.get()
      if kind == 'done':
        break
      if kind == 'error':
        raise payload
      t0 = time.perf_counter()
      try:
        check_emit()
        ingest_batch(payload)
      finally:
        featurize_lib.release_segments(payload['shm_handles'])
        clock['ingest'] += time.perf_counter() - t0
      pop_ready()
      n_batches += 1
    t0 = time.perf_counter()
    if engine is not None:
      engine.flush()  # end of input: cut the tail packs, drain all
    clock['ingest'] += time.perf_counter() - t0
    pop_ready()
    if states:
      raise RuntimeError(f'{len(states)} featurize batch(es) never '
                         'completed the model stage')
    if emit_thread is not None:
      emit_put(None)
      emit_thread.join()
      check_emit()
  finally:
    stop.set()
    if thread.ident is not None:
      thread.join(timeout=30)
    if emit_thread is not None and emit_thread.is_alive():
      try:
        emit_queue.put(None, timeout=30)
      except queue_lib.Full:
        pass  # the emit thread is stuck; it is a daemon
      emit_thread.join(timeout=30)
    if not thread.is_alive():
      # Batches queued on an error path still own their segments.
      while True:
        try:
          kind, payload = feat_queue.get_nowait()
        except queue_lib.Empty:
          break
        if kind == 'batch':
          featurize_lib.release_segments(payload['shm_handles'])
    if pool is not None:
      pool.terminate()
      pool.join()
    close_sink()
  os.replace(out_tmp, output)

  total = time.perf_counter() - t_start
  counters: Dict[str, Any] = dict(counter)
  counters.update(window_counter)
  counters.update(dataclasses.asdict(outcome))
  # Host stages; untimed_seconds is total_seconds minus their sum, and
  # negative where stages on different threads overlap.
  timings = {
      'bam_decode_seconds': clock['decode'],
      'featurize_seconds': clock['featurize'],
      'triage_format_seconds': clock['ingest'] - runner.model_seconds,
      'model_seconds': runner.model_seconds,
      'stitch_seconds': clock['stitch'],
  }
  counters.update({k: round(v, 6) for k, v in timings.items()})
  counters['untimed_seconds'] = round(total - sum(timings.values()), 6)
  counters.update(runner.device_seconds())
  counters.update(runner.dispatch_stats())
  if engine is not None:
    n_windows_by_bucket = engine.n_windows_by_bucket
    packs = (engine.n_packs, engine.n_pack_rows, engine.n_pad_rows,
             engine.n_packs_by_bucket, engine.n_pad_rows_by_bucket,
             engine.n_starvation_flushes)
  else:
    n_windows_by_bucket = dict.fromkeys(runner.window_buckets, 0)
    packs = (0, 0, 0, {}, {}, 0)
  counters.update(
      total_seconds=round(total, 6),
      bam_open_seconds=round(open_seconds, 6),
      end_after_stage=stage,
      bam_decoder=feeder.bam_decoder,
      output_format='bam' if output.endswith('.bam') else 'fastq',
      n_featurize_batches=n_batches,
      cpus=options.cpus,
      dispatch_depth=options.dispatch_depth,
      pack_across_batches=int(options.pack_across_batches),
      emit_queue_depth=options.emit_queue_depth,
      window_buckets=list(runner.window_buckets),
      use_ragged_kernel=int(options.use_ragged_kernel),
      n_windows_by_bucket=n_windows_by_bucket,
      n_model_packs=packs[0],
      n_model_pack_rows=packs[1],
      # Ragged packs count unused slot capacity in min-bucket units.
      n_model_pad_rows=packs[2],
      n_model_packs_by_bucket=packs[3],
      n_model_pad_rows_by_bucket=packs[4],
      n_starvation_flushes=packs[5],
      device_epilogue=int(runner.device_epilogue),
      d2h_bytes_per_pack=runner.d2h_bytes_per_pack,
      device=str(runner.device),
      dtype=str(runner.model.compute_dtype).replace('torch.', ''),
      inference_dtype=runner.inference_dtype,
      n_quantized_matmuls=runner.n_quantized_matmuls,
  )
  with open(output + '.runtime.csv', 'w', newline='') as f:
    writer = csv.DictWriter(f, fieldnames=['stage', 'runtime', 'n_zmws',
                                           'n_examples', 'n_subreads'])
    writer.writeheader()
    writer.writerows(timing_rows)
  with open(output + '.inference.json', 'w') as f:
    json.dump(counters, f, indent=2, sort_keys=True)
  return counters
