#!/usr/bin/env python3
"""Where a bucketed `cli train` step's extra time comes from, on the card.

  python3 scripts/probe_train_data.py [--dtype bfloat16] [--repeats 2]
      [--variants memory,memory_sync,...] [--profile]

Builds chip_smoke.py's train_data inputs (the ragged cell's BAMs, their
synthetic truth, `cli preprocess` at --example_width 200 over the smart
windows and with fixed 100-wide windows), then runs `cli train
--window_buckets 100,200` (batch 256, 6 steps, use_pallas_attention,
attention dropout 0) with the host side of the input switched piece by
piece:

  memory            the in-memory DatasetIterator, no augmentation;
  memory_augment    the same with --set augment=true;
  stream            --set streaming=true, loader_workers 0;
  stream_workers    the same with loader_workers 2;
  path              streaming, 2 workers and augmentation (chip_smoke's
                    train_data runs);
  memory_sync       `memory` with the H2D copy made in the training loop
                    (TrainBatchPrefetcher replaced by a synchronous
                    batch_to_device);
  w100              one width: the fixed 100-wide shards alone, no
                    buckets, in memory;
  w100_sync         the same, synchronous copy;
  synthetic_w100    chip_smoke's `train` shards (synthetic, 100 wide),
                    no buckets, in memory, as the train_attn runs take
                    them but without attention dropout.

`--profile` adds one profiled step (torch.profiler, after two warm-up
steps) on the first 100-wide batch of the preprocessed data and of the
synthetic shards, full width, seeded weights: the device time and the
kernels that take most of it.

Each variant runs `--repeats` times, in the order given and then in
reverse, in one process on one card. Prints one JSON line a run with
each step's ms and width and the per-width step p50 (host clock around
the step, synchronized), then one summary line of the medians.
Without a CUDA device it exits 2.
"""
import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

MEMORY = {'streaming': False, 'augment': False}
# name: (overrides, data: 'both', 'w100' or 'synthetic', synchronous copy)
VARIANTS = {
    'memory': (MEMORY, 'both', False),
    'memory_augment': ({'streaming': False, 'augment': True}, 'both', False),
    'stream': ({'loader_workers': 0, 'augment': False}, 'both', False),
    'stream_workers': ({'augment': False}, 'both', False),
    'path': ({}, 'both', False),
    'memory_sync': (MEMORY, 'both', True),
    'w100': (MEMORY, 'w100', False),
    'w100_sync': (MEMORY, 'w100', True),
    'synthetic_w100': (MEMORY, 'synthetic', False),
}


class SyncBatches:
  """TrainBatchPrefetcher's interface, copying each batch in the
  training loop's thread and stream."""

  def __init__(self, batches, device):
    from deepconsensus_tpu_torch.models import train as train_lib

    self._batches, self._device, self._n = batches, device, 0
    self._to_device = train_lib.batch_to_device

  def __iter__(self):
    for host in self._batches:
      self._n += 1
      yield self._to_device(host, self._device)

  def stats(self):
    return {'n_batch_launches': float(self._n)}

  def close(self):
    self._batches.close()


def profile_step(paths, dtype: str) -> dict:
  """One profiled train step on the first 100-wide batch of `paths`."""
  import torch
  from torch.profiler import ProfilerActivity, profile

  from deepconsensus_tpu_torch.models import data as data_lib
  from deepconsensus_tpu_torch.models import model as model_lib
  from deepconsensus_tpu_torch.models import train as train_lib

  params = chip_smoke.make_params(dtype)
  params.update(use_pallas_attention=True, attention_dropout=0.0)
  host = next(data_lib.DatasetIterator(paths, params, chip_smoke.TRAIN_BATCH,
                                       shuffle=False).epoch())
  dev = torch.device('cuda')
  batch = train_lib.batch_to_device(host, dev)
  model = model_lib.DeepConsensusModel(params, device=dev)
  model.init_weights(torch.Generator().manual_seed(chip_smoke.SEED))
  model.requires_grad_(True)
  lamb = train_lib.Lamb(model.named_parameters(), params, 10)
  loss_fn = train_lib.make_loss(params)
  gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
  for _ in range(2):
    train_lib.train_step(model, lamb, loss_fn, batch, gen)
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    train_lib.train_step(model, lamb, loss_fn, batch, gen)
    torch.cuda.synchronize()
  kernels = [e for e in prof.key_averages() if e.self_device_time_total > 0]
  top = sorted(kernels, key=lambda e: e.self_device_time_total,
               reverse=True)[:6]
  rows = host['rows'][:, :params.max_passes, :, 0]
  return {
      'absent_subread_row_share': float((rows.max(axis=2) == 0).mean()),
      'device_ms': sum(e.self_device_time_total for e in kernels) / 1e3,
      'top_kernels_ms': [[e.key[:90], e.self_device_time_total / 1e3,
                          e.count] for e in top]}


def main(argv) -> int:
  import torch

  if not torch.cuda.is_available():
    print('probe_train_data: no CUDA device', file=sys.stderr)
    return 2
  dtype = argv[argv.index('--dtype') + 1] if '--dtype' in argv else (
      'bfloat16')
  repeats = int(argv[argv.index('--repeats') + 1]) if '--repeats' in argv \
      else 2
  print(chip_smoke.card_line(), flush=True)
  from deepconsensus_tpu_torch.ops import _build
  from deepconsensus_tpu_torch.testing import synthetic

  _build.build_all()

  bams, _ = chip_smoke.make_run_inputs()
  truth = synthetic.write_synthetic_truth(
      bams['ragged'][1], os.path.join(chip_smoke.WORK, 'truth'))
  outs = [chip_smoke.run_preprocess_path(bams['ragged'], truth, tag, 2,
                                         width, smart)['out']
          for tag, width, smart in (('ex_fixed100', 100, False),
                                    ('ex_smart200', 200, True))]
  train_paths = [os.path.join(o, 'train', '*') for o in outs]
  eval_paths = [os.path.join(o, s, '*') for o in outs
                for s in ('eval', 'test')]
  synthetic_dir = os.path.join(chip_smoke.WORK, 'probe_synthetic')
  synthetic.write_synthetic_tfrecords(
      synthetic_dir, n_shards=4, n_examples=6 * chip_smoke.TRAIN_BATCH,
      max_passes=20, max_length=chip_smoke.LENGTH, seed=chip_smoke.SEED)
  data = {'both': (train_paths, eval_paths, chip_smoke.BUCKETS),
          'w100': (train_paths[:1], eval_paths[:2], None),
          'synthetic': ([os.path.join(synthetic_dir, '*')],
                        [os.path.join(synthetic_dir, '*')], None)}
  from deepconsensus_tpu_torch.models import train as train_lib

  prefetcher = train_lib.TrainBatchPrefetcher
  names = (argv[argv.index('--variants') + 1].split(',')
           if '--variants' in argv else list(VARIANTS))
  order = names * repeats
  order += order[::-1]
  p50s = {name: {} for name in names}
  for i, name in enumerate(order):
    extra, which, sync = VARIANTS[name]
    overrides = {**chip_smoke.TRAIN_DATA_SET, **extra}
    train_lib.TrainBatchPrefetcher = SyncBatches if sync else prefetcher
    t0 = time.perf_counter()
    r = chip_smoke.run_train_data(*data[which][:2], dtype, f'probe_{i}',
                                  overrides, buckets=data[which][2])
    by_width = {}
    for w, t in zip(r['widths'], r['step_seconds']):
      by_width.setdefault(w, []).append(1e3 * t)
    p50 = {w: statistics.median(v) for w, v in sorted(by_width.items())}
    for w, v in p50.items():
      p50s[name].setdefault(w, []).append(v)
    print(json.dumps({'variant': name, 'run': i, 'dtype': dtype,
                      'step_ms': [1e3 * t for t in r['step_seconds']],
                      'widths': r['widths'], 'step_p50_ms': p50,
                      'seconds': time.perf_counter() - t0}), flush=True)
  if '--profile' in argv:
    for which in ('w100', 'synthetic'):
      print(json.dumps({'profile': which, 'dtype': dtype,
                        **profile_step(data[which][0], dtype)}), flush=True)
  print(json.dumps({'summary': {
      name: {w: statistics.median(v) for w, v in by.items()}
      for name, by in p50s.items()}, 'dtype': dtype}), flush=True)
  print(chip_smoke.card_line(), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main(sys.argv[1:]))
