#!/usr/bin/env python3
"""chip_smoke.py's checkpoint paths alone, on the card.

  python3 scripts/chip_train_ckpt.py    # on a machine with an H100

Builds the native library and the kernels, writes the L100 BAMs and the
train cell's synthetic shards as chip_smoke.py does, then runs
`train_ckpt_gates` (gates a-h: preemption, SIGKILL and truncation, a
NaN rollback, an OOM retry, warm start, `run --checkpoint`, the best
checkpoint) and `train_data_gates`, which ends with gate i
(`embed_onehot`). Every gate raises on failure; the lines printed are
chip_smoke.py's. Torch is imported under the main guard only: the
streaming loader's `spawn` workers import this module again.
"""
import json
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as c  # noqa: E402

if __name__ == '__main__':
  print(c.card_line(), flush=True)
  t = time.perf_counter()
  from deepconsensus_tpu_torch import native
  from deepconsensus_tpu_torch.ops import _build
  from deepconsensus_tpu_torch.testing import synthetic

  if native.get_lib() is None:
    raise AssertionError('the native BGZF library did not build')
  _build.build_all()
  print(json.dumps({'phase': 'build', 'seconds': time.perf_counter() - t}),
        flush=True)
  bams, _ = c.make_run_inputs()
  shards = []
  for split, count, seed in (('train', c.TRAIN_EXAMPLES, c.SEED),
                             ('eval', c.EVAL_EXAMPLES, c.SEED + 1)):
    out = os.path.join(c.WORK, f'shards_{split}')
    shutil.rmtree(out, ignore_errors=True)
    synthetic.write_synthetic_tfrecords(
        out, n_shards=4, n_examples=count, max_passes=20,
        max_length=c.LENGTH, seed=seed)
    shards.append(os.path.join(out, '*.tfrecord.gz'))
  for name, run in (('train_ckpt', lambda: c.train_ckpt_gates(shards)),
                    ('train_data', lambda: c.train_data_gates(
                        bams['ragged']))):
    t = time.perf_counter()
    run()
    print(json.dumps({'phase': f'{name}_done',
                      'seconds': time.perf_counter() - t}), flush=True)
  print(c.card_line(), flush=True)
