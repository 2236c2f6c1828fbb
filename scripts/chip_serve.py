#!/usr/bin/env python3
"""chip_smoke.py's serve path alone, on the card.

  python3 scripts/chip_serve.py    # on a machine with an H100

Builds the native library and the kernels, writes the L100 BAMs and the
seeded weights as chip_smoke.py does, runs the L100 `cli run` in
bfloat16 (the FASTQ the served reads are held to), then `serve_gates`:
the in-process services (L100 with a poisoned request, per bucket,
ragged), `cli serve` as a subprocess with `cli featurize-worker` and
`cli route` in front, and the SIGTERM drill. Every gate raises on
failure; the lines printed are chip_smoke.py's.
"""
import json
import os
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

  if native.get_lib() is None:
    raise AssertionError('the native BGZF library did not build')
  _build.build_all()
  print(json.dumps({'phase': 'build', 'seconds': time.perf_counter() - t}),
        flush=True)
  bams, weights = c.make_run_inputs()
  run = c.run_main_path('L100', bams['L100'], weights, 'bfloat16')
  c.main_path_line('L100', 'bfloat16', run)
  t = time.perf_counter()
  launches = c.serve_gates(bams, weights, run[0])
  print(json.dumps({'phase': 'serve_done', 'launches': launches,
                    'seconds': time.perf_counter() - t}), flush=True)
  print(c.card_line(), flush=True)
