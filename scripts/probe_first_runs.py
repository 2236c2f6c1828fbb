#!/usr/bin/env python3
"""Times the first L100 `cli run`s of a process on one GPU, and what
the host does around them, to find why a process's first runs are
slower than its later ones.

  python3 scripts/probe_first_runs.py [--tree DIR] [--checks] [--runs N]
                                      [--decode] [--mallopt SPEC]
                                      [--no-touch]

Imports chip_smoke and deepconsensus_tpu_torch from DIR (default: this
checkout; DIR may hold an older commit of the repo), builds the kernels
and chip_smoke's synthetic L100 BAMs (128 ZMWs) and seeded full-width
weights, runs chip_smoke's kernel checks first with --checks (as
chip_smoke does before its first run), then N L100 bfloat16 `cli run`s
at chip_smoke's batch sizes, after applying --mallopt's glibc
allocator settings (SPEC: name=bytes,... with names trim, top_pad,
mmap, arena_max). With --decode, before each run after the
first, it times on their own: the BAM records through the native and
through the gzip BamReader, the whole feeder (records expanded into
reads) on the main thread and on a second thread, and a fixed loop of
pure Python.

Each run prints one JSON line: its seconds since the process started,
its wall and `.inference.json` stage seconds, and, over the run, the
CPU seconds of the busiest threads of this process (/proc), of the
busiest other processes, and of this process with its ended threads,
user and system, with its page faults (getrusage). Each run also gives the
seconds of the model stage's host calls (`model_host_seconds`: ring
slot handout, dispatch, launch, finalize). The `ready` line gives the
seconds a GiB of fresh memory takes to fault in, at the start and after
the set-up (--no-touch leaves that out). Prints the card's name and power limit first; with no
CUDA device it exits 2.
"""
import argparse
import json
import os
import resource
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = time.perf_counter()
TICK = os.sysconf('SC_CLK_TCK')


def _stat_fields(path: str):
  """(comm, utime + stime seconds) of one /proc stat file."""
  with open(path) as f:
    text = f.read()
  comm = text[text.index('(') + 1:text.rindex(')')]
  rest = text[text.rindex(')') + 2:].split()
  return comm, (int(rest[11]) + int(rest[12])) / TICK


def cpu_snapshot() -> dict:
  """CPU seconds so far: per thread of this process, per other
  process, and of this process with its ended threads (with its page
  faults)."""
  me = os.getpid()
  threads, procs = {}, {}
  for tid in os.listdir(f'/proc/{me}/task'):
    try:
      threads[tid] = _stat_fields(f'/proc/{me}/task/{tid}/stat')
    except OSError:
      continue
  for pid in os.listdir('/proc'):
    if not pid.isdigit() or int(pid) == me:
      continue
    try:
      procs[pid] = _stat_fields(f'/proc/{pid}/stat')
    except (OSError, ValueError):
      continue
  # This process with its ended threads: CPU seconds and page faults.
  ru = resource.getrusage(resource.RUSAGE_SELF)
  process = {'user': ru.ru_utime, 'system': ru.ru_stime,
             'minor_faults': ru.ru_minflt, 'major_faults': ru.ru_majflt}
  return {'threads': threads, 'procs': procs, 'process': process}


def cpu_delta(a: dict, b: dict, top: int = 5) -> dict:
  def busiest(x, y):
    # Keyed by id: a kernel thread's name changes with its work.
    d = {f'{y[k][0]}:{k}': y[k][1] - x.get(k, ('', 0.0))[1] for k in y}
    return {k: round(v, 3) for k, v in
            sorted(d.items(), key=lambda kv: -kv[1])[:top] if v > 0}
  return {'threads': busiest(a['threads'], b['threads']),
          'procs': busiest(a['procs'], b['procs']),
          'process': {k: round(b['process'][k] - a['process'][k], 3)
                      for k in b['process']}}


def touch_seconds_per_gib(mib: int = 512) -> float:
  """Seconds per GiB to fault in fresh anonymous memory (numpy fills
  `mib` MiB that the process never held)."""
  import numpy as np

  t0 = time.perf_counter()
  np.ones(mib << 18, np.float32)
  return (time.perf_counter() - t0) * 1024 / mib


MALLOPT = {'trim': -1, 'top_pad': -2, 'mmap': -3, 'arena_max': -8}


def mallopt(spec: str) -> dict:
  """Applies glibc mallopt settings given as name=bytes,... (names
  from MALLOPT); returns them."""
  import ctypes

  set_param = ctypes.CDLL('libc.so.6').mallopt
  set_param.argtypes = (ctypes.c_int, ctypes.c_int)
  set_param.restype = ctypes.c_int
  out = {}
  for item in filter(None, spec.split(',')):
    name, value = item.split('=')
    if not set_param(MALLOPT[name], int(value)):
      raise RuntimeError(f'mallopt {item} failed')
    out[name] = int(value)
  return out


def timed(fn) -> float:
  t0 = time.perf_counter()
  fn()
  return time.perf_counter() - t0


def decode_probes(bams) -> dict:
  """Seconds of the BAM decode alone, by decoder and by thread."""
  import inspect

  from deepconsensus_tpu_torch.io import bam
  from deepconsensus_tpu_torch.preprocess import feeder as feeder_lib
  from deepconsensus_tpu_torch.preprocess.pileup import FeatureLayout

  def records(**kw):
    for path in bams:
      for _ in bam.BamReader(path, **kw):
        pass

  def feed():
    layout = FeatureLayout(max_passes=20, max_length=100, use_ccs_bq=False)
    fn, _ = feeder_lib.create_proc_feeder(bams[0], bams[1], layout)
    for _ in fn():
      pass

  def in_thread(fn):
    def run():
      th = threading.Thread(target=fn)
      th.start()
      th.join()
    return run

  out = {}
  if 'use_native' in inspect.signature(bam.BamReader).parameters:
    out['native_records'] = timed(lambda: records(use_native=True))
    out['python_records'] = timed(lambda: records(use_native=False))
  else:
    out['python_records'] = timed(records)
  out['feeder_main'] = timed(feed)
  out['feeder_thread'] = timed(in_thread(feed))
  out['py_loop'] = timed(lambda: sum(i * i for i in range(2_000_000)))
  return out


def instrument(clock: dict) -> None:
  """Adds the seconds spent in the model stage's host-ring slot
  handout (which allocates the pinned buffers) and in the runner's
  dispatch, launch and finalize to `clock`, where the tree has them."""
  from deepconsensus_tpu_torch.inference import runner

  def wrap(cls, name):
    inner = getattr(cls, name)

    def timed_call(*args, **kwargs):
      t0 = time.perf_counter()
      try:
        return inner(*args, **kwargs)
      finally:
        key = f'{cls.__name__}.{name}'
        clock[key] = clock.get(key, 0.0) + time.perf_counter() - t0
    setattr(cls, name, timed_call)

  targets = [(runner.ModelRunner, ('dispatch', 'dispatch_ragged', '_launch',
                                   'finalize'))]
  if hasattr(runner, '_HostRing'):
    targets.append((runner._HostRing, ('take',)))
  for cls, names in targets:
    for name in names:
      if hasattr(cls, name):
        wrap(cls, name)


def run_checks(cs) -> float:
  """chip_smoke's kernel checks, in chip_smoke's order; seconds."""
  t0 = time.perf_counter()
  for dtype in ('float32', 'bfloat16'):
    cs.check_kernels(dtype)
    cs.check_ragged_kernels(dtype)
    cs.check_banded_attention_kernels(dtype)
    cs.check_flash_kernels(dtype)
  cs.check_wavefront_kernels()
  cs.check_band_kernels()
  return time.perf_counter() - t0


def make_inputs(cs):
  """chip_smoke's L100 BAMs and seeded full-width weights, under the
  tree's build/chip_smoke."""
  import torch

  from deepconsensus_tpu_torch.models import model as model_lib
  from deepconsensus_tpu_torch.models import weights as weights_lib
  from deepconsensus_tpu_torch.testing import synthetic

  os.makedirs(cs.WORK, exist_ok=True)
  bams = synthetic.write_synthetic_zmw_bams(
      os.path.join(cs.WORK, 'bams_probe'), n_zmws=cs.N_ZMWS,
      n_subreads=cs.N_SUBREADS, seq_len=cs.SEQ_LEN, seed=cs.SEED)
  model = model_lib.DeepConsensusModel(cs.make_params('float32'),
                                       device='cpu')
  model.init_weights(torch.Generator().manual_seed(cs.SEED))
  weights = os.path.join(cs.WORK, 'weights_probe.npz')
  weights_lib.save_npz(weights, weights_lib.to_flax_params(
      model.state_dict()))
  params = os.path.join(cs.WORK, 'params_probe.json')
  with open(params, 'w') as f:
    json.dump(cs.make_params('bfloat16').to_dict(), f)
  return bams, weights, params


def main(argv) -> int:
  ap = argparse.ArgumentParser()
  ap.add_argument('--tree', default=REPO)
  ap.add_argument('--checks', action='store_true')
  ap.add_argument('--runs', type=int, default=4)
  ap.add_argument('--decode', action='store_true')
  ap.add_argument('--mallopt', default='')
  ap.add_argument('--touch', action=argparse.BooleanOptionalAction,
                  default=True)
  args = ap.parse_args(argv)
  import torch

  if not torch.cuda.is_available():
    print('probe_first_runs: no CUDA device', file=sys.stderr)
    return 2
  tree = os.path.abspath(args.tree)
  sys.path.insert(0, tree)
  import chip_smoke as cs
  from deepconsensus_tpu_torch import cli
  from deepconsensus_tpu_torch.ops import _build

  print(cs.card_line(), flush=True)
  head_touch = touch_seconds_per_gib() if args.touch else None
  _build.build_all()
  head = {'tree': os.path.relpath(tree, REPO), 'checks': args.checks}
  ready = {}
  if args.checks:
    before = cpu_snapshot()
    head['checks_seconds'] = run_checks(cs)
    ready['checks_cpu'] = cpu_delta(before, cpu_snapshot())
  before = cpu_snapshot()
  bams, weights, params = make_inputs(cs)
  ready['inputs_cpu'] = cpu_delta(before, cpu_snapshot())
  head['mallopt'] = mallopt(args.mallopt)
  clock = {}
  instrument(clock)
  print(json.dumps({'phase': 'ready', **head, **ready,
                    'touch_s_per_gib': [
                        head_touch,
                        touch_seconds_per_gib() if args.touch else None],
                    'malloc_env': {k: v for k, v in os.environ.items()
                                   if k.startswith(('MALLOC_', 'GLIBC_'))},
                    't': time.perf_counter() - T0}), flush=True)
  for i in range(args.runs):
    line = {'phase': 'run', **head, 'run': i}
    if args.decode and i:
      line['decode_probes'] = decode_probes(bams)
    out = os.path.join(cs.WORK, f'out_probe_{i}.fastq')
    argv_run = ['run', '--subreads_to_ccs', bams[0], '--ccs_bam', bams[1],
                '--weights', weights, '--params', params, '--output', out,
                '--batch_size', str(cs.BATCH), '--batch_zmws',
                str(cs.N_ZMWS), '--min_quality', '0',
                '--skip_windows_above', '0']
    before = cpu_snapshot()
    clock.clear()
    line['t'] = time.perf_counter() - T0
    seconds = timed(lambda: cli.main(argv_run))
    line['cpu'] = cpu_delta(before, cpu_snapshot())
    line['model_host_seconds'] = dict(clock)
    with open(out + '.inference.json') as f:
      counters = json.load(f)
    line['seconds'] = seconds
    line.update({k: v for k, v in counters.items()
                 if k.endswith('_seconds') or k == 'bam_decoder'})
    print(json.dumps(line), flush=True)
  return 0


if __name__ == '__main__':
  sys.exit(main(sys.argv[1:]))
