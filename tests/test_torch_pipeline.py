"""The port's three-stage `run_inference` pipeline vs the JAX package's.

Seeded synthetic BAMs and one Flax init bridged to the port (2 layers,
filter 64, non-zero ReZero alphas) go through both packages on the CPU
at sizes where packs span featurize batches (batch_zmws 2, batch_size
4: each featurize batch holds ~6 windows):

* the port's pipelined FASTQ equals the JAX package's byte for byte
  and the port's serial settings' (dispatch_depth 1, no cross-batch
  packing, no pool), at dispatch_depth 1 and 8, cross-batch packing on
  and off, and a featurization pool of 0 and 2 workers; the pack counts
  follow the packing mode;
* the ragged path (`use_ragged_kernel`) holds to test_torch_ragged.py's
  tolerance: ids identical, qualities within 1;
* `.bam` output decodes through the port's reader to the JAX package's
  names, bases, qualities and zm/rq/np tags;
* --end_after_stage writes the runtime rows the JAX package writes;
* the pool leaves no shared-memory segment behind, on success and when
  the model stage fails;
* the engine cuts the same per-bucket packs as the JAX package's,
  `run_model_on_windows` returns the JAX package's outputs, and the
  runner's pinned-ring slots survive more packs in flight than slots;
  the pipeline's output holds when its threads switch every 10 us.
"""
import collections
import csv
import dataclasses
import json
import os
import platform
import sys
import types

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepconsensus_tpu.calibration import lib as jax_calibration
from deepconsensus_tpu.inference import engine as jax_engine
from deepconsensus_tpu.inference import runner as jax_runner
from deepconsensus_tpu.models import config as jax_config
from deepconsensus_tpu.models import model as jax_model
from deepconsensus_tpu_torch import cli
from deepconsensus_tpu_torch.inference import engine as torch_engine
from deepconsensus_tpu_torch.inference import runner as torch_runner
from deepconsensus_tpu_torch.io import bam as torch_bam
from deepconsensus_tpu_torch.models import config as torch_config
from deepconsensus_tpu_torch.models import weights as weights_lib
from deepconsensus_tpu_torch.preprocess import feeder as torch_feeder
from deepconsensus_tpu_torch.preprocess.pileup import FeatureLayout
from deepconsensus_tpu_torch.testing import synthetic

SMALL = dict(dtype='float32', num_hidden_layers=2, filter_size=64)
KW = dict(batch_size=4, batch_zmws=2, min_quality=0, skip_windows_above=0)
BUCKETS = (100, 200)
RAGGED_KW = dict(batch_size=4, batch_zmws=2, min_quality=0,
                 skip_windows_above=0, window_buckets=BUCKETS,
                 use_ragged_kernel=True, use_ccs_smart_windows=True)
SERIAL = dict(dispatch_depth=1, pack_across_batches=False, cpus=0)


@pytest.fixture(scope='module')
def bams(tmp_path_factory):
  return synthetic.write_synthetic_zmw_bams(
      str(tmp_path_factory.mktemp('bams')), n_zmws=6, n_subreads=4,
      seq_len=260, seed=11)


@pytest.fixture(scope='module')
def wl_bams(tmp_path_factory):
  return synthetic.write_synthetic_zmw_bams(
      str(tmp_path_factory.mktemp('wl_bams')), n_zmws=6, n_subreads=4,
      seq_len=420, seed=11, smart_windows=True)


def _model_pair(**overrides):
  """(JAX params, JAX variables, port params, port state): one Flax
  init with non-zero ReZero alphas, bridged to the port."""
  params = jax_config.get_config('transformer_learn_values+test')
  jax_config.finalize_params(params, is_training=False)
  with params.unlocked():
    params.update(SMALL, use_fused_hotpath=True, **overrides)
  width = max(overrides.get('window_buckets', [100]))
  variables = jax_model.get_model(params).init(
      jax.random.PRNGKey(0), jnp.zeros((1, params.total_rows, width, 1)))
  flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(variables))
  rng = np.random.default_rng(1)
  for key in flat:
    if key[-1] == 'alpha':
      flat[key] = jnp.asarray(rng.uniform(0.5, 1.0), jnp.float32)
  variables = flax.traverse_util.unflatten_dict(flat)
  tparams = torch_config.get_config('transformer_learn_values+test')
  torch_config.finalize_params(tparams)
  tparams.update(SMALL, **overrides)
  state = weights_lib.from_flax_params(
      jax.device_get(variables['params']), tparams)
  return params, variables, tparams, state


@pytest.fixture(scope='module')
def model_pair():
  return _model_pair()


@pytest.fixture(scope='module')
def ragged_pair():
  return _model_pair(window_buckets=list(BUCKETS))


def _jax_run(bams, pair, out, **kw):
  params, variables, _, _ = pair
  opts = jax_runner.InferenceOptions(
      **kw, dc_calibration_values=jax_calibration.parse_calibration_string(
          'skip'))
  return jax_runner.run_inference(
      bams[0], bams[1], None, out, options=opts,
      runner=jax_runner.ModelRunner(params, variables, opts))


def _port_run(bams, pair, out, **kw):
  _, _, tparams, state = pair
  runner = torch_runner.ModelRunner(
      torch_config.Params(tparams), state,
      torch_runner.InferenceOptions(**kw), device='cpu')
  return torch_runner.run_inference(bams[0], bams[1], out, runner)


@pytest.fixture(scope='module')
def jax_fastq(bams, model_pair, tmp_path_factory):
  out = str(tmp_path_factory.mktemp('jax') / 'jax.fastq')
  _jax_run(bams, model_pair, out, **KW)
  with open(out, 'rb') as f:
    return f.read()


@pytest.fixture(scope='module')
def serial_fastq(bams, model_pair, tmp_path_factory):
  out = str(tmp_path_factory.mktemp('serial') / 'serial.fastq')
  counters = _port_run(bams, model_pair, out, **KW, **SERIAL)
  with open(out, 'rb') as f:
    return f.read(), counters


def read_fastq(data: bytes):
  lines = data.split(b'\n')
  return [(lines[i], lines[i + 1], lines[i + 3])
          for i in range(0, len(lines) - 1, 4)]


@pytest.mark.parametrize('cpus', [0, 2])
@pytest.mark.parametrize('cross', [True, False])
@pytest.mark.parametrize('depth', [1, 8])
def test_pipelined_run_matches_jax(bams, model_pair, jax_fastq, serial_fastq,
                                   tmp_path, depth, cross, cpus):
  out = str(tmp_path / 'port.fastq')
  counters = _port_run(bams, model_pair, out, **KW, dispatch_depth=depth,
                       pack_across_batches=cross, cpus=cpus)
  with open(out, 'rb') as f:
    got = f.read()
  assert counters['success'] == len(read_fastq(got)) == 6
  assert got == jax_fastq
  assert got == serial_fastq[0]
  assert counters['bam_decoder'] == 'native'
  assert counters['n_featurize_batches'] == 3
  windows = counters['n_windows_to_model']
  per_batch = [int(r['n_examples']) for r in _runtime_rows(out)
               if r['stage'] == 'preprocess']
  assert sum(per_batch) == windows and len(per_batch) == 3
  # Cross-batch packing pads only the end-of-input tail; without it
  # every featurize batch pads its own.
  want = (-(-windows // 4) if cross
          else sum(-(-n // 4) for n in per_batch))
  assert counters['n_model_packs'] == want
  assert counters['n_model_pad_rows'] == 4 * want - windows
  assert counters['n_model_pack_rows'] == windows
  if cross:
    assert counters['n_model_packs'] < serial_fastq[1]['n_model_packs']


def _runtime_rows(out):
  with open(out + '.runtime.csv', newline='') as f:
    return list(csv.DictReader(f))


@pytest.fixture(scope='module')
def jax_ragged_fastq(wl_bams, ragged_pair, tmp_path_factory):
  out = str(tmp_path_factory.mktemp('jax_ragged') / 'jax.fastq')
  _jax_run(wl_bams, ragged_pair, out, **RAGGED_KW)
  with open(out, 'rb') as f:
    return read_fastq(f.read())


@pytest.mark.parametrize('cross', [True, False])
@pytest.mark.parametrize('depth', [1, 8])
def test_ragged_pipeline_matches_jax(wl_bams, ragged_pair, jax_ragged_fastq,
                                     tmp_path, depth, cross):
  out = str(tmp_path / 'port.fastq')
  counters = _port_run(wl_bams, ragged_pair, out, **RAGGED_KW,
                       dispatch_depth=depth, pack_across_batches=cross)
  with open(out, 'rb') as f:
    got = read_fastq(f.read())
  assert counters['success'] == len(got) == len(jax_ragged_fastq) == 6
  assert counters['use_ragged_kernel'] == 1
  assert min(counters['n_windows_by_bucket'].values()) > 0
  for (jn, js, jq), (tn, ts, tq) in zip(jax_ragged_fastq, got):
    assert (jn, js) == (tn, ts)
    dq = np.abs(np.frombuffer(jq, np.uint8).astype(int)
                - np.frombuffer(tq, np.uint8).astype(int))
    assert dq.max() <= 1


def test_bam_output_matches_jax(bams, model_pair, tmp_path):
  jax_out, port_out = str(tmp_path / 'jax.bam'), str(tmp_path / 'port.bam')
  _jax_run(bams, model_pair, jax_out, **KW)
  counters = _port_run(bams, model_pair, port_out, **KW)
  assert counters['output_format'] == 'bam' and counters['success'] == 6
  with torch_bam.BamReader(jax_out) as a, torch_bam.BamReader(port_out) as b:
    assert a.header_text == b.header_text
    want, got = list(a), list(b)
  assert len(got) == len(want) == 6
  for w, g in zip(want, got):
    assert g.qname == w.qname
    np.testing.assert_array_equal(g.seq, w.seq)
    np.testing.assert_array_equal(g.quals, w.quals)
    assert g.tags == w.tags
    assert {'zm', 'rq', 'np'} <= set(g.tags)


@pytest.mark.parametrize('stage', torch_runner.STAGES)
def test_end_after_stage_writes_the_stages_jax_writes(bams, model_pair,
                                                      tmp_path, stage):
  jax_out, port_out = str(tmp_path / 'jax.fastq'), str(tmp_path / 'p.fastq')
  _jax_run(bams, model_pair, jax_out, **KW, end_after_stage=stage)
  counters = _port_run(bams, model_pair, port_out, **KW,
                       end_after_stage=stage)

  def stages(out):
    return collections.Counter(r['stage'] for r in _runtime_rows(out))

  assert stages(port_out) == stages(jax_out)
  assert counters['end_after_stage'] == stage
  assert os.path.exists(port_out)
  assert counters['success'] == (6 if stage == 'full' else 0)
  assert (counters['n_model_packs'] > 0) == (stage in ('run_model', 'full'))
  assert counters['featurize_seconds'] > 0 or stage == 'dc_input'
  for key in ('bam_decode_seconds', 'featurize_seconds',
              'triage_format_seconds', 'model_seconds', 'stitch_seconds'):
    assert counters[key] >= 0
  timed = sum(counters[k] for k in (
      'bam_decode_seconds', 'featurize_seconds', 'triage_format_seconds',
      'model_seconds', 'stitch_seconds'))
  assert counters['untimed_seconds'] == pytest.approx(
      counters['total_seconds'] - timed, abs=1e-5)


def _segments(prefix):
  return sorted(n for n in os.listdir('/dev/shm') if n.startswith(prefix))


@pytest.mark.skipif(not os.path.isdir('/dev/shm'), reason='no /dev/shm')
def test_pool_leaves_no_shm_segment(bams, model_pair, tmp_path, monkeypatch):
  prefix = f'dctorch_{os.getpid()}_'
  before = _segments(prefix)
  made = []
  create = torch_runner.featurize_lib.features_from_shm

  def counting(result):
    made.append(result[0])
    return create(result)

  monkeypatch.setattr(torch_runner.featurize_lib, 'features_from_shm',
                      counting)
  counters = _port_run(bams, model_pair, str(tmp_path / 'ok.fastq'), **KW,
                       cpus=2)
  assert counters['success'] == 6 and len([m for m in made if m]) == 6
  assert _segments(prefix) == before

  def failing(self, raw_windows, tickets):
    raise RuntimeError('model stage failed')

  monkeypatch.setattr(torch_engine.ConsensusEngine, 'submit', failing)
  with pytest.raises(RuntimeError, match='model stage failed'):
    _port_run(bams, model_pair, str(tmp_path / 'bad.fastq'), **KW, cpus=2)
  assert _segments(prefix) == before


def test_pipeline_under_rapid_thread_switching(bams, model_pair,
                                               serial_fastq, tmp_path):
  """The three threads hand batches over at every bytecode or so: one
  ZMW a featurize batch, one batch of emit queue, and a switch interval
  of 10 us; the reads and the counts the threads merge stay the serial
  run's."""
  interval = sys.getswitchinterval()
  sys.setswitchinterval(1e-5)
  try:
    out = str(tmp_path / 'switch.fastq')
    counters = _port_run(bams, model_pair, out, **dict(KW, batch_zmws=1),
                         emit_queue_depth=1, dispatch_depth=2)
  finally:
    sys.setswitchinterval(interval)
  with open(out, 'rb') as f:
    assert f.read() == serial_fastq[0]
  want = serial_fastq[1]
  assert counters['n_featurize_batches'] == 6
  for key in ('success', 'n_windows_to_model', 'n_zmw_pass'):
    assert counters[key] == want[key]
  rows = _runtime_rows(out)
  assert sum(r['stage'] == 'stitch_and_write_fastq' for r in rows) == 6
  assert sum(int(r['n_examples']) for r in rows
             if r['stage'] == 'run_model') == want['n_windows_to_model']


def test_cli_run_pipeline_flags_on_cpu(bams, model_pair, serial_fastq,
                                       tmp_path):
  _, _, tparams, state = model_pair
  weights = str(tmp_path / 'w.npz')
  weights_lib.save_npz(weights, weights_lib.to_flax_params(state))
  params_json = str(tmp_path / 'params.json')
  with open(params_json, 'w') as f:
    json.dump(tparams.to_dict(), f)
  out = str(tmp_path / 'cli.fastq')
  argv = ['run', '--subreads_to_ccs', bams[0], '--ccs_bam', bams[1],
          '--weights', weights, '--params', params_json, '--output', out,
          '--batch_size', '4', '--batch_zmws', '2', '--min_quality', '0',
          '--skip_windows_above', '0', '--device', 'cpu']
  assert cli.main(argv + ['--cpus', '2', '--dispatch_depth', '2',
                          '--emit_queue_depth', '1']) == 0
  with open(out, 'rb') as f:
    assert f.read() == serial_fastq[0]
  with open(out + '.inference.json') as f:
    counters = json.load(f)
  assert (counters['cpus'], counters['dispatch_depth'],
          counters['emit_queue_depth'], counters['pack_across_batches']) == (
              2, 2, 1, 1)
  assert cli.main(argv + ['--no_cross_batch_packing', '--end_after_stage',
                          'run_model']) == 0
  with open(out + '.inference.json') as f:
    counters = json.load(f)
  assert counters['pack_across_batches'] == 0
  assert counters['n_model_packs'] == serial_fastq[1]['n_model_packs']


class _StubRunner:
  """Records each pack; echoes its draft-CCS row as the ids."""

  def __init__(self, params, buckets):
    self.packs = []
    self.ccs_row = 4 * params.max_passes
    self.window_buckets = buckets
    self.params = params

  def dispatch(self, pack):
    self.packs.append(np.array(pack))
    return pack

  def finalize(self, pack):
    ids = pack[:, self.ccs_row, :, 0].astype(np.int32)
    return ids, np.full(ids.shape, 40, np.int32)


def test_engine_packs_across_batches_like_jax():
  """Per-bucket packers over a seeded mixed-width stream of
  submissions (with starvation flushes): the same packs, in the same
  order, and the same delivery as the JAX package's engine."""
  rng = np.random.default_rng(3)
  params = {'port': torch_config.get_config('transformer_learn_values+test'),
            'jax': jax_config.get_config('transformer_learn_values+test')}
  torch_config.finalize_params(params['port'])
  jax_config.finalize_params(params['jax'], is_training=False)
  submissions = []
  ticket = 0
  for _ in range(40):
    windows = [synthetic_rows(params['port'], rng,
                              int(rng.choice(BUCKETS, p=[0.9, 0.1])))
               for _ in range(int(rng.integers(1, 7)))]
    submissions.append((windows, list(range(ticket, ticket + len(windows)))))
    ticket += len(windows)
  options = types.SimpleNamespace(
      batch_size=4, dispatch_depth=2, window_buckets=BUCKETS,
      bucket_flush_packs=torch_engine.BUCKET_FLUSH_PACKS,
      use_ragged_kernel=False, max_length=100)
  runs = {}
  for name, lib in (('jax', jax_engine), ('port', torch_engine)):
    runner = _StubRunner(params[name], BUCKETS)
    delivered = {}
    engine = lib.ConsensusEngine(
        runner, options,
        deliver=lambda t, ids, quals, d=delivered: d.__setitem__(t, ids))
    for windows, tickets in submissions:
      engine.submit(windows, tickets)
    engine.flush()
    runs[name] = (runner.packs, delivered, engine.n_packs,
                  engine.n_pad_rows, engine.n_starvation_flushes,
                  engine.n_packs_by_bucket)
  jpacks, jdel, *jcounts = runs['jax']
  tpacks, tdel, *tcounts = runs['port']
  assert tcounts == jcounts and tcounts[2] > 0
  assert len(tpacks) == len(jpacks) > 5
  for jp, tp in zip(jpacks, tpacks):
    np.testing.assert_array_equal(tp, jp)
  assert tdel.keys() == jdel.keys() == set(range(ticket))
  for t in jdel:
    np.testing.assert_array_equal(tdel[t], jdel[t])


@pytest.mark.parametrize('depth', [1, 3])
def test_run_model_on_windows_matches_jax(bams, model_pair, depth):
  """The pipelined window helper over every model window of the BAMs,
  in packs of 4 with `depth` packs in flight: the same outputs (names,
  positions, tags, bases, quality strings) as the JAX package's."""
  params, variables, tparams, state = model_pair
  feed, _ = torch_feeder.create_proc_feeder(
      bams[0], bams[1], layout=FeatureLayout(20, 100), ins_trim=5)
  windows = [w for z in feed() for w in torch_runner.preprocess_zmw(z)[0]
             if not w['overflow']]
  jopts = jax_runner.InferenceOptions(batch_size=4, dispatch_depth=depth)
  want = jax_runner.run_model_on_windows(
      windows, jax_runner.ModelRunner(params, variables, jopts), params,
      jopts)
  topts = torch_runner.InferenceOptions(batch_size=4, dispatch_depth=depth)
  got = torch_runner.run_model_on_windows(
      windows, torch_runner.ModelRunner(torch_config.Params(tparams), state,
                                        topts, device='cpu'),
      tparams, topts)
  assert len(got) == len(want) == len(windows) > 8
  assert [dataclasses.asdict(o) for o in got] == [
      dataclasses.asdict(o) for o in want]


def test_runner_slots_survive_more_packs_in_flight(model_pair):
  """Seven packs dispatched before any finalize, through rings of two
  input and three output slots: each finalize still returns its own
  pack's rows (an output slot reused early is drained first)."""
  _, _, tparams, state = model_pair
  runner = torch_runner.ModelRunner(
      torch_config.Params(tparams), state,
      torch_runner.InferenceOptions(batch_size=4, dispatch_depth=2),
      device='cpu')
  rng = np.random.default_rng(5)
  packs = [np.stack([synthetic_rows(tparams, rng) for _ in range(n)])
           for n in (4, 3, 4, 1, 4, 2, 4)]
  want = [runner.predict(p) for p in packs]
  handles = [runner.dispatch(p) for p in packs]
  for (wid, wq), handle, pack in zip(want, handles, packs):
    ids, quals = runner.finalize(handle)
    assert ids.shape == (len(pack), 100)
    np.testing.assert_array_equal(ids, wid)
    np.testing.assert_array_equal(quals, wq)
  assert runner.dispatch_stats()['n_transfer_direct'] == 14


def synthetic_rows(params, rng, width=100):
  """One window [R, width, 1] of pileup rows in the model's value
  ranges, SN constant across the window (as the featurizer emits
  them)."""
  mp = params.max_passes
  rows = np.zeros((params.total_rows, width), np.float32)
  rows[:mp] = rng.integers(0, 5, (mp, width))
  rows[mp:3 * mp] = rng.integers(0, 256, (2 * mp, width))
  rows[3 * mp:4 * mp] = rng.integers(0, 3, (mp, width))
  rows[4 * mp] = rng.integers(0, 5, width)
  rows[4 * mp + 1:] = rng.integers(0, 501, (4, 1))
  return rows[..., None]


class _OffsetRunner:
  """A ragged runner stub that records each pack's lengths rows; every
  output position's id is its offset in the slot, so a delivered
  window's first id says where it was placed."""

  def __init__(self, slot_len):
    self.slot_len = slot_len
    self.lengths = []

  def dispatch_ragged(self, pack, lengths):
    self.lengths.append(np.array(lengths))
    return len(pack)

  def finalize(self, n_slots):
    ids = np.tile(np.arange(self.slot_len, dtype=np.int32), (n_slots, 1))
    return ids, np.zeros_like(ids)


def _ragged_offsets(lib, buckets, groups, flush_each):
  """Each window's slot offset, by ticket, and the packs' lengths rows,
  when `groups` of window widths go through one ragged packer, flushed
  (without draining) after every group or only at the end."""
  runner = _OffsetRunner(buckets[-1])
  options = types.SimpleNamespace(batch_size=8, dispatch_depth=2)
  offsets = {}

  def deliver(ticket, ids, quals):
    offsets[ticket] = int(ids[0])

  if lib is torch_engine:
    packer = lib._RaggedPacker(runner, options, buckets, deliver)
  else:
    packer = lib._RaggedPacker(runner, options, buckets, timing_rows=[],
                               on_pack_failure=lib._raise_pack_failure,
                               deliver=deliver)
  ticket = 0
  for widths in groups:
    for width in widths:
      packer.add(np.zeros((1, 2, width, 1), np.float32), [ticket])
      ticket += 1
    if flush_each:
      packer.flush(drain=False)
  packer.flush()
  assert sorted(offsets) == list(range(ticket))
  return offsets, runner.lengths


def _width_groups(buckets, seed):
  rng = np.random.default_rng(seed)
  return [list(rng.choice(buckets, size=int(rng.integers(1, 8))))
          for _ in range(30)]


@pytest.mark.parametrize('buckets', [(100, 200), (50, 200), (25, 100)])
def test_ragged_flush_points_keep_never_flushed_offsets(buckets):
  """On a chain of two buckets, a ragged stream flushed after every
  featurize batch (pack_across_batches=False) places every window at
  the slot offset it has in a stream flushed only at the end of input,
  so the card gives it the same bits."""
  groups = _width_groups(buckets, seed=sum(buckets))
  never, _ = _ragged_offsets(torch_engine, buckets, groups, False)
  flushed, lengths = _ragged_offsets(torch_engine, buckets, groups, True)
  assert flushed == never
  # Dummy windows were needed: the JAX package's compat plan, which has
  # none, places some window elsewhere.
  jax_flushed, _ = _ragged_offsets(jax_engine, buckets, groups, True)
  assert jax_flushed != never
  assert sum(int(np.count_nonzero(x)) for x in lengths) > len(never)


def test_ragged_plan_is_the_jax_compat_plan_beyond_two_buckets():
  """With three buckets no count reproduces a never-flushed stream's
  offsets, so the packer places no dummy windows: flushed after every
  featurize batch, its packs are the JAX package's, slot for slot."""
  buckets = (50, 100, 200)
  groups = _width_groups(buckets, seed=7)
  port, port_lengths = _ragged_offsets(torch_engine, buckets, groups, True)
  jax_offsets, jax_lengths = _ragged_offsets(jax_engine, buckets, groups,
                                             True)
  assert port == jax_offsets
  assert len(port_lengths) == len(jax_lengths) > 5
  for a, b in zip(port_lengths, jax_lengths):
    np.testing.assert_array_equal(a, b)


def test_device_busy_time_counts_overlap_once():
  """The model stage's busy time is the union of the packs' event
  intervals: an H2D copy that overlaps a forward counts once."""
  union = torch_runner._union_seconds
  assert union([]) == 0.0
  assert union([(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]) == 3.0
  assert union([(0.0, 5.0), (1.0, 2.0)]) == 5.0
  assert union([(2.0, 3.0), (0.0, 1.0)]) == 2.0


def test_run_keeps_freed_heap_under_glibc():
  """run_inference's allocator settings apply wherever the C library is
  glibc, and are skipped quietly elsewhere."""
  glibc = (sys.platform.startswith('linux')
           and platform.libc_ver()[0] == 'glibc')
  assert torch_runner._keep_freed_heap() is glibc
