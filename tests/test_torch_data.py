"""The port's training loaders (models/data.py) vs the JAX package's, on
the CPU.

Seeded synthetic shards (max_passes 5) of window widths 14, 20, 33 and
40 under window buckets (20, 40): narrow windows pad into their bucket.
Exact throughout:

* the bucketed DatasetIterator: batches, buckets present, steps and
  counters, two epochs, shuffled and not; an overflow width raises;
* the serial StreamingDataset: batches and counters, one bucket and two
  (with starvation promotion), on_shard_error 'fail' (the same error)
  and 'skip' around a truncated shard. The JAX package draws the shard
  order (producer thread) and the batches (consumer) from one
  generator, so its batches depend on thread timing; the port gives the
  order a generator of its own, and the JAX dataset here runs its own
  `_raw_stream` with that generator;
* augment_batch under one numpy seed.

With loader_workers = 2 the port takes the workers' chunks in turn, so
its stream does not depend on which worker starts first (the JAX
package drains one shared queue, and its worker tests race on that):
the first four chunks equal each worker's seeded shard order, two runs
give the same batches, a truncated shard is counted by the time its
owner's first chunk is taken, a killed worker is named with its shards,
and no worker outlives its iterator. prefetch_iterator re-raises its
producer's error and closes its source.
"""
import multiprocessing
import os
import threading
import time

import numpy as np
import pytest

from deepconsensus_tpu.models import config as jax_config
from deepconsensus_tpu.models import data as jax_data
from deepconsensus_tpu_torch import faults as torch_faults
from deepconsensus_tpu_torch.faults import WindowBucketError
from deepconsensus_tpu_torch.models import config as torch_config
from deepconsensus_tpu_torch.models import data as torch_data
from deepconsensus_tpu_torch.testing import synthetic

MAX_PASSES, LENGTH = 5, 20


def jax_params(**overrides):
  params = jax_config.get_config('transformer_learn_values+test')
  with params.unlocked():
    params.max_passes = MAX_PASSES
  jax_config.finalize_params(params, max_length=LENGTH, is_training=False)
  with params.unlocked():
    for k, v in overrides.items():
      params[k] = v
  return params


def torch_params(**overrides):
  params = torch_config.get_config('transformer_learn_values+custom')
  params.max_passes = MAX_PASSES
  torch_config.finalize_params(params, max_length=LENGTH)
  params.update(overrides)
  return params


def both_params(**overrides):
  return jax_params(**overrides), torch_params(**overrides)


def write_shards(root, widths_counts, n_shards=2, seed=0):
  """One directory of shards per (width, count); returns the patterns."""
  patterns = []
  for i, (width, count) in enumerate(widths_counts):
    out = os.path.join(str(root), f'w{width}_{i}')
    synthetic.write_synthetic_tfrecords(
        out, n_shards=n_shards, n_examples=count, max_passes=MAX_PASSES,
        max_length=width, seed=seed + i)
    patterns.append(os.path.join(out, '*.tfrecord.gz'))
  return patterns


def assert_batches_equal(got, want):
  assert len(got) == len(want)
  for g, w in zip(got, want):
    assert set(g) == set(w) == {'rows', 'label'}
    np.testing.assert_array_equal(g['rows'], w['rows'])
    np.testing.assert_array_equal(g['label'], w['label'])


@pytest.fixture(scope='module')
def mixed(tmp_path_factory):
  """Widths 14 and 20 (bucket 20) and 33 and 40 (bucket 40)."""
  return write_shards(tmp_path_factory.mktemp('mixed'),
                      [(14, 10), (20, 22), (33, 9), (40, 15)])


@pytest.mark.parametrize('shuffle', [True, False])
def test_bucketed_dataset_iterator_matches_jax(mixed, shuffle):
  jp, tp = both_params(window_buckets=(20, 40))
  want = jax_data.DatasetIterator(mixed, jp, batch_size=4, seed=3,
                                  shuffle=shuffle)
  got = torch_data.DatasetIterator(mixed, tp, batch_size=4, seed=3,
                                   shuffle=shuffle)
  assert got.window_buckets_present == want.window_buckets_present == (20,
                                                                       40)
  assert got.steps_per_epoch == want.steps_per_epoch == 14
  assert len(got) == len(want) == 56
  for _ in range(2):  # the rng carries over
    g, w = list(got.epoch()), list(want.epoch())
    assert {b['rows'].shape[2] for b in g} == {20, 40}
    assert_batches_equal(g, w)
  assert dict(got.counters) == dict(want.counters)
  assert got.counters['n_train_padded_positions'] > 0


def test_dataset_iterator_rejects_an_overflow_width(mixed, tmp_path):
  wide = write_shards(tmp_path, [(50, 4)], n_shards=1)
  jp, tp = both_params(window_buckets=(20, 40))
  with pytest.raises(WindowBucketError, match='overflows'):
    torch_data.DatasetIterator(mixed + wide, tp, batch_size=4)
  with pytest.raises(Exception, match='overflows'):
    jax_data.DatasetIterator(mixed + wide, jp, batch_size=4)


class _ShardOrderOf:
  """The JAX dataset as its own `_raw_stream` sees it, but with the
  port's generator for the shard order (StreamingDataset draws the
  order on its producer thread and the batches on the consumer; the
  JAX package takes both from one generator, so its batches depend on
  which thread draws first)."""

  def __init__(self, ds):
    self._ds = ds
    self._rng = np.random.default_rng([1, ds.seed])

  def __getattr__(self, name):
    return getattr(self._ds, name)


def jax_streaming(patterns, params, **kw):
  ds = jax_data.StreamingDataset(patterns, params, **kw)
  view = _ShardOrderOf(ds)
  ds._raw_stream = lambda: jax_data.StreamingDataset._raw_stream(view)
  return ds


def take(ds, n):
  it = iter(ds)
  try:
    return [next(it) for _ in range(n)]
  finally:
    it.close()


STREAM_CASES = {
    # (params, the shard sets of `mixed` read)
    'one_bucket': (dict(window_buckets=None), slice(0, 2)),
    'two_buckets': (dict(window_buckets=(20, 40)), slice(0, 4)),
    # Few wide windows (only the 33s): the 40 bucket starves and is
    # topped up with promoted narrow windows.
    'two_buckets_starved': (dict(window_buckets=(20, 40),
                                 bucket_starvation_batches=2), slice(0, 3)),
}


@pytest.mark.parametrize('case', sorted(STREAM_CASES))
def test_serial_streaming_batches_match_jax(mixed, case):
  overrides, shards = STREAM_CASES[case]
  jp, tp = both_params(**overrides)
  patterns = mixed[shards]
  kw = dict(batch_size=4, buffer_size=12, seed=5)
  want = jax_streaming(patterns, jp, **kw)
  got = torch_data.StreamingDataset(patterns, tp, **kw)
  assert_batches_equal(take(got, 25), take(want, 25))
  assert dict(got.counters) == dict(want.counters)
  if case == 'two_buckets_starved':
    assert got.counters['n_train_promoted_windows'] > 0


def truncate(path, keep=0.6):
  with open(path, 'rb') as f:
    data = f.read()
  with open(path, 'wb') as f:
    f.write(data[:int(len(data) * keep)])


@pytest.fixture(scope='module')
def one_truncated(tmp_path_factory):
  """Four shards of 16 width-20 examples; the second truncated."""
  root = tmp_path_factory.mktemp('truncated')
  paths = synthetic.write_synthetic_tfrecords(
      str(root), n_shards=4, n_examples=64, max_passes=MAX_PASSES,
      max_length=LENGTH, seed=9)
  truncate(paths[1])
  return paths


@pytest.mark.parametrize('policy', ['fail', 'skip'])
def test_serial_streaming_on_shard_error_matches_jax(one_truncated, policy):
  jp, tp = both_params()
  kw = dict(batch_size=4, buffer_size=8, seed=2, on_shard_error=policy)
  got = torch_data.StreamingDataset(one_truncated, tp, **kw)
  want = jax_streaming(one_truncated, jp, **kw)
  if policy == 'fail':
    with pytest.raises(Exception) as got_err:
      take(got, 40)
    with pytest.raises(Exception) as want_err:
      take(want, 40)
    assert type(got_err.value).__name__ == type(want_err.value).__name__
    return
  assert_batches_equal(take(got, 40), take(want, 40))

  def emitted(counters):
    return {k: v for k, v in counters.items() if k.startswith('n_train_')}

  # The shard faults are counted on the producer thread, which reads
  # ahead of the batches by as far as its queue lets it: their count
  # when the consumer stops depends on timing, in both packages.
  assert emitted(got.counters) == emitted(want.counters)
  assert got.counters['n_shard_errors'] >= 1
  assert want.counters['n_shard_errors'] >= 1


def example_key(parsed):
  return parsed['label'].tobytes() + parsed['subreads'].tobytes()


def stream_keys(ds, n, deadline_s=60):
  """The first n parses of ds's worker stream, as example keys."""
  stop = threading.Event()
  stream = ds._minimal_stream(stop)
  got = []
  start = time.monotonic()
  try:
    for parsed in stream:
      got.append(example_key(parsed))
      if len(got) == n:
        break
      assert time.monotonic() - start < deadline_s
  finally:
    stream.close()
  return got


def test_streaming_workers_take_chunks_in_turn(tmp_path):
  """4 shards of 16, 2 workers of 2 shards each: the stream is chunk 0
  of worker 0, chunk 0 of worker 1, chunk 1 of worker 0, ..., each
  worker's chunks being 64 parses of its shards in its seeded order
  (seed + w, a fresh permutation each pass), whatever the workers'
  start-up and speed; two runs give the same batches."""
  paths = synthetic.write_synthetic_tfrecords(
      str(tmp_path), n_shards=4, n_examples=64, max_passes=MAX_PASSES,
      max_length=LENGTH, seed=4)
  _, tp = both_params()
  ds = torch_data.StreamingDataset(paths, tp, batch_size=4, seed=1,
                                   workers=2)
  got = stream_keys(ds, 4 * 64)
  assert not multiprocessing.active_children()
  records = {p: [example_key(torch_data.parse_example_minimal(raw))
                 for raw in torch_data.read_tfrecords(p)] for p in paths}
  chunks = []
  for w in range(2):
    owned = paths[w::2]
    rng = np.random.default_rng(1 + w)
    seq = []
    while len(seq) < 2 * 64:
      for i in rng.permutation(len(owned)):
        seq += records[owned[i]]
    chunks.append([seq[:64], seq[64:128]])
  want = chunks[0][0] + chunks[1][0] + chunks[0][1] + chunks[1][1]
  assert got == want
  assert dict(ds.counters) == {'n_parsed_worker_0': 128,
                               'n_parsed_worker_1': 128}
  again = torch_data.StreamingDataset(paths, tp, batch_size=4,
                                      buffer_size=32, seed=1, workers=2)
  first = torch_data.StreamingDataset(paths, tp, batch_size=4,
                                      buffer_size=32, seed=1, workers=2)
  assert_batches_equal(take(first, 12), take(again, 12))
  assert not multiprocessing.active_children()


def test_streaming_workers_count_a_truncated_shard(one_truncated):
  _, tp = both_params()
  ds = torch_data.StreamingDataset(one_truncated, tp, batch_size=4, seed=1,
                                   workers=2, on_shard_error='skip')
  got = stream_keys(ds, 2 * 64)
  assert not multiprocessing.active_children()
  assert ds.counters['n_shard_errors'] >= 1
  known = set()
  for path in one_truncated[::2] + one_truncated[3:]:
    known |= {example_key(torch_data.parse_example_minimal(raw))
              for raw in torch_data.read_tfrecords(path)}
  # The truncated shard's records before the cut are good parses too.
  assert len(set(got) - known) <= 16


def test_streaming_worker_crash_names_its_shards(one_truncated, tmp_path,
                                                 monkeypatch):
  paths = [p for i, p in enumerate(one_truncated) if i != 1]
  monkeypatch.setenv(torch_faults.ENV_KILL_SHARD_READER, 'shard-00002')
  monkeypatch.setenv(torch_faults.ENV_KILL_TOKEN, str(tmp_path / 'token'))
  _, tp = both_params()
  ds = torch_data.StreamingDataset(paths, tp, batch_size=4, buffer_size=8,
                                   seed=1, workers=2)
  with pytest.raises(RuntimeError) as err:
    take(ds, 100_000)
  assert 'owned shards' in str(err.value)
  assert 'shard-00002' in str(err.value)
  assert not multiprocessing.active_children()


def test_abandoned_streaming_iterator_stops_its_workers(one_truncated):
  _, tp = both_params()
  ds = torch_data.StreamingDataset(one_truncated[2:], tp, batch_size=4,
                                   buffer_size=8, seed=1, workers=2)
  it = torch_data.prefetch_iterator(iter(ds))
  assert next(it)['rows'].shape == (4, tp.total_rows, LENGTH, 1)
  it.close()
  assert not multiprocessing.active_children()


AUGMENT_CASES = {
    'defaults': {},
    'every_transform': dict(augment_perm_prob=1.0, augment_drop_prob=1.0,
                            augment_rc_prob=1.0, augment_jitter_prob=1.0),
}


@pytest.mark.parametrize('case', sorted(AUGMENT_CASES))
def test_augment_batch_matches_jax(mixed, case):
  probs = dict(augment_perm_prob=0.5, augment_drop_prob=0.3,
               augment_rc_prob=0.5, augment_jitter_prob=0.3)
  probs.update(AUGMENT_CASES[case])
  jp, tp = both_params(**probs)
  batch = next(torch_data.DatasetIterator(mixed[:2], tp, batch_size=16,
                                          seed=1).epoch())
  # Holes: an absent subread in the middle of some examples.
  batch['rows'][::3, [2, MAX_PASSES + 2, 2 * MAX_PASSES + 2,
                      3 * MAX_PASSES + 2]] = 0
  before = {k: v.copy() for k, v in batch.items()}
  got = torch_data.augment_batch(batch, tp, np.random.default_rng(7))
  want = jax_data.augment_batch(batch, jp, np.random.default_rng(7))
  assert_batches_equal([got], [want])
  assert_batches_equal([batch], [before])  # the input is not changed
  assert not np.array_equal(got['rows'], before['rows'])


def test_prefetch_iterator_reraises_and_closes():
  closed = []

  def source():
    try:
      yield 1
      yield 2
      raise ValueError('producer failed')
    finally:
      closed.append(True)

  threads = threading.active_count()
  it = torch_data.prefetch_iterator(source(), depth=1)
  assert [next(it), next(it)] == [1, 2]
  with pytest.raises(ValueError, match='producer failed'):
    next(it)
  assert closed and threading.active_count() == threads

  closed.clear()

  def endless():
    try:
      while True:
        yield 0
    finally:
      closed.append(True)

  it = torch_data.prefetch_iterator(endless(), depth=2)
  next(it)
  it.close()
  assert closed and threading.active_count() == threads


def test_loader_worker_module_imports_no_torch():
  """A spawned loader worker imports models/data.py (and with it the
  package): no torch, so it starts in a fraction of a second."""
  import subprocess
  import sys

  repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  code = ('import sys, deepconsensus_tpu_torch.models.data\n'
          'sys.exit(1 if "torch" in sys.modules else 0)\n')
  proc = subprocess.run([sys.executable, '-c', code], cwd=repo,
                        env=dict(os.environ, PYTHONPATH=repo),
                        capture_output=True, text=True, timeout=60)
  assert proc.returncode == 0, proc.stderr
