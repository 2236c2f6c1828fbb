"""Row formatting for model input (reference data_providers.py:128-184)
and the training loaders: TFRecord examples -> shuffled (rows, label)
batches, copied from the reference package's models/data.py with its
seeded draws, so the batches are the same:

* DatasetIterator: the shards read once into memory, one group per
  window bucket, width-pure batches;
* StreamingDataset: shards read one at a time (in `loader_workers`
  spawned processes when asked), a reservoir shuffle buffer, per-bucket
  accumulation under a batch clock with starvation promotion;
* prefetch_iterator: a background thread that keeps batches ready;
* augment_batch: training-time window augmentation.

This module imports no torch, so a loader worker (`_shard_reader_main`,
a `spawn` process that imports it) starts in about half a second.
Multi-host shard assignment (the reference's host_rank / host_count /
reassign_hosts) and window ids in batches (track_window_ids) are not
ported (ROADMAP: multi-GPU training, the NaN sentinel).
"""
from __future__ import annotations

import collections
import dataclasses
import logging
from typing import Dict, Iterator, List, Sequence, Union

import numpy as np

from deepconsensus_tpu_torch import constants
from deepconsensus_tpu_torch.faults import CorruptInputError, WindowBucketError
from deepconsensus_tpu_torch.io.example_proto import Example
from deepconsensus_tpu_torch.io.tfrecord import read_tfrecords
from deepconsensus_tpu_torch.models import config
from deepconsensus_tpu_torch.preprocess.pileup import (
    layout_from_shape,
    row_indices,
)
from deepconsensus_tpu_torch.utils import phred

log = logging.getLogger(__name__)


class OnShardError:
  """--on_shard_error policy values (StreamingDataset)."""

  FAIL = 'fail'
  SKIP = 'skip'

  CHOICES = (FAIL, SKIP)


def format_rows_batch(subreads: np.ndarray, params,
                      window_buckets: Sequence[int] = ()) -> np.ndarray:
  """Clips PW/IP/SN rows and crops passes to the model's max_passes for
  a whole window batch [N, H, L, 1]. The width must be one of the
  window buckets: window_buckets when given, else the params' buckets
  (max_length alone when params.window_buckets is unset)."""
  example_layout = layout_from_shape(subreads.shape[1:], params.use_ccs_bq)
  (base_r, pw_r, ip_r, strand_r, ccs_r, ccs_bq_r, sn_r) = row_indices(
      example_layout.max_passes, params.use_ccs_bq
  )
  keep = params.max_passes

  def rows_of(r, cap=None):
    block = subreads[:, r[0]:r[1]]
    return block[:, :cap] if cap else block

  features = [
      rows_of(base_r, keep),
      np.clip(rows_of(pw_r, keep), 0, params.PW_MAX),
      np.clip(rows_of(ip_r, keep), 0, params.IP_MAX),
      rows_of(strand_r, keep),
      rows_of(ccs_r),
  ]
  if params.use_ccs_bq:
    features.append(rows_of(ccs_bq_r))
  features.append(np.clip(rows_of(sn_r), 0, params.SN_MAX))
  rows = np.concatenate(features, axis=1)
  buckets = (tuple(window_buckets) if window_buckets
             else config.resolve_window_buckets(params))
  width = rows.shape[2]
  if width not in buckets:
    raise WindowBucketError(
        f'window width {width} not in window buckets {buckets}; triage '
        'the window into a bucket (pad) first')
  expected = (len(subreads), params.total_rows, width, 1)
  assert rows.shape == expected, rows.shape
  return rows


# The only proto fields the training batch path needs.
_MINIMAL_FIELDS = frozenset({
    'subreads/encoded', 'subreads/shape', 'label/encoded', 'label/shape',
})


def parse_example_minimal(raw: bytes) -> Dict[str, np.ndarray]:
  """Decodes only the subreads tensor (raw, unformatted) and the label;
  row formatting and label gap-shifting happen per batch."""
  ex = Example.parse(raw, fields=_MINIMAL_FIELDS)
  return {
      name: np.frombuffer(ex[f'{name}/encoded'][0],
                          dtype=constants.NP_DATA_TYPE).reshape(
                              ex[f'{name}/shape'])
      for name in ('subreads', 'label')
  }


def _shard_reader_main(paths, seed: int, out_queue, chunk: int = 64,
                       on_shard_error: str = 'fail') -> None:
  """StreamingDataset worker: reads its shard subset forever (inflate,
  framing and the minimal parse in this process) and ships parsed
  chunks to the parent on its own queue as ('chunk', parses). Under
  on_shard_error='skip' a shard that fails to decode is reported as
  ('shard_error', (description, corrupt)) and an undecodable record as
  ('corrupt_record', description), and the worker reads on; under
  'fail' it exits non-zero and the parent's liveness check raises. The
  parent terminates it; a blocking put keeps it idle while the
  consumer is behind."""
  from deepconsensus_tpu_torch import faults as faults_lib
  from deepconsensus_tpu_torch.io.tfrecord import TFRecordReader

  rng = np.random.default_rng(seed)
  pending: List[Dict[str, np.ndarray]] = []
  while True:
    # One shard at a time (whole-shard native decode: a worker holds at
    # most its largest shard); the parent's reservoir and this
    # per-epoch permutation mix them.
    produced = False
    for i in rng.permutation(len(paths)):
      path = paths[i]
      faults_lib.maybe_kill_shard_reader(path)
      try:
        for raw in TFRecordReader(path, native_decode=True):
          try:
            parsed = parse_example_minimal(raw)
          except Exception as e:  # noqa: BLE001 - policy-gated
            if on_shard_error != OnShardError.SKIP:
              raise
            out_queue.put(
                ('corrupt_record', f'{path}: {type(e).__name__}: {e}'))
            continue
          pending.append(parsed)
          produced = True
          if len(pending) >= chunk:
            out_queue.put(('chunk', pending))
            pending = []
      except Exception as e:  # noqa: BLE001 - policy-gated
        if on_shard_error != OnShardError.SKIP:
          raise
        # The records decoded before the fault are good parses: kept.
        out_queue.put(
            ('shard_error', (f'{path}: {type(e).__name__}: {e}',
                             isinstance(e, faults_lib.CorruptInputError))))
    if not produced and on_shard_error == OnShardError.SKIP:
      raise RuntimeError(
          f'every shard failed to decode under on_shard_error=skip: '
          f'{paths}')


def _window_width(parsed: Dict[str, np.ndarray]) -> int:
  """Window width of one minimal parse ([H, L, 1] subreads)."""
  return int(parsed['subreads'].shape[1])


def _pad_minimal(parsed: Dict[str, np.ndarray], pad_to: int
                 ) -> Dict[str, np.ndarray]:
  """Pads one minimal parse's window axis up to pad_to. Zero is the
  absent value of every row family and the gap label, so the pad is
  semantically a no-op."""
  w = _window_width(parsed)
  if w == pad_to:
    return parsed
  return {
      'subreads': np.pad(parsed['subreads'], ((0, 0), (0, pad_to - w),
                                              (0, 0))),
      'label': np.pad(parsed['label'], (0, pad_to - w)),
  }


def _batch_from_minimal(chosen: List[Dict[str, np.ndarray]], params,
                        pad_to: int) -> Dict[str, np.ndarray]:
  """Stacks minimal parses into a formatted (rows, label) batch."""
  chosen = [_pad_minimal(c, pad_to) for c in chosen]
  label = np.stack([c['label'] for c in chosen])
  if params.get('remove_label_gaps', False):
    label = phred.left_shift(label)
  return {
      'rows': format_rows_batch(
          np.stack([c['subreads'] for c in chosen]), params),
      'label': label,
  }


@dataclasses.dataclass
class DatasetIterator:
  """Shuffled, fixed-batch iterator over TFRecord shards.

  Loads the shards once, triages each example into the smallest window
  bucket that fits (params.window_buckets; max_length alone when unset)
  and pads it to that width, then yields width-pure {'rows', 'label'}
  batches, each bucket's last partial batch of an epoch dropped, as in
  the reference. One bucket keeps the reference's flat rows / labels and
  its per-epoch permutation; several shuffle within each bucket, then
  the batch slots across buckets, all from one
  np.random.default_rng(seed). A width over every bucket raises
  WindowBucketError. limit >= 0 reads at most that many examples (-1:
  all). counters: batches per bucket and the padded / total window
  positions of the emitted batches.
  """

  patterns: Union[str, Sequence[str]]
  params: object
  batch_size: int
  seed: int = 1
  shuffle: bool = True
  limit: int = -1

  def __post_init__(self):
    buckets = config.resolve_window_buckets(self.params)
    grouped: Dict[int, List[Dict[str, np.ndarray]]] = {}
    for i, raw in enumerate(read_tfrecords(self.patterns)):
      if 0 <= self.limit <= i:
        break
      parsed = parse_example_minimal(raw)
      width = _window_width(parsed)
      bucket = config.bucket_for(width, buckets)
      if bucket is None:
        raise WindowBucketError(
            f'window width {width} overflows window buckets {buckets}')
      grouped.setdefault(bucket, []).append(parsed)
    if not grouped:
      raise ValueError(f'no examples matched {self.patterns!r}')
    self._groups = {}
    for b in sorted(grouped):
      group = _batch_from_minimal(grouped[b], self.params, pad_to=b)
      group['width'] = np.asarray(
          [_window_width(p) for p in grouped[b]], dtype=np.int64)
      self._groups[b] = group
    grouped.clear()
    self.counters: collections.Counter = collections.Counter()
    if len(self._groups) == 1:
      group = next(iter(self._groups.values()))
      self.rows, self.labels = group['rows'], group['label']
    else:
      self.rows = self.labels = None
    self._rng = np.random.default_rng(self.seed)

  def __len__(self) -> int:
    return sum(len(g['rows']) for g in self._groups.values())

  @property
  def window_buckets_present(self) -> tuple:
    return tuple(sorted(self._groups))

  @property
  def steps_per_epoch(self) -> int:
    return sum(len(g['rows']) // self.batch_size
               for g in self._groups.values())

  def _count_emit(self, bucket: int, widths: np.ndarray) -> None:
    self.counters[f'n_train_batches_by_bucket_{bucket}'] += 1
    self.counters['n_train_padded_positions'] += int(
        (bucket - widths).sum())
    self.counters['n_train_window_positions'] += int(
        bucket * len(widths))

  def epoch(self) -> Iterator[Dict[str, np.ndarray]]:
    if self.rows is not None:
      bucket, g = next(iter(self._groups.items()))
      order = np.arange(len(self.rows))
      if self.shuffle:
        self._rng.shuffle(order)
      for start in range(0, self.steps_per_epoch * self.batch_size,
                         self.batch_size):
        idx = order[start:start + self.batch_size]
        self._count_emit(bucket, g['width'][idx])
        yield {'rows': self.rows[idx], 'label': self.labels[idx]}
      return
    # Several buckets: shuffle within each, then interleave the batch
    # slots (seeded when shuffling, narrow to wide otherwise), so a
    # resumed run's skip replays the same sequence.
    slots: List[tuple] = []
    orders: Dict[int, np.ndarray] = {}
    for b in sorted(self._groups):
      order = np.arange(len(self._groups[b]['rows']))
      if self.shuffle:
        self._rng.shuffle(order)
      orders[b] = order
      stop = len(order) - len(order) % self.batch_size
      slots.extend((b, start) for start in range(0, stop, self.batch_size))
    if self.shuffle:
      self._rng.shuffle(slots)
    for b, start in slots:
      g = self._groups[b]
      idx = orders[b][start:start + self.batch_size]
      self._count_emit(b, g['width'][idx])
      yield {'rows': g['rows'][idx], 'label': g['label'][idx]}


@dataclasses.dataclass
class StreamingDataset:
  """Shard-interleaved streaming loader with a shuffle buffer, for
  corpora too large for memory (the reference trains on ~100M examples).

  Shards are read in a fresh seeded order each pass, one at a time,
  forever: on a producer thread, or with workers > 0 in that many
  `spawn` processes, each owning every workers-th shard, whose chunks
  of 64 parses are taken in turn (so the stream is the same in every
  run). Parsed
  examples fill a reservoir of buffer_size from which fixed-size
  batches are drawn (reference data_providers.py:395-425); with several
  window buckets, per-bucket buffers under a batch clock
  (`_bucketed_batches`). on_shard_error 'skip' counts an undecodable
  shard (n_shard_errors, n_corrupt_records) or record and reads on;
  'fail' raises. A dead worker raises naming the shards it owned.
  Closing the iterator (or abandoning it) stops the thread and
  terminates and joins the workers.
  """

  patterns: Union[str, Sequence[str]]
  params: object
  batch_size: int
  buffer_size: int = 100_000
  seed: int = 1
  workers: int = 0
  on_shard_error: str = OnShardError.FAIL

  def __post_init__(self):
    from deepconsensus_tpu_torch.io.tfrecord import glob_paths

    if self.on_shard_error not in OnShardError.CHOICES:
      raise ValueError(
          f'on_shard_error must be one of {OnShardError.CHOICES}, '
          f'got {self.on_shard_error!r}')
    self._paths = glob_paths(self.patterns)
    if not self._paths:
      raise ValueError(f'no shards matched {self.patterns!r}')
    # The batch draws (this thread) and the serial stream's shard order
    # (the producer thread) take generators of their own. The reference
    # draws both from one, on two threads, so its batches depend on
    # which thread draws first; here they are a function of the seed.
    self._rng = np.random.default_rng(self.seed)
    self._shard_rng = np.random.default_rng([1, self.seed])
    self._buckets = config.resolve_window_buckets(self.params)
    # The producer side (shard and record faults, per-worker parses) and
    # the consumer side (per-bucket emission) bump disjoint keys.
    self.counters: collections.Counter = collections.Counter()

  def _raw_stream(self) -> Iterator[bytes]:
    """Shards in a fresh seeded order each pass, one at a time
    (whole-shard native decode: memory bounded by the largest shard)."""
    from deepconsensus_tpu_torch.io.tfrecord import TFRecordReader

    while True:
      produced = False
      for i in self._shard_rng.permutation(len(self._paths)):
        path = self._paths[i]
        try:
          for raw in TFRecordReader(path, native_decode=True):
            produced = True
            yield raw
        except Exception as e:  # noqa: BLE001 - policy-gated below
          if self.on_shard_error != OnShardError.SKIP:
            raise
          self.counters['n_shard_errors'] += 1
          if isinstance(e, CorruptInputError):
            self.counters['n_corrupt_records'] += 1
          log.warning('on_shard_error=skip: skipping shard %s (%s: %s)',
                      path, type(e).__name__, e)
      if not produced:
        # Every shard bad: skip would otherwise spin yielding nothing.
        raise RuntimeError(
            f'every shard failed to decode under on_shard_error=skip: '
            f'{self._paths}')

  def _minimal_stream(self, stop) -> Iterator[Dict[str, np.ndarray]]:
    """Raw records -> minimal parses, in this thread or, with workers,
    in spawned processes that each own a round-robin subset of the
    shards (inflate, framing and parse run there; this process takes
    their parsed chunks in turn)."""
    if self.workers <= 0:
      for raw in self._raw_stream():
        if stop.is_set():
          return
        try:
          parsed = parse_example_minimal(raw)
        except Exception as e:  # noqa: BLE001 - policy-gated
          if self.on_shard_error != OnShardError.SKIP:
            raise
          # An intact frame around an undecodable payload (the stream
          # skips payload CRCs): skip the record, not the shard.
          self.counters['n_corrupt_records'] += 1
          log.warning('on_shard_error=skip: undecodable record (%s: %s)',
                      type(e).__name__, e)
          continue
        yield parsed
      return
    import multiprocessing
    import queue as queue_lib

    n_workers = min(self.workers, len(self._paths))
    # spawn, not fork: this process runs threads and may hold a CUDA
    # context; a worker needs only numpy and the record codecs.
    ctx = multiprocessing.get_context('spawn')
    # One queue a worker (of <= 64-parse chunks), drained in turn: a
    # chunk of worker 0, then of worker 1, ... So the stream mixes the
    # workers' shards evenly and is the same in every run, however the
    # workers' start-up and speed interleave (the reference drains one
    # shared queue, where the first worker up can deliver every batch
    # before the others send anything).
    queues = [ctx.Queue(maxsize=16) for _ in range(n_workers)]
    worker_paths = [self._paths[w::n_workers] for w in range(n_workers)]
    procs = [ctx.Process(
        target=_shard_reader_main,
        args=(worker_paths[w], self.seed + w, queues[w], 64,
              self.on_shard_error), daemon=True)
             for w in range(n_workers)]

    def check_liveness():
      # A worker that died non-zero is fatal: reading on from the others
      # would silently skew the data.
      crashed = [(w, p.exitcode) for w, p in enumerate(procs)
                 if not p.is_alive() and p.exitcode not in (0, None)]
      if crashed:
        detail = '; '.join(
            f'worker {w} (exit code {code}) owned shards {worker_paths[w]}'
            for w, code in crashed)
        raise RuntimeError(
            f'StreamingDataset worker(s) crashed ({len(crashed)} of '
            f'{n_workers}): {detail}; check shard paths/integrity '
            '(corrupt shard or OOM)')
      if not any(p.is_alive() for p in procs):
        raise RuntimeError(
            f'all {n_workers} StreamingDataset workers exited (exit codes '
            f'{[p.exitcode for p in procs]}); check shard paths/integrity')

    def next_chunk(w):
      """Worker w's next chunk, counting its fault reports on the way;
      None once stop is set."""
      while not stop.is_set():
        check_liveness()
        try:
          kind, payload = queues[w].get(timeout=1.0)
        except queue_lib.Empty:
          continue
        if kind == 'shard_error':
          message, corrupt = payload
          self.counters['n_shard_errors'] += 1
          if corrupt:
            self.counters['n_corrupt_records'] += 1
          log.warning('on_shard_error=skip: worker skipped shard (%s)',
                      message)
        elif kind == 'corrupt_record':
          self.counters['n_corrupt_records'] += 1
          log.warning('on_shard_error=skip: worker skipped record (%s)',
                      payload)
        else:
          return payload
      return None

    try:
      for proc in procs:
        proc.start()
      w = 0
      while True:
        parses = next_chunk(w)
        if parses is None:
          return
        # Per-worker decode counts show whether the load splits evenly.
        self.counters[f'n_parsed_worker_{w}'] += len(parses)
        yield from parses
        w = (w + 1) % n_workers
    finally:
      for proc in procs:
        if proc.pid is not None:
          proc.terminate()
      for proc in procs:
        if proc.pid is not None:
          proc.join(timeout=5)
      for q in queues:
        q.close()
        q.join_thread()

  def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
    import queue as queue_lib
    import threading

    parsed_queue: 'queue_lib.Queue' = queue_lib.Queue(maxsize=4096)
    stop = threading.Event()

    def producer():
      # A decode error (bad shard, dead worker) crosses to the consumer
      # as an item and raises there.
      stream = self._minimal_stream(stop)
      try:
        for parsed in stream:
          while not stop.is_set():
            try:
              parsed_queue.put(('item', parsed), timeout=0.5)
              break
            except queue_lib.Full:
              continue
          if stop.is_set():
            return
      except BaseException as e:  # noqa: BLE001 - re-raised at consumer
        while not stop.is_set():
          try:
            parsed_queue.put(('error', e), timeout=0.5)
            return
          except queue_lib.Full:
            continue
      finally:
        stream.close()  # terminates and joins the workers

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()

    def next_parsed():
      kind, payload = parsed_queue.get()
      if kind == 'error':
        raise payload
      return payload

    try:
      if len(self._buckets) == 1:
        bucket = self._buckets[0]
        buffer: List[Dict[str, np.ndarray]] = []
        fill_target = max(self.buffer_size, self.batch_size * 2)
        while True:
          while len(buffer) < fill_target:
            triaged = self._triage(next_parsed())
            if triaged is not None:
              buffer.append(triaged[1])
          idx = self._rng.choice(len(buffer), self.batch_size,
                                 replace=False)
          idx_set = set(idx.tolist())
          chosen = [buffer[i] for i in idx]
          buffer = [b for i, b in enumerate(buffer) if i not in idx_set]
          self._count_emit(bucket, chosen)
          yield _batch_from_minimal(chosen, self.params, pad_to=bucket)
      else:
        yield from self._bucketed_batches(next_parsed)
    finally:
      # Stop and join the producer, whose stream's finally terminates
      # and joins the workers: nothing keeps decoding after the
      # consumer left. Drain so a producer blocked on a full queue sees
      # the stop.
      stop.set()
      while thread.is_alive():
        try:
          parsed_queue.get(timeout=0.1)
        except queue_lib.Empty:
          pass
      thread.join()

  def _triage(self, parsed: Dict[str, np.ndarray]):
    """(bucket, parse) for the smallest bucket that fits the window, or
    None after counting an overflow width under on_shard_error='skip'
    (n_width_rejected; under 'fail' WindowBucketError)."""
    width = _window_width(parsed)
    bucket = config.bucket_for(width, self._buckets)
    if bucket is not None:
      return bucket, parsed
    if self.on_shard_error != OnShardError.SKIP:
      raise WindowBucketError(
          f'window width {width} overflows window buckets {self._buckets}; '
          'widen window_buckets or run with --on_shard_error=skip to '
          'quarantine it')
    self.counters['n_width_rejected'] += 1
    log.warning('on_shard_error=skip: window width %d overflows buckets '
                '%s; rejected (n_width_rejected)', width, self._buckets)
    return None

  def _count_emit(self, bucket: int, chosen: List[Dict]) -> None:
    self.counters[f'n_train_batches_by_bucket_{bucket}'] += 1
    self.counters['n_train_padded_positions'] += sum(
        bucket - _window_width(c) for c in chosen)
    self.counters['n_train_window_positions'] += bucket * len(chosen)

  def _bucketed_batches(self, next_parsed
                        ) -> Iterator[Dict[str, np.ndarray]]:
    """Several buckets: each parse goes to its smallest bucket's buffer.
    A bucket with a full batch emits (largest backlog first, ties to
    the wider); a bucket whose backlog has waited
    bucket_starvation_batches (default 8) clock ticks flushes instead,
    topped up to a full batch with windows promoted from narrower
    buckets, so every batch holds batch_size real windows at one width.
    The schedule is a function of the parse stream and the seeded rng
    alone."""
    batch = self.batch_size
    buckets = self._buckets
    starvation = int(self.params.get('bucket_starvation_batches', 8) or 8)
    fill_target = max(self.buffer_size, batch * 2 * len(buckets))
    buffers: Dict[int, List[Dict[str, np.ndarray]]] = {b: [] for b in buckets}
    # Clock tick at which each bucket's backlog began waiting; -1 empty.
    waiting = {b: -1 for b in buckets}
    clock = 0

    def ready():
      return [b for b in buckets if len(buffers[b]) >= batch]

    def starved():
      # Flushable only when promotion can top the batch up to full.
      return [b for b in buckets
              if waiting[b] >= 0 and clock - waiting[b] >= starvation
              and sum(len(buffers[x]) for x in buckets if x <= b) >= batch]

    def draw(bucket, take):
      pool = buffers[bucket]
      idx = self._rng.choice(len(pool), take, replace=False)
      idx_set = set(idx.tolist())
      buffers[bucket] = [p for i, p in enumerate(pool) if i not in idx_set]
      return [pool[i] for i in idx]

    while True:
      while True:
        total = sum(len(v) for v in buffers.values())
        if (ready() or starved()) and total >= fill_target:
          break
        triaged = self._triage(next_parsed())
        if triaged is None:
          continue
        b, parsed = triaged
        buffers[b].append(parsed)
        if waiting[b] < 0:
          waiting[b] = clock
      star = starved()
      if star:
        # The widest starving bucket first: its windows can go nowhere
        # else.
        bucket = max(star)
        chosen = draw(bucket, min(len(buffers[bucket]), batch))
        if len(chosen) < batch:
          self.counters['n_train_starvation_flushes'] += 1
          for nb in sorted((x for x in buckets if x < bucket),
                           reverse=True):
            need = batch - len(chosen)
            if not need:
              break
            take = min(need, len(buffers[nb]))
            if take:
              chosen.extend(draw(nb, take))
              self.counters['n_train_promoted_windows'] += take
      else:
        bucket = max(ready(), key=lambda b: (len(buffers[b]), b))
        chosen = draw(bucket, batch)
      clock += 1
      for b in buckets:
        if not buffers[b]:
          waiting[b] = -1
      waiting[bucket] = clock if buffers[bucket] else -1
      self._count_emit(bucket, chosen)
      yield _batch_from_minimal(chosen, self.params, pad_to=bucket)


def prefetch_iterator(iterator, depth: int = 2):
  """Runs `iterator` on a background thread, keeping up to `depth` items
  ready, so host-side decode, shuffle and stacking overlap the device
  step. An error of the producer re-raises at the consumer; closing the
  generator stops the producer and joins it."""
  import queue
  import threading

  q: 'queue.Queue' = queue.Queue(maxsize=depth)
  stop = threading.Event()

  def put(item) -> bool:
    while not stop.is_set():
      try:
        q.put(item, timeout=0.2)
        return True
      except queue.Full:
        continue
    return False

  def producer():
    try:
      for item in iterator:
        if not put(('item', item)):
          return
      put(('end', None))
    except BaseException as e:  # noqa: BLE001 - surfaced to the consumer
      put(('error', e))

  thread = threading.Thread(target=producer, daemon=True)
  thread.start()
  try:
    while True:
      kind, payload = q.get()
      if kind == 'end':
        return
      if kind == 'error':
        raise payload
      yield payload
  finally:
    stop.set()
    while thread.is_alive():
      try:
        q.get(timeout=0.1)
      except queue.Empty:
        pass
    thread.join()
    close = getattr(iterator, 'close', None)
    if close is not None:
      close()


# Complement map over SEQ_VOCAB ' ATCG': gap fixed, A<->T, C<->G.
_COMPLEMENT_LUT = np.array([0, 2, 1, 4, 3], dtype=constants.NP_DATA_TYPE)
# Strand values (constants.Strand): UNKNOWN fixed, FORWARD<->REVERSE.
_STRAND_FLIP_LUT = np.array([0, 2, 1], dtype=constants.NP_DATA_TYPE)
# SN rows are per-channel [A, C, G, T]; reverse-complement reads each
# base as its partner, so channels swap A<->T, C<->G.
_SN_RC_ORDER = np.array([3, 2, 1, 0])


def augment_batch(batch: Dict[str, np.ndarray], params,
                  rng: np.random.Generator) -> Dict[str, np.ndarray]:
  """Training-time window augmentation of a formatted (rows, label)
  batch, the JAX package's (no counterpart in the original reference).
  Four independent per-example transforms, each gated by its
  params.augment_*_prob:

    * subread permutation: shuffle the order of the present subreads;
    * subread downsampling: keep a random subset of at least half,
      compacted to the front;
    * reverse-complement: flip the occupied extent of every row along
      the window, complement bases, CCS and label, swap strand and SN
      channels;
    * PW/IP jitter: +/-1 on a quarter of the nonzero kinetics entries,
      clipped to [1, PW_MAX / IP_MAX].

  Returns a new batch; the input is not changed. A subread is present
  where its strand row is non-zero.
  """
  rows = batch['rows'].copy()  # [B, H, L, 1]
  label = batch['label'].copy() if batch.get('label') is not None else None
  b, _, length, _ = rows.shape
  p = params.max_passes
  blocks = rows[:, :4 * p, :, 0].reshape(b, 4, p, length)  # views rows
  bases, pw, ip, strand = (blocks[:, i] for i in range(4))
  present = strand.max(axis=2) > 0  # [B, P]
  n_present = present.sum(axis=1)  # [B]

  # Subread permutation and downsampling, one combined gather.
  perm_on = rng.random(b) < params.get('augment_perm_prob', 0.0)
  drop_on = rng.random(b) < params.get('augment_drop_prob', 0.0)
  keep = np.where(
      drop_on & (n_present > 1),
      rng.integers(np.maximum(1, -(-n_present // 2)),
                   np.maximum(n_present, 1) + 1),
      n_present)
  # A random size-`keep` subset of the present subreads survives, also
  # when the permutation does not fire (else a drop would always take
  # the trailing ones).
  sel_keys = np.where(present, rng.random((b, p)), 2.0)
  sel_rank = np.argsort(np.argsort(sel_keys, axis=1), axis=1)
  kept = (sel_rank < keep[:, None]) & present
  # Output order: random when permuting, else the original; the rest
  # sorts to the end.
  order_keys = np.where(perm_on[:, None], rng.random((b, p)),
                        np.arange(p)[None, :] / p)
  order_keys = np.where(kept, order_keys, 2.0)
  order = np.argsort(order_keys, axis=1, kind='stable')  # [B, P]
  fired = perm_on | (keep < n_present)  # [B]
  if fired.any():
    sel = np.take_along_axis(blocks, order[:, None, :, None], axis=2)
    live = np.arange(p)[None, :] < keep[:, None]  # [B, P]
    sel = np.where(live[:, None, :, None], sel, 0.0)
    # Written only where a transform fired: an example with an interior
    # all-zero row must not be compacted by the batch-wide gather.
    sel = np.where(fired[:, None, None, None], sel, blocks)
    rows[:, :4 * p, :, 0] = sel.reshape(b, 4 * p, length)
    blocks = rows[:, :4 * p, :, 0].reshape(b, 4, p, length)
    bases, pw, ip, strand = (blocks[:, i] for i in range(4))

  # Reverse-complement.
  rc_on = rng.random(b) < params.get('augment_rc_prob', 0.0)
  if rc_on.any():
    ccs_row = 4 * p
    sn_start = 4 * p + 1 + (1 if params.use_ccs_bq else 0)
    # Occupied extent: up to the last column with any base (subreads or
    # CCS); the tail padding stays the tail.
    content = (bases.max(axis=1) > 0) | (rows[:, ccs_row, :, 0] > 0)
    width = length - np.argmax(content[:, ::-1], axis=1)  # [B]
    width = np.where(content.any(axis=1), width, 0)
    rev_idx = np.arange(length)[None, :]  # [B, L] source index map
    rev_idx = np.where(rev_idx < width[:, None],
                       width[:, None] - 1 - rev_idx, rev_idx)
    flip = rc_on[:, None]

    def rev(block):  # [B, R, L]: reverse the occupied extent where rc_on
      rev_b = np.take_along_axis(block, rev_idx[:, None, :], axis=2)
      return np.where(flip[:, :, None] if block.ndim == 3 else flip,
                      rev_b, block)

    comp = _COMPLEMENT_LUT
    new_bases = rev(comp[bases.astype(np.int64)])
    rows[:, :p, :, 0] = np.where(flip[:, :, None], new_bases, bases)
    rows[:, p:2 * p, :, 0] = rev(pw)
    rows[:, 2 * p:3 * p, :, 0] = rev(ip)
    flipped_strand = _STRAND_FLIP_LUT[strand.astype(np.int64)]
    rows[:, 3 * p:4 * p, :, 0] = np.where(flip[:, :, None], flipped_strand,
                                          strand)
    ccs = rows[:, ccs_row:ccs_row + 1, :, 0]
    # Examples that do not flip keep the original CCS row (rev() would
    # hand them the complemented one).
    ccs_rc = np.take_along_axis(comp[ccs.astype(np.int64)],
                                rev_idx[:, None, :], axis=2)
    rows[:, ccs_row:ccs_row + 1, :, 0] = np.where(flip[:, :, None], ccs_rc,
                                                  ccs)
    if params.use_ccs_bq:
      rows[:, ccs_row + 1:ccs_row + 2, :, 0] = rev(
          rows[:, ccs_row + 1:ccs_row + 2, :, 0])
    sn = rows[:, sn_start:sn_start + 4, :, 0]
    rows[:, sn_start:sn_start + 4, :, 0] = np.where(
        flip[:, :, None], sn[:, _SN_RC_ORDER], sn)
    if label is not None and label.size:
      # The loss collapses the label's gaps, so a full reverse and
      # complement is exact; leading gaps shift away.
      lab_rc = _COMPLEMENT_LUT[label.astype(np.int64)][:, ::-1]
      label = np.where(rc_on[:, None], lab_rc, label).astype(label.dtype)

  # PW/IP jitter.
  jit_on = rng.random(b) < params.get('augment_jitter_prob', 0.0)
  if jit_on.any():
    blocks = rows[:, :4 * p, :, 0].reshape(b, 4, p, length)
    for bi, cap in ((1, params.PW_MAX), (2, params.IP_MAX)):
      block = blocks[:, bi]
      # From {-1, +1}: integers(-1, 2) would include 0.
      delta = (rng.integers(0, 2, size=block.shape) * 2 - 1).astype(
          rows.dtype)
      mask = (jit_on[:, None, None] & (block > 0)
              & (rng.random(block.shape) < 0.25))
      blocks[:, bi] = np.where(mask, np.clip(block + delta, 1, cap), block)
    rows[:, :4 * p, :, 0] = blocks.reshape(b, 4 * p, length)

  out = dict(batch)
  out['rows'] = rows
  if label is not None:
    out['label'] = label
  return out
