"""The port's observability plane (obs/) vs the JAX package's, on the CPU.

* A traced port `run_inference` (DCTPU_TRACE) writes the six stage spans
  (featurize, pack_wait, h2d_transfer, device_compute, finalize_drain,
  stitch) under one trace id; both packages' load_trace + summarize
  read it to the same summary and format_summary to the same text; the
  run's stage histograms reconcile with the span totals; the reads
  equal an untraced run's, which writes no trace file.
* The metrics registry's snapshot, percentiles and Prometheus text, and
  prom_counters_text, equal the JAX package's for the same operations.
* The trace writer's shared-file format, span(), configure(None).
* `cli trace` (--json, --top, text) and its exit code 2 on a corrupt
  trace.
"""
import json
import os

import numpy as np
import pytest
import torch

from deepconsensus_tpu.obs import metrics as jax_metrics
from deepconsensus_tpu.obs import summarize as jax_summarize
from deepconsensus_tpu_torch import cli
from deepconsensus_tpu_torch import faults
from deepconsensus_tpu_torch import obs
from deepconsensus_tpu_torch.inference import runner as torch_runner
from deepconsensus_tpu_torch.models import config as torch_config
from deepconsensus_tpu_torch.models import model as model_lib
from deepconsensus_tpu_torch.obs import metrics as torch_metrics
from deepconsensus_tpu_torch.obs import summarize as torch_summarize
from deepconsensus_tpu_torch.obs import trace as torch_trace
from deepconsensus_tpu_torch.testing import synthetic

SMALL = dict(dtype='float32', num_hidden_layers=2, filter_size=64)
KW = dict(batch_size=4, batch_zmws=2, min_quality=0, skip_windows_above=0)


@pytest.fixture(scope='module')
def bams(tmp_path_factory):
  return synthetic.write_synthetic_zmw_bams(
      str(tmp_path_factory.mktemp('bams')), n_zmws=6, n_subreads=4,
      seq_len=260, seed=11)


@pytest.fixture(scope='module')
def model():
  params = torch_config.get_config('transformer_learn_values+test')
  torch_config.finalize_params(params)
  params.update(SMALL)
  net = model_lib.DeepConsensusModel(params, device='cpu')
  net.init_weights(torch.Generator().manual_seed(3))
  return params, net.state_dict()


def _run(bams, model, out):
  params, state = model
  runner = torch_runner.ModelRunner(
      torch_config.Params(params), state, torch_runner.InferenceOptions(**KW),
      device='cpu')
  return runner, torch_runner.run_inference(bams[0], bams[1], out, runner)


@pytest.fixture(scope='module')
def traced(bams, model, tmp_path_factory):
  """(trace path, runner, counters, traced FASTQ, untraced FASTQ, the
  untraced run's directory)."""
  d = tmp_path_factory.mktemp('traced')
  path = str(d / 't.jsonl')
  os.environ[torch_trace.ENV_TRACE] = path
  try:
    runner, counters = _run(bams, model, str(d / 'traced.fastq'))
  finally:
    del os.environ[torch_trace.ENV_TRACE]
  assert not torch_trace.enabled()
  plain_dir = tmp_path_factory.mktemp('untraced')
  _, plain = _run(bams, model, str(plain_dir / 'untraced.fastq'))
  with open(d / 'traced.fastq', 'rb') as f, \
      open(plain_dir / 'untraced.fastq', 'rb') as g:
    return path, runner, counters, f.read(), g.read(), plain_dir


def test_traced_run_writes_every_stage_under_one_trace_id(traced):
  path, _, counters, traced_fastq, untraced_fastq, plain_dir = traced
  assert traced_fastq == untraced_fastq
  assert sorted(os.listdir(plain_dir)) == [
      'untraced.fastq', 'untraced.fastq.inference.json',
      'untraced.fastq.runtime.csv']
  events = torch_summarize.load_trace(path)
  spans = [e for e in events if e['ph'] == 'X']
  names = {e['name'] for e in spans}
  assert names == set(torch_trace.STAGES)
  counts = {n: sum(e['name'] == n for e in spans) for n in names}
  packs = counters['n_model_packs']
  assert counts == {'featurize': 3, 'stitch': 3, 'pack_wait': packs,
                    'h2d_transfer': packs, 'device_compute': packs,
                    'finalize_drain': packs}
  assert len({e['args']['trace_id'] for e in spans}) == 1
  assert [e for e in events if e['ph'] == 'M'][0]['args'] == {
      'name': 'dctpu-run'}


def test_summary_equals_the_jax_package_summary(traced):
  path = traced[0]
  port = torch_summarize.summarize(torch_summarize.load_trace(path))
  ref = jax_summarize.summarize(jax_summarize.load_trace(path))
  assert json.loads(json.dumps(port)) == json.loads(json.dumps(ref))
  assert torch_summarize.format_summary(port) == (
      jax_summarize.format_summary(ref))
  assert set(port['stage_totals_s']) == set(torch_trace.STAGES)
  assert port['device_gaps']['n_gaps'] >= 0 and port['n_traces'] == 1
  assert port['overlap'] == torch_summarize.span_overlap(
      torch_summarize.load_trace(path))


def test_stage_histograms_reconcile_with_the_spans(traced):
  """record_stage feeds one interval to the runner's histogram and to
  the span, so each stage's histogram sum is its span total."""
  path, runner = traced[:2]
  totals = torch_summarize.summarize(
      torch_summarize.load_trace(path))['stage_totals_s']
  histograms = runner.obs.snapshot()['histograms']
  for stage in torch_trace.STAGES:
    hist = histograms[obs.stage_histogram_name(stage)]
    assert hist['count'] > 0
    assert hist['sum'] == pytest.approx(totals[stage], abs=1e-5)


def test_summarize_edge_cases_match_jax(tmp_path):
  def span(name, ts, dur, **args):
    return {'name': name, 'cat': 'stage', 'ph': 'X', 'ts': ts, 'dur': dur,
            'pid': 7, 'tid': 1, 'args': args}

  events = [
      span('device_compute', 0, 10, pack=1, bucket=100, n_rows=4),
      span('finalize_drain', 5, 10, pack=1),
      span('h2d_transfer', 12, 3, pack=2),
      span('device_compute', 20, 30, pack=2, bucket=100, n_rows=4),
      span('finalize_drain', 25, 30, pack=2),
      span('device_compute', 60, 5, pack=3, bucket=200, n_rows=2),
      span('featurize', 0, 100, n_zmws=2),
  ]
  port = torch_summarize.summarize(events)
  assert port == jax_summarize.summarize(events)
  assert torch_summarize.device_gaps(events) == jax_summarize.device_gaps(
      events)
  bad = tmp_path / 'bad.jsonl'
  bad.write_text('[\n{"name": "x", "ph": "X", "ts": 0\n')
  for lib, error in ((torch_summarize, faults.CorruptInputError),
                     (jax_summarize, Exception)):
    with pytest.raises(error, match='undecodable trace event'):
      lib.load_trace(str(bad))
  with pytest.raises(faults.CorruptInputError, match='no complete'):
    torch_summarize.summarize([])


def test_metrics_registry_matches_jax():
  regs = [torch_metrics.MetricsRegistry(tier='run'),
          jax_metrics.MetricsRegistry(tier='run')]
  rng = np.random.default_rng(5)
  values = rng.exponential(0.05, 200).tolist() + [0.0, 700.0]
  for reg in regs:
    reg.inc('n_packs', 3)
    reg.counter('n_windows', help='windows').inc(17)
    reg.set_gauge('overlap', 0.25)
    for v in values:
      reg.observe('stage_featurize_s', v)
    reg.histogram('sizes', bounds=(1, 10, 100)).observe(50)
  port, ref = regs
  assert port.snapshot() == ref.snapshot()
  assert port.latency_summary() == ref.latency_summary()
  assert port.to_prom() == ref.to_prom()
  assert port.to_prom(tier='') == ref.to_prom(tier='')
  assert port.counter_values() == ref.counter_values()
  counters = {'n_zmw_quarantined': 2, 'partial': True, 'label': 'x',
              'model_seconds': 0.5, 'bad-name': 1}
  assert torch_metrics.prom_counters_text(counters, tier='run') == (
      jax_metrics.prom_counters_text(counters, tier='run'))
  hist = port.histogram('stage_featurize_s')
  assert hist.percentile(1.0) == 600.0  # +Inf bucket reports the last edge
  with pytest.raises(ValueError):
    torch_metrics.Histogram('empty', port._lock, bounds=())


def test_trace_writer_shares_one_file(tmp_path):
  path = str(tmp_path / 'shared.jsonl')
  first = torch_trace.TraceWriter(path, tier='run')
  second = torch_trace.TraceWriter(path)
  first.complete_event('featurize', 'stage', 1.0, 0.5, {'n_zmws': 2})
  second.complete_event('stitch', 'stage', 2.0, -1.0)
  first.close()
  second.close()
  with open(path) as f:
    lines = f.read().splitlines()
  assert lines[0] == '[' and lines.count('[') == 1
  events = torch_summarize.load_trace(path)
  assert [e['name'] for e in events] == ['process_name', 'featurize',
                                         'stitch']
  assert events[1]['ts'] == 1e6 and events[1]['dur'] == 5e5
  assert events[2]['dur'] == 0.0
  assert events == jax_summarize.load_trace(path)
  try:
    torch_trace.configure(str(tmp_path / 'span.jsonl'))
    torch_trace.set_trace_id('abc')
    with torch_trace.span('stitch', n_zmws=1):
      pass
    obs.record_stage(None, 'pack_wait', 3.0, 3.5, bucket=100)
  finally:
    torch_trace.set_trace_id(None)
    torch_trace.configure(None)
  assert not torch_trace.enabled()
  spans = torch_summarize.load_trace(str(tmp_path / 'span.jsonl'))
  assert [(e['name'], e['args']) for e in spans] == [
      ('stitch', {'n_zmws': 1, 'trace_id': 'abc'}),
      ('pack_wait', {'bucket': 100, 'trace_id': 'abc'})]
  assert len(torch_trace.mint_trace_id()) == 16
  torch_trace.complete_event('stitch', 'stage', 0, 1)  # off: a no-op


def test_cli_trace_prints_the_summary(traced, tmp_path, capsys):
  path = traced[0]
  assert cli.main(['trace', path, '--json', '--top', '1']) == 0
  got = json.loads(capsys.readouterr().out)
  want = json.loads(json.dumps(torch_summarize.summarize(
      torch_summarize.load_trace(path))))
  assert len(got['stragglers']) == min(1, len(want['stragglers']))
  want['stragglers'] = want['stragglers'][:1]
  assert got == want
  assert cli.main(['trace', path]) == 0
  assert capsys.readouterr().out.startswith('trace: ')
  bad = tmp_path / 'corrupt.jsonl'
  bad.write_text('[\nnot json,\n')
  assert cli.main(['trace', str(bad)]) == 2
  assert 'undecodable trace event' in capsys.readouterr().err
