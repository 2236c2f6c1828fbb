"""The port's `preprocess` (training mode: truth labels) vs the JAX
package's, on the CPU.

16 seeded synthetic ZMWs (4 subreads of 400 bases, seeded `wl` smart
windows of 60-200) and their synthetic truth (testing/synthetic.py
`write_synthetic_truth`: every split and every label fault of the feeder
occurs) go through `cli preprocess` of the port and through
deepconsensus_tpu.preprocess.driver.run_preprocess. Exact throughout:

* the TFRecord shards and the summary JSON byte for byte, serially and
  with --cpus 2 (the pool's order is the feeder's), with smart windows,
  under --shard / --limit, and with fixed windows in single-member gzip
  (there but for the gzip header's time of writing, which both
  packages' writers stamp);
* each window's `to_example()` bytes, in training and inference mode;
* the truth readers and the feeder's per-ZMW counters and splits.

The pool leaves no child process behind; the CLI asks for the card
unless --device cpu is given.
"""
import glob
import gzip
import json
import multiprocessing
import os

import pytest
import torch

from deepconsensus_tpu.preprocess import driver as jax_driver
from deepconsensus_tpu.preprocess import feeder as jax_feeder
from deepconsensus_tpu.preprocess import pileup as jax_pileup
from deepconsensus_tpu_torch import cli
from deepconsensus_tpu_torch.preprocess import feeder as torch_feeder
from deepconsensus_tpu_torch.preprocess import pileup as torch_pileup
from deepconsensus_tpu_torch.testing import synthetic

N_ZMWS, MAX_PASSES = 16, 5


@pytest.fixture(scope='module')
def inputs(tmp_path_factory):
  root = tmp_path_factory.mktemp('preprocess')
  bams = synthetic.write_synthetic_zmw_bams(
      str(root / 'bams'), n_zmws=N_ZMWS, n_subreads=4, seq_len=400, seed=5,
      smart_windows=True)
  truth = synthetic.write_synthetic_truth(bams[1], str(root / 'truth'))
  return {'subreads_to_ccs': bams[0], 'ccs_bam': bams[1],
          'truth_to_ccs': truth[0], 'truth_bed': truth[1],
          'truth_split': truth[2], 'root': root}


def truth_kwargs(inputs):
  return {k: inputs[k] for k in ('subreads_to_ccs', 'ccs_bam',
                                 'truth_to_ccs', 'truth_bed',
                                 'truth_split')}


def cli_args(kwargs):
  out = []
  for k, v in kwargs.items():
    if v is True:
      out.append(f'--{k}')
    elif v is not None:
      out += [f'--{k}', str(v)]
  return out


def same_bytes(a, b, gzip_mtime=False):
  """Whether two files hold the same bytes; gzip_mtime: single-member
  gzip files, whose header carries the time of writing (bytes 4-7) in
  both packages' writers, compared apart from it."""
  with open(a, 'rb') as fa, open(b, 'rb') as fb:
    x, y = fa.read(), fb.read()
  if gzip_mtime and a.endswith('.gz'):
    return (x[:4] + x[8:10] == y[:4] + y[8:10]
            and gzip.decompress(x) == gzip.decompress(y))
  return x == y


def assert_same_tree(got_dir, want_dir, gzip_mtime=False):
  want = sorted(os.path.relpath(p, want_dir) for p in glob.glob(
      os.path.join(want_dir, '**', '*'), recursive=True)
                if os.path.isfile(p))
  got = sorted(os.path.relpath(p, got_dir) for p in glob.glob(
      os.path.join(got_dir, '**', '*'), recursive=True)
               if os.path.isfile(p))
  assert got == want and want
  for rel in want:
    assert same_bytes(os.path.join(got_dir, rel),
                      os.path.join(want_dir, rel), gzip_mtime), rel


CASES = {
    # name: (cli flags, run_preprocess kwargs beyond the inputs)
    'smart_serial': ({'use_ccs_smart_windows': True}, {}),
    'smart_cpus2': ({'use_ccs_smart_windows': True, 'cpus': 2}, {}),
    'fixed_gzip_width_120': ({'compression': 'gzip', 'example_width': 120},
                             {}),
    'shard_1_of_2_limit_5': ({'use_ccs_smart_windows': True, 'shard': '1/2',
                              'limit': 5}, {'shard': (1, 2)}),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_cli_preprocess_matches_jax(inputs, tmp_path, case):
  """The port's shards and summary equal the JAX package's byte for
  byte; the port's pool (--cpus 2) against the JAX package's serial
  run, whose order the pool must keep."""
  flags, jax_extra = CASES[case]
  kwargs = dict(truth_kwargs(inputs), max_passes=MAX_PASSES)
  jax_kwargs = dict(kwargs, **{k: v for k, v in flags.items()
                               if k not in ('cpus', 'shard')}, **jax_extra)
  if 'compression' in jax_kwargs:
    jax_kwargs['compression'] = jax_kwargs['compression'].upper()
  want_dir, got_dir = str(tmp_path / 'jax'), str(tmp_path / 'port')
  summary = jax_driver.run_preprocess(
      output=os.path.join(want_dir, '@split', '@split.tfrecord.gz'),
      **jax_kwargs)
  assert cli.main(['preprocess', '--output', os.path.join(
      got_dir, '@split', '@split.tfrecord.gz'), '--device', 'cpu',
                   *cli_args(dict(kwargs, **flags))]) == 0
  assert_same_tree(got_dir, want_dir,
                   gzip_mtime=flags.get('compression') == 'gzip')
  with open(os.path.join(got_dir, 'summary',
                         'summary.summary.training.json')) as f:
    assert json.load(f) == json.loads(json.dumps(summary))
  assert not multiprocessing.active_children()
  if case != 'shard_1_of_2_limit_5':
    for split in ('train', 'eval', 'test'):
      assert summary[f'n_examples_{split}'] > 0, split
    for key in ('n_zmw_missing_truth_range', 'n_zmw_no_label_alignment',
                'n_zmw_truth_label_supp_alignment',
                'n_zmw_missing_contig_split'):
      assert summary[key] == N_ZMWS // 16, key


def window_bytes(pkg_feeder, pkg_pileup, inputs, training, smart):
  kwargs = truth_kwargs(inputs) if training else {
      k: inputs[k] for k in ('subreads_to_ccs', 'ccs_bam')}
  feed, counter = pkg_feeder.create_proc_feeder(
      layout=pkg_pileup.FeatureLayout(MAX_PASSES, 100),
      use_ccs_smart_windows=smart, **kwargs)
  out = []
  for subreads, name, layout, split, widths in feed():
    pileup = pkg_feeder.reads_to_pileup(subreads, name, layout, widths)
    out.append((split, [w.to_example().serialize()
                        for w in pileup.iter_windows()],
                dict(pileup.counter)))
  return out, dict(counter)


@pytest.mark.parametrize('training,smart', [(True, True), (True, False),
                                            (False, True)])
def test_to_example_per_window_matches_jax(inputs, training, smart):
  got, got_counter = window_bytes(torch_feeder, torch_pileup, inputs,
                                  training, smart)
  want, want_counter = window_bytes(jax_feeder, jax_pileup, inputs,
                                    training, smart)
  assert got == want
  assert got_counter == want_counter
  assert sum(len(w) for _, w, _ in got) > 0
  splits = {s for s, _, _ in got}
  assert splits == ({'train', 'eval', 'test'} if training
                    else {'inference'})


def test_truth_readers_match_jax(inputs, tmp_path):
  assert (torch_feeder.read_truth_bedfile(inputs['truth_bed'])
          == jax_feeder.read_truth_bedfile(inputs['truth_bed']))
  assert (torch_feeder.read_truth_split(inputs['truth_split'])
          == jax_feeder.read_truth_split(inputs['truth_split']))
  unknown = tmp_path / 'split.tsv'
  unknown.write_text('ctg0\t1\n')
  for pkg in (torch_feeder, jax_feeder):
    with pytest.raises(ValueError, match='known genome'):
      pkg.read_truth_split(str(unknown))


def test_cli_preprocess_asks_for_the_card_and_for_split(inputs, tmp_path,
                                                        monkeypatch):
  argv = ['preprocess', *cli_args(truth_kwargs(inputs))]
  with pytest.raises(ValueError, match='@split'):
    cli.main(argv + ['--output', str(tmp_path / 'x.tfrecord.gz'),
                     '--device', 'cpu'])
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='no CUDA device'):
    cli.main(argv + ['--output', str(tmp_path / '@split.tfrecord.gz')])
  assert not os.path.exists(tmp_path / 'train.tfrecord.gz')
