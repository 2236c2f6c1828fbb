"""The port's `validate` (io/validate.py) and FASTA/FASTQ readers
(io/fastx.py) vs the JAX package's, on the CPU.

validate_inputs' reports on a clean BAM pair, a truncated subreads or
CCS BAM, each record-level corruption of testing/faults.py, a pair
whose CCS BAM comes from other molecules, and clean, bit-flipped and
truncated TFRecord shards equal the JAX package's; `cli validate`
exits 0 / 1, locates the damage and writes --report. The readers parse
good files and raise the same typed errors on bad ones.
"""
import gzip
import json
import os
import shutil

import pytest

from deepconsensus_tpu.io import fastx as jax_fastx
from deepconsensus_tpu.io import validate as jax_validate
from deepconsensus_tpu_torch import cli
from deepconsensus_tpu_torch.faults import CorruptInputError
from deepconsensus_tpu_torch.io import fastx as torch_fastx
from deepconsensus_tpu_torch.io import validate as torch_validate
from deepconsensus_tpu_torch.testing import faults as fault_files
from deepconsensus_tpu_torch.testing import synthetic


@pytest.fixture(scope='module')
def pair(tmp_path_factory):
  return synthetic.write_synthetic_zmw_bams(
      str(tmp_path_factory.mktemp('pair')), n_zmws=6, n_subreads=3,
      seq_len=150, seed=5)


@pytest.fixture(scope='module')
def other_pair(tmp_path_factory):
  return synthetic.write_synthetic_zmw_bams(
      str(tmp_path_factory.mktemp('other')), n_zmws=4, n_subreads=3,
      seq_len=150, seed=6, movie='m99999_000000_000000')


@pytest.fixture(scope='module')
def shards(tmp_path_factory):
  out = str(tmp_path_factory.mktemp('shards'))
  synthetic.write_synthetic_tfrecords(out, n_shards=1, n_examples=6,
                                      max_passes=20, max_length=100)
  return sorted(os.path.join(out, n) for n in os.listdir(out))


def _both(**kw):
  port = torch_validate.validate_inputs(**kw)
  ref = jax_validate.validate_inputs(**kw)
  assert port == ref
  return port


def test_clean_pair_passes(pair):
  report = _both(subreads_to_ccs=pair[0], ccs_bam=pair[1])
  assert report['ok'] and report['n_errors'] == 0
  assert report['pair'] == {'checked': True, 'ok': True, 'errors': []}
  assert [f['n_records'] for f in report['files']] == [18, 6]


@pytest.mark.parametrize('which', [0, 1])
def test_truncated_bam_is_located(pair, tmp_path, which):
  paths = list(pair)
  paths[which] = str(tmp_path / os.path.basename(pair[which]))
  shutil.copy(pair[which], paths[which])
  fault_files.truncate_file(paths[which], fraction=0.6)
  report = _both(subreads_to_ccs=paths[0], ccs_bam=paths[1])
  assert not report['ok']
  bad = report['files'][which]
  # Located: the file, and the records read before the damage.
  assert not bad['bgzf_eof'] and bad['errors']
  assert all(e['file'] == paths[which] for e in bad['errors'])
  assert bad['n_records'] < (18, 6)[which]


@pytest.mark.parametrize('mode', fault_files.BAM_RECORD_MODES)
def test_corrupted_record_is_reported(pair, tmp_path, mode):
  bad = str(tmp_path / 'subreads.bam')
  offset = fault_files.corrupt_bam_record(pair[0], bad, 4, mode)
  report = _both(subreads_to_ccs=bad, ccs_bam=pair[1])
  assert not report['ok']
  entry = report['files'][0]
  assert entry['n_corrupt_records'] >= 1
  assert entry['errors'][0]['offset'] is not None
  if mode == 'block_size_inflate':
    assert entry['errors'][0]['offset'] == offset
    assert not entry['errors'][0]['recoverable']


def test_mismatched_pair_is_reported(pair, other_pair):
  report = _both(subreads_to_ccs=pair[0], ccs_bam=other_pair[1])
  assert not report['ok'] and not report['pair']['ok']
  assert all('absent from the ccs BAM' in e['error']
             for e in report['pair']['errors'])


def test_tfrecords_clean_flipped_and_truncated(shards, tmp_path):
  assert _both(tfrecords=shards)['ok']
  flipped = str(tmp_path / 'flipped.tfrecord')
  with gzip.open(shards[0], 'rb') as f:
    raw = bytearray(f.read())
  raw[40] ^= 0xFF
  with open(flipped, 'wb') as f:
    f.write(bytes(raw))
  truncated = str(tmp_path / 'truncated.tfrecord.gz')
  shutil.copy(shards[0], truncated)
  fault_files.truncate_file(truncated, fraction=0.5)
  report = _both(tfrecords=[flipped, truncated])
  assert not report['ok']
  assert [f['ok'] for f in report['files']] == [False, False]
  assert report['files'][0]['errors'][0]['file'] == flipped


def test_cli_validate_exit_codes_and_report(pair, tmp_path, capsys):
  report = str(tmp_path / 'report.json')
  assert cli.main(['validate', '--subreads_to_ccs', pair[0], '--ccs_bam',
                   pair[1], '--report', report]) == 0
  printed = json.loads(capsys.readouterr().out)
  with open(report) as f:
    assert json.load(f) == printed and printed['ok']
  truncated = str(tmp_path / 'subreads.bam')
  shutil.copy(pair[0], truncated)
  fault_files.truncate_file(truncated, fraction=0.5)
  assert cli.main(['validate', '--subreads_to_ccs', truncated,
                   '--ccs_bam', pair[1]]) == 1
  printed = json.loads(capsys.readouterr().out)
  errors = printed['files'][0]['errors']
  assert errors and errors[0]['file'] == truncated
  assert 'truncated' in errors[0]['error']
  assert printed['files'][0]['n_records'] < 18
  with pytest.raises(ValueError, match='validate needs'):
    cli.main(['validate'])


FASTQ_CASES = {
    'good': '@r1\nACGT\n+\nIIII\n@r2\nGG\n+r2\n##\n',
    'no_at': 'r1\nACGT\n+\nIIII\n',
    'bad_plus': '@r1\nACGT\n-\nIIII\n',
    'lengths': '@r1\nACGT\n+\nIII\n',
    'truncated': '@r1\nACGT\n+\n',
}
FASTA_CASES = {
    'good': '>a desc\nACGT\nTT\n>b\n\n>c\nG\n',
    'no_name': '>\nACGT\n',
    'before_header': 'ACGT\n>a\nA\n',
}


def _outcome(fn, path):
  try:
    result = fn(path)
    return 'ok', list(result.items()) if isinstance(result, dict) else list(
        result)
  except CorruptInputError as e:
    return 'error', (str(e), e.offset)
  except Exception as e:  # the JAX package's CorruptInputError
    return 'error', (str(e), getattr(e, 'offset', None))


@pytest.mark.parametrize('gz', [False, True])
@pytest.mark.parametrize('kind, case', [
    *(('fastq', c) for c in FASTQ_CASES), *(('fasta', c) for c in FASTA_CASES)])
def test_readers_match_jax(tmp_path, kind, case, gz):
  text = (FASTQ_CASES if kind == 'fastq' else FASTA_CASES)[case]
  path = str(tmp_path / (f'in.{kind}' + ('.gz' if gz else '')))
  with (gzip.open(path, 'wt') if gz else open(path, 'w')) as f:
    f.write(text)
  name = 'read_fastq' if kind == 'fastq' else 'read_fasta'
  port = _outcome(getattr(torch_fastx, name), path)
  assert port == _outcome(getattr(jax_fastx, name), path)
  assert port[0] == ('ok' if case == 'good' else 'error')


def test_corrupt_gzip_raises_a_typed_error(tmp_path):
  path = str(tmp_path / 'bad.fasta.gz')
  with gzip.open(path, 'wt') as f:
    f.write('>a\n' + 'ACGT' * 5000 + '\n')
  fault_files.truncate_file(path, fraction=0.5)
  with pytest.raises(CorruptInputError, match='corrupt or truncated'):
    torch_fastx.read_fasta(path)
