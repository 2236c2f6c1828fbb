"""The port's native BGZF / TFRecord library vs the Python paths and the
JAX package's native module.

The library builds from deepconsensus_tpu_torch/native/bgzf.cpp into
build/native/ at first use (g++ and zlib, as the reference builds its
own). On seeded synthetic BAMs and TFRecord shards: native BGZF
records equal the gzip path's, crc32c equals the JAX package's native
crc32c and the table-driven CRC, native TFRecord records equal the
streaming reader's; on the corrupt cases of tests/test_native.py the
native path never accepts what the Python path rejects, and the
readers fall back to typed errors.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from deepconsensus_tpu import native as jax_native
from deepconsensus_tpu_torch import native
from deepconsensus_tpu_torch.faults import CorruptInputError
from deepconsensus_tpu_torch.io import bam, tfrecord
from deepconsensus_tpu_torch.io.bam_writer import BgzfWriter
from deepconsensus_tpu_torch.models import config as torch_config
from deepconsensus_tpu_torch.models import data as data_lib
from deepconsensus_tpu_torch.testing import synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def lib():
  lib = native.get_lib()
  assert lib is not None, 'the native library did not build'
  return lib


@pytest.fixture(scope='module')
def bams(tmp_path_factory):
  return synthetic.write_synthetic_zmw_bams(
      str(tmp_path_factory.mktemp('bams')), n_zmws=6, n_subreads=4,
      seq_len=420, seed=11, smart_windows=True)


def test_library_builds_under_build_native(lib):
  path = native.library_path()
  assert path.parent == native.BUILD_DIR
  assert os.path.relpath(path, REPO).startswith(os.path.join('build',
                                                             'native'))
  assert path.exists() and path.name.startswith('libdcnative-')
  here = os.path.dirname(native.__file__)
  assert sorted(os.listdir(here)) in (
      ['__init__.py', 'bgzf.cpp'], ['__init__.py', '__pycache__', 'bgzf.cpp'])


@pytest.mark.parametrize('data', [
    b'', b'123456789', b'\x00' * 100, bytes(range(256)) * 7,
    np.random.default_rng(0).bytes(100_003)])
def test_crc32c_matches_jax_native_and_python(lib, data):
  got = native.crc32c(data)
  assert got == tfrecord._crc32c_py(data)
  want = jax_native.crc32c(data)
  if want is not None:
    assert got == want
  assert tfrecord.crc32c(data) == got
  assert native.crc32c(data, 12345) == tfrecord._crc32c_py(data, 12345)


def _records(path, use_native):
  reader = bam.BamReader(path, use_native=use_native)
  with reader:
    recs = list(reader)
  return reader, recs


@pytest.mark.parametrize('which', [0, 1])
def test_bgzf_native_records_equal_gzip_path(lib, bams, which):
  nat, native_recs = _records(bams[which], True)
  py, python_recs = _records(bams[which], False)
  assert (nat.decoder, py.decoder) == ('native', 'python')
  assert nat.header_text == py.header_text
  assert len(native_recs) == len(python_recs) > 5
  for a, b in zip(native_recs, python_recs):
    assert a.qname == b.qname and a.flag == b.flag
    np.testing.assert_array_equal(a.seq, b.seq)
    np.testing.assert_array_equal(a.quals, b.quals)
    np.testing.assert_array_equal(a.cigar_ops, b.cigar_ops)
    assert a.tags.keys() == b.tags.keys()


def test_bgzf_roundtrip_and_max_out(lib, tmp_path):
  path = str(tmp_path / 'data.bgzf')
  payload = bytes(range(256)) * 1000
  with BgzfWriter(path) as w:
    w.write(payload)
  assert native.bgzf_decompress_file(path) == payload
  assert bam.bgzf_decompress_file_py(path) == payload
  assert native.bgzf_decompress_file(path, max_out=1024) is None
  assert native.bgzf_decompress_file(path, max_out=len(payload)) == payload
  with pytest.raises(CorruptInputError):
    bam.bgzf_decompress_file_py(path, max_out=1024)


def test_bgzf_corrupt_input_parity(lib, tmp_path, scripts_importable):
  """Mutated BGZF files: the native path never accepts (or decodes
  differently) what the Python path rejects, and it agrees with the
  JAX package's native decoder on every mutant."""
  from scripts import inject_faults

  src_path = str(tmp_path / 'seed.bgzf')
  with BgzfWriter(src_path) as w:
    w.write(np.random.RandomState(3).bytes(150_000))
  with open(src_path, 'rb') as f:
    src = f.read()
  mutant = str(tmp_path / 'mutant.bgzf')
  n_py_rejects = 0
  check_jax = jax_native.get_lib() is not None
  for i, mode, data in inject_faults.fuzz_mutants(src, 200, seed=99):
    with open(mutant, 'wb') as f:
      f.write(data)
    try:
      py_out = bam.bgzf_decompress_file_py(mutant)
    except CorruptInputError:
      py_out = None
      n_py_rejects += 1
    native_out = native.bgzf_decompress_file(mutant)
    if py_out is None:
      assert native_out is None, f'mutant {i} ({mode}): native accepted'
    elif native_out is not None:
      assert native_out == py_out, f'mutant {i} ({mode}): bytes differ'
    if check_jax:
      assert native_out == jax_native.bgzf_decompress_file(mutant), i
  assert n_py_rejects > 0


def test_bam_reader_falls_back_on_corrupt_bgzf(lib, bams, tmp_path):
  with open(bams[1], 'rb') as f:
    data = bytearray(f.read())
  data[len(data) // 2] ^= 0xFF
  path = str(tmp_path / 'corrupt.bam')
  with open(path, 'wb') as f:
    f.write(data)
  reader = bam.BamReader(path)  # the header block is intact
  assert reader.decoder == 'python'
  with pytest.raises(CorruptInputError):
    list(reader)


def _shard(tmp_path, name, compression, payloads):
  path = str(tmp_path / name)
  with tfrecord.TFRecordWriter(path, compression=compression) as w:
    for p in payloads:
      w.write(p)
  return path


@pytest.mark.parametrize('compression,name', [
    (None, 'plain.tfrecord'), ('GZIP', 'gzip.tfrecord.gz'),
    ('BGZF', 'bgzf.tfrecord.gz')])
def test_native_tfrecord_records_equal_python_reader(lib, tmp_path,
                                                     compression, name):
  rng = np.random.default_rng(4)
  payloads = [rng.bytes(int(n)) for n in rng.integers(0, 70_000, 40)]
  path = _shard(tmp_path, name, compression, payloads)
  records = native.read_tfrecord_records(path,
                                         compressed=compression is not None)
  assert records == payloads
  reader = tfrecord.TFRecordReader(path, native_decode=True)
  assert list(reader) == payloads and reader.decoder == 'native'
  assert list(reader) == []  # single pass on every path
  streaming = tfrecord.TFRecordReader(path, check_crc=True)
  assert list(streaming) == payloads and streaming.decoder == 'python'
  jax_records = jax_native.read_tfrecord_records(
      path, compressed=compression is not None)
  if jax_records is not None:
    assert records == jax_records


def test_tfrecord_corrupt_native_falls_back_to_typed_error(lib, tmp_path):
  path = _shard(tmp_path, 'shard.tfrecord', None,
                [b'payload-a', b'payload-b'])
  with open(path, 'r+b') as f:
    f.write((1 << 50).to_bytes(8, 'little'))  # inflate the first length
  assert native.read_tfrecord_records(path, compressed=False) is None
  with pytest.raises(CorruptInputError):
    list(tfrecord.TFRecordReader(path, native_decode=True))


def test_native_tfrecord_validates_length_crc(lib, tmp_path):
  path = _shard(tmp_path, 'shard.tfrecord', None, [b'x' * 100, b'y' * 100])
  with open(path, 'r+b') as f:
    f.write((5).to_bytes(8, 'little'))  # plausible but CRC-stale length
  assert native.read_tfrecord_records(path, compressed=False) is None
  with pytest.raises(CorruptInputError):
    list(tfrecord.TFRecordReader(path, native_decode=True))


def test_training_loader_reads_through_native(lib, tmp_path, monkeypatch):
  shards = synthetic.write_synthetic_tfrecords(
      str(tmp_path / 'shards'), n_shards=2, n_examples=12, max_passes=20,
      max_length=100, seed=5)
  params = torch_config.get_config('transformer_learn_values+test')
  torch_config.finalize_params(params)
  calls = []
  decode = native.read_tfrecord_records

  def counting(path, **kw):
    calls.append(path)
    return decode(path, **kw)

  monkeypatch.setattr(native, 'read_tfrecord_records', counting)
  got = data_lib.DatasetIterator(str(tmp_path / 'shards' / '*'), params,
                                 batch_size=4)
  assert sorted(calls) == sorted(shards)
  monkeypatch.setenv('DC_TPU_NO_NATIVE', '1')
  want = data_lib.DatasetIterator(str(tmp_path / 'shards' / '*'), params,
                                  batch_size=4)
  np.testing.assert_array_equal(got.rows, want.rows)
  np.testing.assert_array_equal(got.labels, want.labels)


def test_python_decoder_is_recorded(bams, tmp_path):
  """With the library switched off, a run still decodes, and its
  sidecar says it took the Python decoder."""
  code = (
      'import json, sys\n'
      'from deepconsensus_tpu_torch.preprocess import feeder\n'
      'from deepconsensus_tpu_torch.preprocess.pileup import FeatureLayout\n'
      'feed, _ = feeder.create_proc_feeder(sys.argv[1], sys.argv[2],\n'
      '                                    layout=FeatureLayout(20, 100))\n'
      'print(json.dumps([feed.bam_decoder, sum(1 for _ in feed())]))\n')
  env = dict(os.environ, PYTHONPATH=REPO, DC_TPU_NO_NATIVE='1')
  proc = subprocess.run([sys.executable, '-c', code, *bams], env=env,
                        cwd=REPO, capture_output=True, text=True,
                        timeout=120)
  assert proc.returncode == 0, proc.stderr
  assert proc.stdout.strip() == '["python", 6]'
