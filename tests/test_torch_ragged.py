"""The PyTorch port's ragged-slot path vs the JAX package's.

Windows of widths 100 and 200 pack back to back into slots of 200
positions with a per-slot lengths row. The same seeded numpy inputs go
through both packages:

* slot geometry and the ragged attention mask: exact;
* K4 (ragged embed-condense-attention): the port's plain version vs the
  JAX `reference_ragged_forward` and its Pallas kernel in interpret
  mode, float32 atol 1e-5, at every slot composition (uniform 100,
  uniform 200, 200 beside 100+100, partial and empty slots);
* K2 with lengths: plain vs `reference_encoder_stack(lengths=)` and
  the interpret-mode kernel, atol 1e-5;
* the model's ragged forward, fused route (plain versions) and module
  route, vs `apply(..., window_lengths=)` with the fused hot path on
  and off, atol 1e-5, on a weight tree bridged with window_buckets set;
* the slot packer's plans, packs and lengths vs the JAX
  `_RaggedPacker`, exact, on a seeded mixed-width stream;
* featurized windows on `wl`-tagged BAMs with buckets (100, 200):
  identical;
* `run_inference` FASTQ vs the JAX package's ragged run: ids identical,
  qualities within 1, both widths served; and `cli run` with the three
  flags on the CPU.

The kernels' own comparisons with these plain versions on the card are
in tests/test_torch_gpu.py and chip_smoke.py.
"""
import json
import types

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepconsensus_tpu.calibration import lib as jax_calibration
from deepconsensus_tpu.inference import engine as jax_engine
from deepconsensus_tpu.inference import runner as jax_runner
from deepconsensus_tpu.models import config as jax_config
from deepconsensus_tpu.models import model as jax_model
from deepconsensus_tpu.ops import fused_encoder_block as jax_feb
from deepconsensus_tpu.ops import fused_window_attention as jax_fwa
from deepconsensus_tpu.ops import ragged_window_attention as jax_rwa
from deepconsensus_tpu.preprocess import FeatureLayout as JaxLayout
from deepconsensus_tpu.preprocess import create_proc_feeder as jax_feeder
from deepconsensus_tpu_torch import cli
from deepconsensus_tpu_torch.inference import engine as torch_engine
from deepconsensus_tpu_torch.inference import runner as torch_runner
from deepconsensus_tpu_torch.models import config as torch_config
from deepconsensus_tpu_torch.models import model as torch_model
from deepconsensus_tpu_torch.models import weights as weights_lib
from deepconsensus_tpu_torch.ops import fused_encoder_block as feb
from deepconsensus_tpu_torch.ops import ragged_window_attention as rwa
from deepconsensus_tpu_torch.preprocess import feeder as torch_feeder
from deepconsensus_tpu_torch.preprocess.pileup import FeatureLayout
from deepconsensus_tpu_torch.testing import synthetic

BUCKETS = torch_config.DEFAULT_WINDOW_BUCKETS
SLOT = BUCKETS[-1]
SMALL = dict(dtype='float32', num_hidden_layers=2, filter_size=64)
HIDDEN, HEADS, BAND, FILTER = 280, 2, 12, 64
# Per-slot window widths of one pack; [] is an empty slot.
COMPOSITIONS = {
    'uniform_100': [[100, 100], [100, 100]],
    'uniform_200': [[200], [200]],
    'mixed': [[200], [100, 100]],
    'partial': [[100], [200]],
    'empty': [[100, 100], []],
}


def jax_params(**overrides):
  params = jax_config.get_config('transformer_learn_values+test')
  jax_config.finalize_params(params, is_training=False)
  with params.unlocked():
    for k, v in {**SMALL, 'window_buckets': BUCKETS, **overrides}.items():
      params[k] = v
  return params


def torch_params(**overrides):
  params = torch_config.get_config('transformer_learn_values+test')
  torch_config.finalize_params(params)
  params.update({**SMALL, 'window_buckets': list(BUCKETS), **overrides})
  return params


def window_rows(params, width, rng):
  """[R, width] pileup rows in the model's value ranges, SN constant
  across the window (as the featurizer emits them)."""
  mp = params.max_passes
  rows = np.zeros((params.total_rows, width), np.float32)
  rows[:mp] = rng.integers(0, 5, (mp, width))
  rows[mp:3 * mp] = rng.integers(0, 256, (2 * mp, width))
  rows[3 * mp:4 * mp] = rng.integers(0, 3, (mp, width))
  rows[4 * mp] = rng.integers(0, 5, width)
  rows[4 * mp + 1:] = rng.integers(0, 501, (4, 1))
  return rows


def pack(params, composition, seed):
  """(rows [n_slots, R, SLOT], lengths [n_slots, 2]) for per-slot
  widths; pad positions are zero."""
  rng = np.random.default_rng(seed)
  rows = np.zeros((len(composition), params.total_rows, SLOT), np.float32)
  lengths = np.zeros((len(composition), SLOT // BUCKETS[0]), np.int32)
  for s, widths in enumerate(composition):
    off = 0
    for j, w in enumerate(widths):
      rows[s, :, off:off + w] = window_rows(params, w, rng)
      lengths[s, j] = w
      off += w
  return rows, lengths


@pytest.mark.parametrize('name', sorted(COMPOSITIONS))
def test_slot_geometry_and_mask_match_jax(name):
  _, lengths = pack(jax_params(), COMPOSITIONS[name], 0)
  want = jax_rwa.slot_geometry(jnp.asarray(lengths), SLOT)
  got = rwa.slot_geometry(torch.from_numpy(lengths), SLOT)
  for g, w in zip(got, want):
    np.testing.assert_array_equal(g.numpy(), np.asarray(w))
  np.testing.assert_array_equal(
      rwa.ragged_attention_mask(torch.from_numpy(lengths), SLOT, BAND).numpy(),
      np.asarray(jax_rwa.ragged_attention_mask(jnp.asarray(lengths), SLOT,
                                               BAND)))


def test_bucket_helpers_match_jax():
  assert BUCKETS == jax_config.DEFAULT_WINDOW_BUCKETS
  for spec in [None, (), '100,200', (100, 200), [100]]:
    assert torch_config.normalize_window_buckets(spec, 100) == (
        jax_config.normalize_window_buckets(spec, 100))
  for spec, match in [((100, 0), 'positive'), ((200, 100), 'ascending'),
                      ((50, 100), 'max_length')]:
    with pytest.raises(ValueError, match=match):
      torch_config.normalize_window_buckets(spec, 100)
  assert torch_config.resolve_window_buckets(torch_params()) == BUCKETS
  for width in (1, 100, 101, 200, 201):
    assert torch_config.bucket_for(width, BUCKETS) == jax_config.bucket_for(
        width, BUCKETS)


def test_validate_ragged_buckets_matches_jax():
  for good in [(100,), (100, 200), (50, 100, 200)]:
    assert rwa.validate_ragged_buckets(good) == (
        jax_rwa.validate_ragged_buckets(good))
    assert rwa.windows_per_slot(good) == jax_rwa.windows_per_slot(good)
  for bad, match in [((), 'positive'), ((200, 100), 'ascending'),
                     ((100, 150), 'divisibility chain')]:
    with pytest.raises(ValueError, match=match):
      rwa.validate_ragged_buckets(bad)


def k4_inputs(params, rng):
  specs, keys, cond_in = jax_fwa.build_family_specs(params)
  tables = {k: rng.normal(0, 0.5, (next(
      s.vocab for s in specs if s.table_idx == i), next(
      s.width for s in specs if s.table_idx == i))).astype(np.float32)
            for i, k in enumerate(keys)}
  weights = [rng.normal(0, 0.05, shape).astype(np.float32) for shape in
             [(cond_in, HIDDEN)] + [(HIDDEN, HIDDEN)] * 4]
  pos = jax_model.sinusoidal_position_encoding(SLOT, HIDDEN)
  return tables, weights, pos, specs, keys


@pytest.mark.parametrize('name', sorted(COMPOSITIONS))
def test_k4_plain_matches_jax(name):
  params = jax_params()
  rows, lengths = pack(params, COMPOSITIONS[name], 1)
  tables, weights, pos, specs, keys = k4_inputs(
      params, np.random.default_rng(2))
  kw = dict(specs=specs, table_keys=keys, num_heads=HEADS,
            attn_win_size=BAND)
  got = rwa.ragged_embed_condense_attention(
      torch.from_numpy(rows), torch.from_numpy(lengths),
      {k: torch.from_numpy(v) for k, v in tables.items()},
      *map(torch.from_numpy, weights), torch.from_numpy(pos), **kw)
  jargs = (jnp.asarray(rows), jnp.asarray(lengths),
           {k: jnp.asarray(v) for k, v in tables.items()},
           *map(jnp.asarray, weights), jnp.asarray(pos))
  ref = jax_rwa.reference_ragged_forward(*jargs, **kw)
  pallas = jax_rwa.ragged_embed_condense_attention(*jargs, **kw,
                                                   interpret=True)
  for g, r, p in zip(got, ref, pallas):
    np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(p), atol=1e-5)


def test_k4_rejects_oversized_slot():
  params = jax_params()
  tables, weights, _, specs, keys = k4_inputs(params, np.random.default_rng(3))
  length = rwa.RAGGED_MAX_SLOT_LEN + 8
  with pytest.raises(ValueError, match='RAGGED_MAX_SLOT_LEN'):
    rwa.ragged_embed_condense_attention(
        torch.zeros(1, params.total_rows, length), torch.zeros(1, 2),
        {k: torch.from_numpy(v) for k, v in tables.items()},
        *map(torch.from_numpy, weights), None, specs=specs, table_keys=keys,
        num_heads=HEADS, attn_win_size=BAND)


def random_block(rng, has_attn):
  w = lambda *shape: rng.normal(0, 0.05, shape).astype(np.float32)
  attn = ([w(HIDDEN, HIDDEN) for _ in range(4)]
          + [np.float32(rng.uniform(0.5, 1.0))]) if has_attn else [None] * 5
  return attn + [w(HIDDEN, FILTER), w(FILTER), w(FILTER, HIDDEN), w(HIDDEN),
                 np.float32(rng.uniform(0.5, 1.0))]


def test_k2_lengths_plain_matches_jax():
  """The FFN-only layer-0 block (no lengths in JAX either), then a full
  block with the ragged mask, over every composition at once."""
  rng = np.random.default_rng(4)
  raw = [random_block(rng, False), random_block(rng, True)]
  lengths = np.zeros((6, 2), np.int32)
  for s, widths in enumerate([[100, 100], [200], [100], [], [200], [100]]):
    lengths[s, :len(widths)] = widths
  x = rng.normal(0, 1, (6, SLOT, HIDDEN)).astype(np.float32)
  jblocks = []
  for b in raw:
    vals = [None if a is None else jnp.asarray(a) for a in b]
    for i in (0, 1, 2, 3, 5, 7):
      if vals[i] is not None:
        vals[i] = jax_feb.QuantizedWeight(vals[i], None)
    jblocks.append(jax_feb.EncoderBlockWeights(*vals))
  tblocks = [feb.EncoderBlockWeights(*[
      None if a is None else torch.from_numpy(np.asarray(a)) for a in b])
             for b in raw]
  kw = dict(num_heads=HEADS, attn_win_size=BAND)
  got = feb.fused_encoder_stack(torch.from_numpy(x), tblocks, **kw,
                                lengths=torch.from_numpy(lengths))
  ref = jax_feb.reference_encoder_stack(jnp.asarray(x), jblocks, **kw,
                                        lengths=jnp.asarray(lengths))
  pallas = jax_feb.fused_encoder_stack(jnp.asarray(x), jblocks, **kw,
                                       lengths=jnp.asarray(lengths),
                                       tile_windows=2, interpret=True)
  np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
  np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=1e-5)


@pytest.fixture(scope='module')
def ragged_model():
  """(rows, lengths, Flax tree, port state) for one mixed pack; the tree
  comes from a Flax init with window_buckets set and non-zero alphas,
  and bridges to the port unchanged."""
  params = jax_params()
  rows, lengths = pack(params, [[200], [100, 100], [100], []], 5)
  variables = jax_model.get_model(params).init(
      jax.random.PRNGKey(0), jnp.zeros((1, params.total_rows, 100, 1)))
  flat = flax.traverse_util.flatten_dict(
      flax.core.unfreeze(variables['params']))
  rng = np.random.default_rng(6)
  for key in flat:
    if key[-1] == 'alpha':
      flat[key] = np.float32(rng.uniform(0.5, 1.0))
  tree = jax.device_get(flax.traverse_util.unflatten_dict(flat))
  state = weights_lib.from_flax_params(tree, torch_params())
  return rows[..., None], lengths, tree, state


@pytest.mark.parametrize('fused', [False, True])
def test_model_ragged_forward_matches_jax_apply(ragged_model, fused):
  rows, lengths, tree, state = ragged_model
  want = np.asarray(jax_model.get_model(
      jax_params(use_fused_hotpath=fused)).apply(
          {'params': tree}, jnp.asarray(rows),
          window_lengths=jnp.asarray(lengths)))
  model = torch_model.DeepConsensusModel(
      torch_params(use_fused_hotpath=fused), device='cpu')
  model.load_state_dict(state)
  got = model(torch.from_numpy(rows),
              window_lengths=torch.from_numpy(lengths)).numpy()
  np.testing.assert_allclose(got, want, atol=1e-5)
  # The two routes differ only where no window is (never delivered).
  valid = rwa.slot_geometry(torch.from_numpy(lengths), SLOT)[3].numpy()
  other = model(torch.from_numpy(rows), plain=not fused,
                window_lengths=torch.from_numpy(lengths)).numpy()
  np.testing.assert_allclose(other[valid], want[valid], atol=1e-5)


class _StubRunner:
  """Records each pack and echoes its draft-CCS row as the ids, so
  delivery by placement is observable."""

  def __init__(self, ccs_row):
    self.packs = []
    self.ccs_row = ccs_row

  def _result(self, pack):
    ids = pack[:, self.ccs_row, :, 0].astype(np.int32)
    return ids, np.full(ids.shape, 40, np.int32)

  def predict_ragged(self, pack, lengths):  # the port's packer
    self.packs.append((pack, lengths))
    return self._result(pack)

  def dispatch_ragged(self, pack, lengths):  # the JAX packer
    self.packs.append((pack, lengths))
    return pack

  def finalize(self, pack):
    return self._result(pack)


def test_packer_plans_match_jax():
  params = jax_params()
  rng = np.random.default_rng(7)
  ccs_row = 4 * params.max_passes
  submissions = []
  ticket = 0
  for _ in range(12):
    width = int(rng.choice(BUCKETS, p=[0.4, 0.6]))
    n = int(rng.integers(1, 6))
    rows = np.stack([window_rows(params, width, rng) for _ in range(n)])
    submissions.append((rows[..., None], list(range(ticket, ticket + n))))
    ticket += n
  runs = {}
  for name in ('jax', 'port'):
    runner = _StubRunner(ccs_row)
    delivered = {}
    deliver = lambda t, ids, quals, d=delivered: d.__setitem__(t, ids)
    options = types.SimpleNamespace(batch_size=8, dispatch_depth=1)
    if name == 'jax':
      packer = jax_engine._RaggedPacker(
          runner, options, BUCKETS, [], lambda ts, s, e: None, deliver)
    else:
      packer = torch_engine._RaggedPacker(runner, options, BUCKETS, deliver)
    for rows, tickets in submissions:
      packer.add(rows, tickets)
    packer.flush()
    runs[name] = (runner.packs, delivered, packer.n_packs,
                  packer.n_pack_rows, packer.n_pad_rows)
  jpacks, jdel, *jcounts = runs['jax']
  tpacks, tdel, *tcounts = runs['port']
  assert jcounts == tcounts and len(tpacks) > 3
  for (jp, jl), (tp, tl) in zip(jpacks, tpacks):
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tl, jl)
  assert jdel.keys() == tdel.keys() == set(range(ticket))
  for t in jdel:
    np.testing.assert_array_equal(tdel[t], jdel[t])
  # Mid-stream packs fill every slot exactly; only the last is partial.
  assert all(l.sum() == 8 // 2 * SLOT for _, l in tpacks[:-1])
  assert tpacks[-1][1].sum() < 8 // 2 * SLOT


@pytest.fixture(scope='module')
def wl_bams(tmp_path_factory):
  return synthetic.write_synthetic_zmw_bams(
      str(tmp_path_factory.mktemp('wl_bams')), n_zmws=6, n_subreads=4,
      seq_len=420, seed=11, smart_windows=True)


def test_smart_window_widths_are_seeded_and_bounded(wl_bams, tmp_path):
  again = synthetic.write_synthetic_zmw_bams(
      str(tmp_path), n_zmws=6, n_subreads=4, seq_len=420, seed=11,
      smart_windows=True)
  for a, b in zip(wl_bams, again):
    assert open(a, 'rb').read() == open(b, 'rb').read()
  widths = synthetic.smart_window_widths(np.random.RandomState(0), 2000)
  assert widths.sum() == 2000 and widths.max() <= 200 and widths.min() > 0
  assert (widths > 100).any() and (widths <= 100).any()
  plain = synthetic.write_synthetic_zmw_bams(
      str(tmp_path / 'plain'), n_zmws=6, n_subreads=4, seq_len=420, seed=11)
  assert open(plain[0], 'rb').read() == open(wl_bams[0], 'rb').read()
  assert open(plain[1], 'rb').read() != open(wl_bams[1], 'rb').read()


def test_featurized_windows_identical_with_buckets(wl_bams):
  jax_feed, _ = jax_feeder(
      wl_bams[0], wl_bams[1],
      layout=JaxLayout(20, 100, window_buckets=BUCKETS), ins_trim=5,
      use_ccs_smart_windows=True)
  torch_feed, _ = torch_feeder.create_proc_feeder(
      wl_bams[0], wl_bams[1],
      layout=FeatureLayout(20, 100, window_buckets=BUCKETS), ins_trim=5,
      use_ccs_smart_windows=True)
  options = jax_runner.InferenceOptions()
  widths = set()
  for jz, tz in zip(jax_feed(), torch_feed()):
    np.testing.assert_array_equal(jz[4], tz[4])
    jwins, jcount = jax_runner.preprocess_zmw(jz, options)
    twins, tcount = torch_runner.preprocess_zmw(tz)
    assert jcount == tcount and len(jwins) == len(twins)
    for jw, tw in zip(jwins, twins):
      assert jw.keys() == tw.keys()
      for key in jw:
        assert np.array_equal(np.asarray(jw[key]), np.asarray(tw[key])), key
      widths.add(tw['subreads'].shape[1])
  assert widths == set(BUCKETS)


def read_fastq(path):
  with open(path, 'rb') as f:
    lines = f.read().split(b'\n')
  return [(lines[i], lines[i + 1], lines[i + 3])
          for i in range(0, len(lines) - 1, 4)]


RUN_KW = dict(batch_size=8, batch_zmws=4, min_quality=0,
              skip_windows_above=0, window_buckets=BUCKETS,
              use_ragged_kernel=True, use_ccs_smart_windows=True)


@pytest.fixture(scope='module')
def jax_ragged_fastq(wl_bams, ragged_model, tmp_path_factory):
  """The JAX package's ragged run (fused hot path: its ragged Pallas
  kernels in interpret mode)."""
  *_, tree, _ = ragged_model
  params = jax_params(use_fused_hotpath=True)
  out = str(tmp_path_factory.mktemp('jax_run') / 'jax.fastq')
  opts = jax_runner.InferenceOptions(
      **RUN_KW, dc_calibration_values=jax_calibration.parse_calibration_string(
          'skip'))
  jax_runner.run_inference(
      wl_bams[0], wl_bams[1], None, out, options=opts,
      runner=jax_runner.ModelRunner(params, {'params': tree}, opts))
  return read_fastq(out)


@pytest.mark.parametrize('fused', [False, True])
def test_run_inference_ragged_matches_jax(wl_bams, ragged_model,
                                          jax_ragged_fastq, tmp_path, fused):
  *_, state = ragged_model
  runner = torch_runner.ModelRunner(
      torch_params(use_fused_hotpath=fused), state,
      torch_runner.InferenceOptions(**RUN_KW), device='cpu')
  out = str(tmp_path / 'port.fastq')
  counters = torch_runner.run_inference(wl_bams[0], wl_bams[1], out, runner)
  got = read_fastq(out)
  assert counters['success'] == len(got) == len(jax_ragged_fastq) == 6
  by_bucket = counters['n_windows_by_bucket']
  assert set(by_bucket) == set(BUCKETS) and min(by_bucket.values()) > 0
  assert counters['use_ragged_kernel'] == 1
  for (jn, js, jq), (tn, ts, tq) in zip(jax_ragged_fastq, got):
    assert (jn, js) == (tn, ts)
    dq = np.abs(np.frombuffer(jq, np.uint8).astype(int)
                - np.frombuffer(tq, np.uint8).astype(int))
    assert dq.max() <= 1


def test_cli_run_ragged_on_cpu(wl_bams, ragged_model, tmp_path):
  *_, state = ragged_model
  weights = str(tmp_path / 'w.npz')
  weights_lib.save_npz(weights, weights_lib.to_flax_params(state))
  params_json = str(tmp_path / 'params.json')
  params = torch_params()
  del params['window_buckets']  # the flag supplies them
  with open(params_json, 'w') as f:
    json.dump(params.to_dict(), f)
  out = str(tmp_path / 'cli.fastq')
  argv = ['run', '--subreads_to_ccs', wl_bams[0], '--ccs_bam', wl_bams[1],
          '--weights', weights, '--params', params_json, '--output', out,
          '--batch_size', '8', '--min_quality', '0', '--skip_windows_above',
          '0', '--device', 'cpu', '--use_ccs_smart_windows',
          '--window_buckets', '100,200']
  with pytest.raises(NotImplementedError, match='use_ragged_kernel'):
    cli.main(argv)
  assert cli.main(argv + ['--use_ragged_kernel']) == 0
  with open(out + '.inference.json') as f:
    counters = json.load(f)
  assert len(read_fastq(out)) == 6
  assert counters['window_buckets'] == list(BUCKETS)
  assert counters['n_model_packs'] >= 2
