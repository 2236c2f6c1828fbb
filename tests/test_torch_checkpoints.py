"""The checkpoint half of the port's `train` vs the JAX package's.

Held against the JAX package, on the same inputs:

* checkpoint directories the port writes (intact, truncated,
  manifest-less, with a manifest of another step): the reference's
  validate_checkpoint gives the port's (ok, reason); its
  latest_valid_checkpoint(quarantine=False) and latest_valid_step pick
  the port's directory and step;
* tree_digest of a state: the reference's hex over the same arrays as
  numpy;
* NanSentinel fed one sequence of (step, loss, grad norm, window ids /
  rows): the same dead letters (minus time and trace id), counters and
  should_rollback answers;
* run_training_with_retry with run_training scripted to raise
  transient, permanent, NonFiniteTrainingError and stalled-resume
  failures: the same attempts, sleeps and error types;
* run_eval against the JAX metric functions aggregated as the
  reference's Trainer.run_eval does, on the same weights and batches:
  the same key set, every value within 1e-5;
* the training forward on rows holding NaN, +-inf and out-of-vocabulary
  values vs model.apply: atol 1e-5; K1's plain version on such rows vs
  the reference's kernel in interpret mode: atol 1e-5;
* embed_onehot: the training forward vs model.apply(embed_onehot=True)
  atol 1e-5, and its loss gradients leaf by leaf rtol 1e-4, atol 1e-5
  (the existing forward tests' tolerances).

Port only, through `cli` on the CPU (2 layers, filter 64, batches of 8,
3 steps an epoch): an in-process SIGTERM at step 3 and the resume end
with the uninterrupted run's parameters bit for bit, and so does a
retry after a CUDA out-of-memory step; a truncated newest
checkpoint is quarantined and the run resumes from the one before; a
NaN weight rolls the run back once; a warm start is ignored once
out_dir has checkpoints; `run --checkpoint` writes the FASTQ of `run
--weights --params`; `run` refuses an invalid checkpoint with its
reason. Signal handlers and the environment are restored after each
test.
"""
import json
import os
import shutil
import signal
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepconsensus_tpu import faults as jax_faults
from deepconsensus_tpu.models import checkpoints as jax_checkpoints
from deepconsensus_tpu.models import config as jax_config
from deepconsensus_tpu.models import losses as jax_losses
from deepconsensus_tpu.models import metrics as jax_metrics
from deepconsensus_tpu.models import model as jax_model
from deepconsensus_tpu.models import train as jax_train
from deepconsensus_tpu.ops import fused_window_attention as jax_fwa
from deepconsensus_tpu_torch import cli
from deepconsensus_tpu_torch import faults as torch_faults
from deepconsensus_tpu_torch.models import checkpoints
from deepconsensus_tpu_torch.models import config as torch_config
from deepconsensus_tpu_torch.models import data as torch_data
from deepconsensus_tpu_torch.models import losses as torch_losses
from deepconsensus_tpu_torch.models import model as torch_model
from deepconsensus_tpu_torch.models import train as torch_train
from deepconsensus_tpu_torch.models import weights as weights_lib
from deepconsensus_tpu_torch.ops import fused_window_attention as fwa
from deepconsensus_tpu_torch.testing import synthetic

SMALL = dict(dtype='float32', num_hidden_layers=2, filter_size=64)
NO_DROPOUT = dict(attention_dropout=0.0, relu_dropout=0.0,
                  layer_postprocess_dropout=0.0)
MAX_PASSES, LENGTH, BATCH = 5, 20, 4


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
  """One intra-op thread for the module's fixtures and tests (the file
  shares the machine with other test workers); restored after."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def fresh_fault_hooks():
  """The injection hooks fire once a process: each test starts clean
  and leaves nothing fired behind."""
  torch_faults._fired.clear()
  yield
  torch_faults._fired.clear()


def jax_params(**overrides):
  params = jax_config.get_config('transformer_learn_values+test')
  with params.unlocked():
    params.max_passes = MAX_PASSES
  jax_config.finalize_params(params, max_length=LENGTH, is_training=False)
  with params.unlocked():
    for k, v in {**SMALL, **overrides}.items():
      params[k] = v
  return params


def torch_params(**overrides):
  params = torch_config.get_config('transformer_learn_values+custom')
  params.max_passes = MAX_PASSES
  torch_config.finalize_params(params, max_length=LENGTH)
  params.update({**SMALL, **overrides})
  return params


def fake_rows(batch, seed):
  rng = np.random.default_rng(seed)
  mp = MAX_PASSES
  rows = np.zeros((batch, 4 * mp + 5, LENGTH, 1), np.float32)
  rows[:, :mp] = rng.integers(0, 5, rows[:, :mp].shape)
  rows[:, mp:3 * mp] = rng.integers(0, 256, rows[:, mp:3 * mp].shape)
  rows[:, 3 * mp:4 * mp] = rng.integers(0, 3, rows[:, :mp].shape)
  rows[:, 4 * mp] = rng.integers(0, 5, rows[:, 4 * mp].shape)
  rows[:, 4 * mp + 1:] = rng.integers(0, 501, rows[:, 4 * mp + 1:].shape)
  return rows


def gapped_labels(batch, seed):
  rng = np.random.default_rng(seed)
  label = rng.integers(1, 5, (batch, LENGTH))
  label[rng.random((batch, LENGTH)) < 0.2] = 0
  label[:, -3:] = 0
  return label.astype(np.float32)


@pytest.fixture(scope='module')
def flax_variables():
  """One Flax init at the small size, ReZero alphas non-zero."""
  import flax

  variables = jax.jit(jax_model.get_model(jax_params()).init)(
      jax.random.PRNGKey(0), jnp.asarray(fake_rows(1, 0)))
  flat = flax.traverse_util.flatten_dict(flax.core.unfreeze(variables))
  rng = np.random.default_rng(3)
  for key in flat:
    if key[-1] == 'alpha':
      flat[key] = jnp.asarray(rng.uniform(0.5, 1.0), jnp.float32)
  return jax.device_get(flax.traverse_util.unflatten_dict(flat))


def port_model(flax_variables, **overrides):
  params = torch_params(**overrides)
  model = torch_model.DeepConsensusModel(params, device='cpu')
  model.load_state_dict(weights_lib.from_flax_params(
      flax_variables['params'], params))
  return model.requires_grad_(True)


def jax_apply(flax_variables, rows, train=True, **overrides):
  model = jax_model.get_model(jax_params(**overrides))
  return model.apply({'params': flax_variables['params']}, jnp.asarray(rows),
                     train=train, rngs={'dropout': jax.random.PRNGKey(1)})


# ---------------------------------------------------------------------------
# Checkpoint integrity against the reference's.
# ---------------------------------------------------------------------------


def small_state(step, seed=0):
  g = torch.Generator().manual_seed(seed)
  return {
      'model': {'w': torch.randn(3, 4, generator=g),
                'b': torch.randn(4, generator=g)},
      'optimizer': {'count': step, 'mu': {'w': torch.zeros(3, 4)},
                    'nu': {'w': torch.ones(3, 4)}},
      'generator': torch.Generator().manual_seed(seed + 1).get_state(),
      'step': step,
  }


def as_numpy(tree):
  if isinstance(tree, dict):
    return {k: as_numpy(v) for k, v in tree.items()}
  return tree.numpy() if isinstance(tree, torch.Tensor) else tree


def test_tree_digest_matches_jax_and_manifest(tmp_path):
  state = small_state(4)
  digest = checkpoints.tree_digest(state)
  assert digest == jax_checkpoints.tree_digest(as_numpy(state))
  path = checkpoints.save_checkpoint(str(tmp_path), 4, state)
  assert checkpoints.read_manifest(path)['digest'] == digest
  assert checkpoints.verify_digest(path)
  assert digest != checkpoints.tree_digest(small_state(4, seed=1))


def test_validation_and_selection_match_jax(tmp_path):
  ckpt_dir = str(tmp_path / 'checkpoints')
  paths = {s: checkpoints.save_checkpoint(ckpt_dir, s, small_state(s))
           for s in (2, 4, 6, 8)}
  with open(os.path.join(paths[8], checkpoints.STATE_FILE), 'r+b') as f:
    f.truncate(os.path.getsize(f.name) // 2)
  os.remove(checkpoints.manifest_path(paths[6]))
  manifest = checkpoints.read_manifest(paths[4])
  manifest['step'] = 3
  with open(checkpoints.manifest_path(paths[4]), 'w') as f:
    json.dump(manifest, f)
  verdicts = {s: checkpoints.validate_checkpoint(p) for s, p in paths.items()}
  assert verdicts == {s: jax_checkpoints.validate_checkpoint(p)
                      for s, p in paths.items()}
  assert [ok for ok, _ in (verdicts[s] for s in (2, 4, 6, 8))] == [
      True, False, False, False]
  assert 'size mismatch for state.pt' in verdicts[8][1]
  picked = (checkpoints.latest_valid_checkpoint(ckpt_dir, quarantine=False),
            jax_checkpoints.latest_valid_checkpoint(ckpt_dir,
                                                    quarantine=False))
  assert picked == (paths[2], paths[2])
  assert (checkpoints.latest_valid_step(ckpt_dir),
          jax_checkpoints.latest_valid_step(ckpt_dir)) == (2, 2)
  # Quarantine moves the three invalid ones aside, each with its reason.
  assert checkpoints.latest_valid_checkpoint(ckpt_dir) == paths[2]
  qdir = os.path.join(ckpt_dir, checkpoints.QUARANTINE_DIRNAME)
  for s in (4, 6, 8):
    with open(os.path.join(qdir, f'checkpoint-{s}.reason.txt')) as f:
      assert f.read().strip() == verdicts[s][1]
  # Overwriting a step (the final save on an eval boundary) commits the
  # new state.
  again = checkpoints.save_checkpoint(ckpt_dir, 2, small_state(2, seed=5))
  assert jax_checkpoints.validate_checkpoint(again) == (True, 'ok')
  assert checkpoints.verify_digest(again)
  with pytest.raises(ValueError, match='no committed manifest'):
    checkpoints.require_valid(os.path.join(qdir, 'checkpoint-6'))


# ---------------------------------------------------------------------------
# NanSentinel and the retry wrapper against the reference's.
# ---------------------------------------------------------------------------


def scrub(letters):
  return [{k: v for k, v in e.items() if k not in ('time', 'trace_id')}
          for e in letters]


def test_nan_sentinel_matches_jax(tmp_path):
  rows = fake_rows(2, 7)
  names = np.asarray([b'm/1/ccs/0-20', b'm/2/ccs/20-40'], dtype=object)
  sequence = [(1, 0.5, 1.0, None), (2, np.nan, 1.0, names),
              (3, 0.4, np.inf, None), (4, np.inf, np.nan, names),
              (5, np.nan, 1.0, None), (6, 0.3, 1.0, None),
              (7, np.nan, np.nan, names)]
  answers = {}
  for pkg in ('jax', 'torch'):
    out = tmp_path / pkg
    out.mkdir()
    params = torch_params(nan_sentinel_steps=2, nan_max_rollbacks=1)
    if pkg == 'jax':
      sentinel = jax_train.NanSentinel(jax_params(nan_sentinel_steps=2,
                                                  nan_max_rollbacks=1),
                                       str(out), writer=True)
    else:
      sentinel = torch_train.NanSentinel(params, str(out))
    seen = []
    for step, loss, grad_norm, window_ids in sequence:
      bad = sentinel.observe(step, {'loss': loss, 'grad_norm': grad_norm},
                             window_ids, {'rows': rows})
      seen.append((bad, sentinel.consecutive, sentinel.should_rollback()))
      if sentinel.should_rollback():
        sentinel.rolled_back('checkpoint-2')
    sentinel.close()
    answers[pkg] = (seen, dict(sentinel.counters), scrub(
        torch_faults.read_dead_letters(str(out / 'training.failed.jsonl'))))
  assert answers['torch'] == answers['jax']
  letters = answers['torch'][2]
  assert [e['action'] for e in letters] == [
      'recorded', 'rollback', 'recorded', 'rollback', 'recorded']
  assert letters[0]['window_ids'] == ['m/1/ccs/0-20', 'm/2/ccs/20-40']
  assert len(letters[1]['batch_sha1']) == 16


def scripted(errors, ckpt_dir=None):
  """A run_training stand-in raising errors[i] at call i (None:
  return), committing a checkpoint of step i first when ckpt_dir is
  given (the resume position advances)."""
  calls = []

  def run(*args, **kwargs):
    calls.append(1)
    if ckpt_dir is not None:
      checkpoints.save_checkpoint(ckpt_dir, len(calls), small_state(0))
    err = errors[len(calls) - 1]
    if err is None:
      return {'done': float(len(calls))}
    raise err
  return run, calls


@pytest.mark.parametrize('case', ['transient_then_ok', 'permanent',
                                  'non_finite', 'stalled', 'advancing'])
def test_retry_matches_jax(case, tmp_path, monkeypatch):
  def errors(faults):
    oom = faults.DeviceOomError('injected device OOM at step 5')
    lost = RuntimeError('UNAVAILABLE: socket closed')
    return {
        'transient_then_ok': [oom, lost, None],
        'permanent': [ValueError('bad shard'), None],
        'non_finite': [oom, faults.NonFiniteTrainingError('diverged'), None],
        'stalled': [lost] * 8,
        'advancing': [lost] * 5 + [None],
    }[case]

  outcomes = {}
  for pkg, train_mod, faults in (('jax', jax_train, jax_faults),
                                 ('torch', torch_train, torch_faults)):
    out = tmp_path / pkg
    run, calls = scripted(errors(faults), str(out / 'checkpoints')
                          if case == 'advancing' else None)
    sleeps = []
    monkeypatch.setattr(train_mod, 'run_training', run)
    # The wrapper's own clock only: other threads keep time.sleep.
    monkeypatch.setattr(train_mod, 'time',
                        types.SimpleNamespace(sleep=sleeps.append))
    try:
      result = ('returned', train_mod.run_training_with_retry(
          params=None, out_dir=str(out)))
    except Exception as e:  # noqa: BLE001 - compared by type
      result = ('raised', type(e).__name__)
    monkeypatch.undo()
    outcomes[pkg] = (result, len(calls), sleeps)
  assert outcomes['torch'] == outcomes['jax']
  want = {'transient_then_ok': ('returned', 3), 'permanent': ('raised', 1),
          'non_finite': ('raised', 2), 'stalled': ('raised', 4),
          'advancing': ('returned', 6)}[case]
  assert (outcomes['torch'][0][0], outcomes['torch'][1]) == want
  if case == 'stalled':
    assert outcomes['torch'][0][1] == 'CrashLoopError'
    assert outcomes['torch'][2] == [0.5, 1.0, 2.0]


# ---------------------------------------------------------------------------
# run_eval, rows out of range, embed_onehot against the reference.
# ---------------------------------------------------------------------------


def test_run_eval_matches_jax_metrics(flax_variables, tmp_path):
  synthetic.write_synthetic_tfrecords(
      str(tmp_path / 'eval'), n_shards=1, n_examples=12, max_passes=20,
      max_length=LENGTH, seed=5)
  params = torch_params(batch_size=BATCH)
  eval_ds = torch_data.DatasetIterator(str(tmp_path / 'eval' / '*'), params,
                                       BATCH, shuffle=False)
  model = port_model(flax_variables, **NO_DROPOUT)
  loss_fn = torch_train.make_loss(params)
  got = torch_train.run_eval(model, loss_fn, eval_ds, torch.device('cpu'),
                             params)
  # The reference's Trainer.run_eval aggregation, on its functions.
  jp = jax_params()
  jmodel = jax_model.get_model(jp)
  jloss = jax_losses.AlignmentLoss(del_cost=params.del_cost,
                                   loss_reg=params.loss_reg)
  metric = jax_metrics.AlignmentMetric()
  yield_metric = jax_metrics.YieldOverCCS()
  @jax.jit
  def jax_eval_step(rows, label):
    preds = jmodel.apply({'params': flax_variables['params']}, rows)
    correct, total = jax_metrics.per_example_accuracy_counts(label, preds)
    ccs = jax_train.ccs_row_from_batch(rows, jp)
    id_ccs, id_pred = jax_metrics.batch_identity_ccs_pred(ccs, preds, label,
                                                          metric)
    out = {'loss': jloss(label, preds), 'accuracy_correct': correct,
           'accuracy_total': total, 'identity_ccs': id_ccs,
           'identity_pred': id_pred}
    for cls in range(5):
      c, t = jax_metrics.per_class_accuracy_counts(label, preds, cls)
      out[f'class{cls}_correct'], out[f'class{cls}_total'] = c, t
    return out

  sums, batches = {}, 0
  for batch in eval_ds.epoch():
    out = {k: float(v) for k, v in jax_eval_step(
        jnp.asarray(batch['rows']), jnp.asarray(batch['label'])).items()}
    yield_metric.update(out['identity_ccs'], out['identity_pred'])
    for k, v in out.items():
      sums[k] = sums.get(k, 0.0) + v
    batches += 1
  want = {
      'eval/loss': sums['loss'] / batches,
      'eval/per_example_accuracy': sums['accuracy_correct'] / max(
          sums['accuracy_total'], 1),
      'eval/identity_ccs': sums['identity_ccs'] / batches,
      'eval/identity_pred': sums['identity_pred'] / batches,
      'eval/yield_over_ccs': float(yield_metric.result()),
  }
  for cls in range(5):
    total = sums[f'class{cls}_total']
    want[f'eval/class{cls}_accuracy'] = (
        sums[f'class{cls}_correct'] / total if total else 0.0)
  assert batches == 3 and set(got) == set(want)
  np.testing.assert_allclose(got.pop('eval/loss'), want.pop('eval/loss'),
                             rtol=1e-5)
  for k in want:
    np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)


def edge_rows(seed):
  """fake_rows with NaN, +-inf and out-of-vocabulary values planted in
  every row family (a NaN batch is what DCTPU_FAULT_NAN_AT_STEP makes)."""
  rows = fake_rows(BATCH, seed)
  rng = np.random.default_rng(seed + 1)
  values = np.array([np.nan, np.inf, -np.inf, 7.0, 300.0, 600.0, -3.7,
                     2.5e9], np.float32)
  hit = rng.random(rows.shape) < 0.15
  rows[hit] = rng.choice(values, int(hit.sum()))
  rows[0] = np.nan  # one window all NaN
  return rows


def test_training_forward_on_edge_rows_matches_jax(flax_variables):
  rows = edge_rows(11)
  want = jax_apply(flax_variables, rows, **NO_DROPOUT)
  with torch.no_grad():
    got = port_model(flax_variables, **NO_DROPOUT).forward_train(
        torch.from_numpy(rows), torch.Generator())
  assert np.isfinite(np.asarray(want)).all()
  np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
  # The ids: NaN to 0, +-inf and overflow to int32's ends, as XLA.
  ids = fwa.rows_to_ids(torch.from_numpy(rows))
  np.testing.assert_array_equal(
      ids.numpy(), np.asarray(jnp.asarray(rows).astype(jnp.int32)))


def test_k1_plain_on_edge_rows_matches_jax():
  params = jax_config.get_config('transformer_learn_values+test')
  jax_config.finalize_params(params, max_length=LENGTH)
  rng = np.random.default_rng(1)
  specs, keys, cond_in = jax_fwa.build_family_specs(params)
  tables = {k: rng.normal(0, 0.5, (next(
      s.vocab for s in specs if s.table_idx == i), next(
      s.width for s in specs if s.table_idx == i))).astype(np.float32)
            for i, k in enumerate(keys)}
  hidden = 280
  weights = [rng.normal(0, 0.05, shape).astype(np.float32) for shape in
             [(cond_in, hidden)] + [(hidden, hidden)] * 4]
  pos = rng.normal(0, 1, (LENGTH, hidden)).astype(np.float32)
  rows = np.zeros((3, params.total_rows, LENGTH), np.float32)
  values = np.array([np.nan, np.inf, -np.inf, 1.0, 3.0, 300.0, -3.7, 2.5e9,
                     0.0], np.float32)
  rows[:] = rng.choice(values, rows.shape)
  kw = dict(specs=specs, table_keys=keys, num_heads=2, attn_win_size=12)
  got = fwa.fused_embed_condense_attention(
      torch.from_numpy(rows), {k: torch.from_numpy(v)
                               for k, v in tables.items()},
      *map(torch.from_numpy, weights), torch.from_numpy(pos), **kw)
  jargs = (jnp.asarray(rows), {k: jnp.asarray(v) for k, v in tables.items()},
           *map(jnp.asarray, weights), jnp.asarray(pos))
  pallas = jax_fwa.fused_embed_condense_attention(*jargs, **kw,
                                                  tile_windows=3)
  for g, p in zip(got, pallas):
    assert np.isfinite(np.asarray(p)).all()
    np.testing.assert_allclose(g.numpy(), np.asarray(p), atol=1e-5)


def test_embed_onehot_matches_jax(flax_variables):
  rows, label = fake_rows(BATCH, 1), gapped_labels(BATCH, 2)
  loss_jax = jax_losses.AlignmentLoss(del_cost=10.0, loss_reg=1.0)

  def jax_loss(p):
    preds = jax_apply({'params': p}, rows, embed_onehot=True, **NO_DROPOUT)
    return loss_jax(jnp.asarray(label), preds), preds

  (want_loss, want_preds), want_grads = jax.jit(jax.value_and_grad(
      jax_loss, has_aux=True))(flax_variables['params'])
  model = port_model(flax_variables, embed_onehot=True, **NO_DROPOUT)
  assert model.bases_embedding.onehot and not model.pw_embedding.onehot
  preds = model.forward_train(torch.from_numpy(rows), torch.Generator())
  np.testing.assert_allclose(preds.detach().numpy(), np.asarray(want_preds),
                             atol=1e-5)
  loss = torch_losses.AlignmentLoss(del_cost=10.0, loss_reg=1.0)(
      torch.from_numpy(label), preds)
  loss.backward()
  np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
  got = weights_lib.flatten_tree(weights_lib.gradients_to_flax(model))
  want = weights_lib.flatten_tree(jax.device_get(want_grads))
  assert got.keys() == want.keys()
  for key in want:
    np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want[key]),
                               rtol=1e-4, atol=1e-5, err_msg=key)
  # The one-hot route gives the gather route's values.
  with torch.no_grad():
    plain = port_model(flax_variables, **NO_DROPOUT).forward_train(
        torch.from_numpy(rows), torch.Generator())
  np.testing.assert_allclose(preds.detach().numpy(), plain.numpy(),
                             atol=1e-6)


# ---------------------------------------------------------------------------
# The port's fault surface through `cli train` / `cli run` on the CPU.
# ---------------------------------------------------------------------------

TRAIN_FLAGS = ('--batch_size', '8', '--device', 'cpu', '--set',
               'num_hidden_layers=2', '--set', 'filter_size=64', '--set',
               'dtype=float32', '--set', 'log_every_n_steps=1', '--set',
               'track_window_ids=true')


@pytest.fixture(scope='module')
def shards(tmp_path_factory):
  root = tmp_path_factory.mktemp('ckpt_shards')
  synthetic.write_synthetic_tfrecords(
      str(root / 'train'), n_shards=2, n_examples=24, max_passes=20,
      max_length=100, seed=3)
  synthetic.write_synthetic_tfrecords(
      str(root / 'eval'), n_shards=1, n_examples=8, max_passes=20,
      max_length=100, seed=4)
  return str(root / 'train' / '*'), str(root / 'eval' / '*')


def train(shards, out, *extra, epochs=2):
  return cli.main(['train', '--out_dir', str(out), '--train_path', shards[0],
                   '--eval_path', shards[1], '--num_epochs', str(epochs),
                   *TRAIN_FLAGS, *extra])


def read_jsonl(path):
  with open(path) as f:
    return [json.loads(line) for line in f]


def weights_of(out):
  with np.load(os.path.join(out, 'weights.npz')) as z:
    return {k: z[k] for k in z.files}


@pytest.fixture(scope='module')
def baseline(shards, tmp_path_factory):
  """Two uninterrupted epochs (6 steps), eval and save every 2 steps,
  best checkpoint by eval/identity_pred."""
  out = tmp_path_factory.mktemp('baseline') / 'model'
  assert train(shards, out, '--set', 'eval_every_n_steps=2', '--set',
               'best_checkpoint_metric=eval/identity_pred') == 0
  return str(out)


@pytest.fixture
def sigterm_safe():
  """A no-op SIGTERM handler while the test runs (were the guard not
  installed, the signal must not end the worker); the old one after."""
  prev = signal.signal(signal.SIGTERM, lambda *a: None)
  yield
  signal.signal(signal.SIGTERM, prev)


def test_baseline_sidecars(baseline):
  entries = read_jsonl(os.path.join(baseline, 'metrics.jsonl'))
  evals = [e for e in entries if e['split'] == 'eval']
  assert [e['step'] for e in evals] == [2, 4, 6, 6]
  assert {'eval/identity_ccs', 'eval/identity_pred',
          'eval/yield_over_ccs'} <= set(evals[0])
  with open(os.path.join(baseline, 'checkpoint_metrics.tsv')) as f:
    header, *rows = [line.rstrip('\n').split('\t') for line in f]
  assert header[1:] == sorted(evals[0].keys() - {'step', 'split', 'time'})
  col = header.index('eval/identity_pred')
  best = max(rows, key=lambda r: float(r[col]))[0]
  with open(os.path.join(baseline, 'best_checkpoint.txt')) as f:
    assert f.read().strip() == best
  ckpt_dir = os.path.join(baseline, 'checkpoints')
  assert sorted(os.listdir(os.path.join(ckpt_dir, '.manifests'))) == [
      f'checkpoint-{s}.json' for s in (2, 4, 6)]
  faults = [e for e in entries if e['split'] == 'faults'][-1]
  assert faults['train_step_p50_s'] > 0 and faults['n_batch_launches'] == 6
  # TensorBoard: Event protos in a TFRecord events file per split.
  from tensorboard.compat.proto import event_pb2
  from deepconsensus_tpu_torch.io.tfrecord import TFRecordReader

  tb_dir = os.path.join(baseline, 'tensorboard', 'eval')
  (events,) = os.listdir(tb_dir)
  scalars = []
  for record in TFRecordReader(os.path.join(tb_dir, events)):
    event = event_pb2.Event.FromString(record)
    scalars += [(event.step, v.simple_value) for v in event.summary.value
                if v.tag == 'eval/identity_pred']
  np.testing.assert_allclose(
      scalars, [(e['step'], e['eval/identity_pred']) for e in evals],
      rtol=1e-6)


def test_sigterm_then_resume_equals_uninterrupted(shards, baseline, tmp_path,
                                                  monkeypatch, sigterm_safe):
  out = tmp_path / 'model'
  monkeypatch.setenv(torch_faults.ENV_SIGTERM_AT_STEP, '3')
  assert train(shards, out, '--set', 'eval_every_n_steps=2') == 0
  entries = read_jsonl(out / 'metrics.jsonl')
  assert [e['step'] for e in entries if e['split'] == 'train'] == [1, 2, 3]
  ckpt = str(out / 'checkpoints' / 'checkpoint-3')
  assert checkpoints.validate_checkpoint(ckpt) == (True, 'ok')
  with open(out / 'checkpoint_metrics.tsv') as f:  # no row for step 3
    assert [line.split('\t')[0] for line in f][1:] == ['checkpoint-2']
  assert not os.path.exists(out / 'weights.npz')
  monkeypatch.delenv(torch_faults.ENV_SIGTERM_AT_STEP)
  assert train(shards, out, '--set', 'eval_every_n_steps=2') == 0
  resumed = read_jsonl(out / 'metrics.jsonl')[len(entries):]
  assert [e['step'] for e in resumed if e['split'] == 'train'] == [4, 5, 6]
  want, got = weights_of(baseline), weights_of(out)
  for k in want:
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_cuda_oom_step_retries_from_checkpoint(shards, baseline, tmp_path,
                                               monkeypatch, caplog):
  """torch.OutOfMemoryError from step 5 (once) reaches the retry loop as
  DeviceOomError (transient): one retry, a resume from checkpoint-4, and
  the uninterrupted run's parameters bit for bit."""
  step_fn = torch_train.train_step
  calls = []

  def oom_once(*args, **kwargs):
    calls.append(1)
    if len(calls) == 5:
      raise torch.OutOfMemoryError('CUDA out of memory. Tried to allocate')
    return step_fn(*args, **kwargs)

  monkeypatch.setattr(torch_train, 'train_step', oom_once)
  out = tmp_path / 'model'
  with caplog.at_level('WARNING'):
    assert train(shards, out, '--set', 'eval_every_n_steps=2') == 0
  retries = [r for r in caplog.records
             if r.getMessage().startswith('transient failure (DeviceOomError')]
  assert len(retries) == 1 and len(calls) == 7
  entries = read_jsonl(out / 'metrics.jsonl')
  assert [e['step'] for e in entries if e['split'] == 'train'] == [
      1, 2, 3, 4, 5, 6]
  want, got = weights_of(baseline), weights_of(out)
  for k in want:
    np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_truncated_checkpoint_is_quarantined_on_resume(shards, tmp_path):
  out = tmp_path / 'model'
  assert train(shards, out, '--set', 'eval_every_n_steps=1', epochs=1) == 0
  state = out / 'checkpoints' / 'checkpoint-3' / 'state.pt'
  with open(state, 'r+b') as f:
    f.truncate(os.path.getsize(state) // 2)
  n_before = len(read_jsonl(out / 'metrics.jsonl'))
  assert train(shards, out, '--set', 'eval_every_n_steps=1') == 0
  qdir = out / 'checkpoints' / '.quarantine'
  with open(qdir / 'checkpoint-3.reason.txt') as f:
    assert f.read().startswith('size mismatch for state.pt')
  resumed = read_jsonl(out / 'metrics.jsonl')[n_before:]
  assert [e['step'] for e in resumed if e['split'] == 'train'] == [
      3, 4, 5, 6]


def test_nan_weight_rolls_back_once(shards, tmp_path, monkeypatch):
  """A NaN weight before step 4's forward (once): steps 4 and 5 are
  non-finite (2 dead letters with the batch's window ids, the second a
  rollback), the run rolls back to checkpoint-2 and ends finite; no
  committed checkpoint holds a non-finite tensor."""
  step_fn = torch_train.train_step
  calls = []

  def poisoned(model, *args, **kwargs):
    calls.append(1)
    if len(calls) == 4:
      with torch.no_grad():
        next(model.encoder.parameters()).view(-1)[0] = float('nan')
    return step_fn(model, *args, **kwargs)

  monkeypatch.setattr(torch_train, 'train_step', poisoned)
  out = tmp_path / 'model'
  assert train(shards, out, '--set', 'eval_every_n_steps=2', '--set',
               'nan_sentinel_steps=2', epochs=3) == 0
  letters = torch_faults.read_dead_letters(str(out / 'training.failed.jsonl'))
  assert [(e['step'], e['action']) for e in letters] == [
      (4, 'recorded'), (5, 'rollback')]
  assert all(len(e['window_ids']) == 8 for e in letters)
  faults = [e for e in read_jsonl(out / 'metrics.jsonl')
            if e['split'] == 'faults'][-1]
  assert faults['n_nan_rollbacks'] == 1 and faults['n_nonfinite_steps'] == 2
  for name in os.listdir(out / 'checkpoints'):
    if name.startswith('checkpoint-'):
      state = checkpoints.load_state(str(out / 'checkpoints' / name))
      assert all(torch.isfinite(t).all() for t in state['model'].values())
  assert all(np.isfinite(v).all() for v in weights_of(out).values())


def test_warm_start_then_ignored_once_resuming(shards, baseline, tmp_path,
                                               monkeypatch, caplog):
  source = os.path.join(baseline, 'checkpoints', 'checkpoint-6')
  step_fn = torch_train.train_step
  first = {}

  def capture(model, optimizer, *args, **kwargs):
    if not first:
      first['params'] = {n: p.detach().clone()
                         for n, p in model.named_parameters()}
      first['count'] = optimizer.count
      first['mu'] = max(float(m.abs().max()) for m in optimizer.mu.values())
    return step_fn(model, optimizer, *args, **kwargs)

  monkeypatch.setattr(torch_train, 'train_step', capture)
  out = tmp_path / 'model'
  assert train(shards, out, '--checkpoint', source, epochs=1) == 0
  want = checkpoints.load_state(source)['model']
  for name, p in first['params'].items():
    assert torch.equal(p, want[name]), name
  assert first['count'] == 0 and first['mu'] == 0.0
  n_before = len(read_jsonl(out / 'metrics.jsonl'))
  with caplog.at_level('WARNING'):
    assert train(shards, out, '--checkpoint', source) == 0
  assert 'ignored' in caplog.text
  resumed = read_jsonl(out / 'metrics.jsonl')[n_before:]
  assert [e['step'] for e in resumed if e['split'] == 'train'] == [4, 5, 6]


def test_run_from_checkpoint_matches_weights_and_refuses_invalid(
    baseline, tmp_path):
  bams = synthetic.write_synthetic_zmw_bams(
      str(tmp_path / 'bams'), n_zmws=3, n_subreads=4, seq_len=260, seed=11)
  common = ['run', '--subreads_to_ccs', bams[0], '--ccs_bam', bams[1],
            '--batch_size', '8', '--min_quality', '0',
            '--skip_windows_above', '0', '--device', 'cpu']
  ckpt = os.path.join(baseline, 'checkpoints', 'checkpoint-6')
  outs = {}
  for tag, source in (('checkpoint', ['--checkpoint', ckpt]),
                      ('weights', ['--weights',
                                   os.path.join(baseline, 'weights.npz'),
                                   '--params',
                                   os.path.join(baseline, 'params.json')])):
    outs[tag] = str(tmp_path / f'{tag}.fastq')
    assert cli.main(common + source + ['--output', outs[tag]]) == 0
  with open(outs['checkpoint'], 'rb') as a, open(outs['weights'], 'rb') as b:
    assert a.read() == b.read()
  broken = tmp_path / 'checkpoints' / 'checkpoint-6'  # no manifest
  shutil.copytree(ckpt, str(broken))
  with pytest.raises(ValueError, match='no committed manifest'):
    cli.main(common + ['--checkpoint', str(broken), '--params',
                       os.path.join(baseline, 'params.json'), '--output',
                       str(tmp_path / 'x.fastq')])
