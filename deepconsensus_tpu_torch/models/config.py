"""Model/hparam configuration for the port (no ml_collections).

The reference package keeps its presets in an ml_collections
ConfigDict. The port carries the subset that inference and training
read, in `Params`: a plain dict whose keys are also attributes, so code written
against `params.max_length` and `params.get('dtype')` reads the same.
`params.json` files written by the reference package load unchanged
(unknown keys are kept).
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional

from deepconsensus_tpu_torch.preprocess.pileup import total_rows as _total_rows

# Canonical window geometry (reference: model_configs.py max_length=100).
DEFAULT_MAX_LENGTH = 100
# Longest window the fused kernels take (whole-window attention tiles).
FUSED_MAX_WINDOW_LEN = 128
# Longest window the whole-window training attention kernels (K5-K7,
# use_pallas_attention) take; longer ones need the block-banded flash
# kernels (reference flash_band_attention.WHOLE_L_LIMIT).
WHOLE_L_LIMIT = 128
# Default bucket set when params.window_buckets is requested but unset:
# the reference L=100 plus one 2x bucket.
DEFAULT_WINDOW_BUCKETS = (100, 200)
# Long-insert geometry. Training windows at or past
# RING_ATTENTION_MIN_LEN route BandedSelfAttention through the
# blockwise ring-attention scan (parallel/ring_attention.py) instead
# of materializing the [B, N, L, L] logits: at L=500 the full logits
# tensor no longer fits the fused kernel's VMEM tiling, and the
# banded structure makes the blockwise online-softmax pass both exact
# and memory-bounded. Buckets below the crossover (100, 200) keep the
# module route's einsums (or K5-K7 with use_pallas_attention).
# (Reference: deepconsensus_tpu/models/config.py.)
RING_ATTENTION_MIN_LEN = 256
LONG_INSERT_WINDOW_LEN = 500
# Quantization acceptance gates (the reference's values): int8 —
# held-out alignment identity within this delta of the f32 baseline
# (models/evaluate.py); bf16 — per-base Phred QVs within this many units
# of f32 on argmax-agreeing positions.
INT8_IDENTITY_GATE = 0.002
BF16_QV_GATE = 3


def normalize_window_buckets(buckets, max_length: int):
  """Validate and canonicalize a window-bucket spec.

  None/empty means bucketing is off: one bucket equal to max_length. A
  non-empty spec must be strictly ascending positive ints whose smallest
  entry equals max_length (the featurize stride); buckets only widen
  the variable-width (smart window) path.
  """
  if not buckets:
    return (int(max_length),)
  if isinstance(buckets, str):
    # '--set window_buckets=100,200' arrives as the raw string.
    buckets = [b for b in buckets.replace(',', ' ').split()]
  out = tuple(int(b) for b in buckets)
  if any(b <= 0 for b in out):
    raise ValueError(f'window_buckets must be positive ints, got {out}')
  if list(out) != sorted(set(out)):
    raise ValueError(
        f'window_buckets must be strictly ascending, got {out}')
  if out[0] != int(max_length):
    raise ValueError(
        f'smallest window bucket {out[0]} must equal max_length '
        f'{max_length} (max_length is the featurize stride)')
  return out


def resolve_window_buckets(params):
  """Bucket set for a params object: normalized params.window_buckets,
  or the single-bucket (max_length,) when unset."""
  return normalize_window_buckets(params.get('window_buckets'),
                                  int(params.max_length))


def bucket_for(width: int, buckets):
  """Smallest bucket that fits `width`, or None when it overflows all
  buckets (the caller's overflow-skip path)."""
  for b in buckets:
    if width <= b:
      return int(b)
  return None

# Transformer size presets (reference: transformer_basic_params.py).
TRANSFORMER_SIZE_PARAMS = {
    'tiny': dict(num_hidden_layers=6, num_heads=4, filter_size=256),
    'base': dict(num_hidden_layers=6, num_heads=8, filter_size=2048),
    'big': dict(num_hidden_layers=6, num_heads=16, filter_size=4096),
}


class Params(dict):
  """Attribute-access dict standing in for ml_collections.ConfigDict."""

  def __getattr__(self, name: str) -> Any:
    try:
      return self[name]
    except KeyError:
      raise AttributeError(name) from None

  def __setattr__(self, name: str, value: Any) -> None:
    self[name] = value

  def to_dict(self) -> dict:
    return dict(self)


def _set_base_transformer_hparams(params: Params) -> None:
  params.model_name = 'transformer'
  params.add_pos_encoding = True
  params.num_heads = 2
  params.layer_norm = False
  params.rezero = True
  params.condense_transformer_input = False
  params.transformer_model_size = 'base'
  # Band half-width; full band is 2*attn_win_size+1 columns.
  params.attn_win_size = 12
  params.num_channels = 1
  params.per_base_hidden_size = 1
  params.pw_hidden_size = 1
  params.ip_hidden_size = 1
  params.sn_hidden_size = 1
  params.ccs_bq_hidden_size = 1
  params.strand_hidden_size = 1
  params.layer_postprocess_dropout = 0.1
  params.attention_dropout = 0.1
  params.relu_dropout = 0.1
  params.batch_size = 256
  params.num_epochs = 9
  params.num_epochs_for_decay = 9
  params.buffer_size = 1_000_000
  params.initial_learning_rate = 3.6246e-3
  params.end_learning_rate = 2.86594e-5
  params.warmup_steps = 35536
  params.weight_decay_rate = 6.9868e-3
  params.beta_1 = 0.9
  params.beta_2 = 0.999
  params.epsilon = 1e-6


def _set_transformer_learned_embeddings_hparams(params: Params) -> None:
  _set_base_transformer_hparams(params)
  params.model_name = 'transformer_learn_values'
  params.per_base_hidden_size = 8
  params.pw_hidden_size = 8
  params.ip_hidden_size = 8
  params.strand_hidden_size = 2
  params.sn_hidden_size = 8
  params.ccs_bq_hidden_size = 8
  params.condense_transformer_input = True
  params.transformer_input_size = 280


def _set_transformer_learned_embeddings_distill_hparams(params: Params):
  _set_transformer_learned_embeddings_hparams(params)
  params.model_name = 'transformer_learn_values_distill'
  params.num_hidden_layers = 5
  params.filter_size = 2048
  params.layer_postprocess_dropout = 0.0
  params.attention_dropout = 0.1
  params.relu_dropout = 0.0
  params.warmup_steps = 0


def get_config(config_name: Optional[str] = None) -> Params:
  """Builds Params for '{model}+{dataset}' preset names."""
  params = Params()
  params.rezero = False
  params.PW_MAX = 255
  params.IP_MAX = 255
  params.SN_MAX = 500
  params.CCS_BQ_MAX = 95
  params.STRAND_MAX = 2
  params.use_bases = True
  params.use_pw = True
  params.use_ip = True
  params.use_strand = True
  params.use_sn = True
  params.use_ccs = True
  params.use_ccs_bq = False
  params.per_base_hidden_size = 1
  params.pw_hidden_size = 1
  params.ip_hidden_size = 1
  params.sn_hidden_size = 1
  params.strand_hidden_size = 1
  params.ccs_bq_hidden_size = 1
  params.total_rows = None
  params.vocab_size = 5
  params.max_length = DEFAULT_MAX_LENGTH
  params.model_config_name = 'transformer_learn_values'
  params.dataset_config_name = 'ccs'
  params.dtype = 'bfloat16'  # compute dtype; params stay float32
  params.attn_softmax_dtype = None
  params.use_fused_hotpath = False
  # Attention through the banded-attention kernels K5-K7 (training
  # forward and backward, and the module route's forward).
  params.use_pallas_attention = False
  # Inference levers (models/quantize.py), applied once at load:
  # inference_dtype 'bfloat16' casts the float weights (and sets the
  # compute dtype); quantize_matmuls 'int8' quantizes the encoder's six
  # matmuls per layer, per output channel.
  params.inference_dtype = None
  params.quantize_matmuls = None
  # Training (reference: model_configs.py:320-323 for the loss).
  params.seed = 1
  params.remove_label_gaps = False
  params.del_cost = 10.0
  params.loss_reg = 0.1
  params.band_width = None
  params.eval_every_n_steps = 3000
  params.log_every_n_steps = 100
  # Window length buckets (None: one bucket, max_length). Training with
  # several (e.g. (100, 200)) triages each example into the smallest
  # bucket that fits and takes one step per width-pure batch; the
  # smallest bucket must equal max_length.
  params.window_buckets = None
  # The StreamingDataset (models/data.py) in place of the in-memory
  # DatasetIterator; n_examples_train (>= one batch) sizes an epoch's
  # steps. loader_workers > 0 decodes shards in that many spawned
  # processes; buffer_size is the shuffle reservoir (the presets' 1e6).
  params.streaming = False
  params.loader_workers = 0
  params.n_examples_train = 0
  # A shard the streaming loader cannot decode: 'fail' aborts, 'skip'
  # counts it (n_shard_errors) and reads on (--on_shard_error).
  params.on_shard_error = 'fail'
  # Training-time window augmentation (models/data.py::augment_batch),
  # each transform per example with its probability; training batches
  # only.
  params.augment = False
  params.augment_perm_prob = 0.5     # shuffle subread order
  params.augment_drop_prob = 0.3     # downsample subreads (keep >= half)
  params.augment_rc_prob = 0.5       # reverse-complement the window
  params.augment_jitter_prob = 0.3   # +/-1 jitter on nonzero PW/IP
  # Recompute each encoder sublayer in the backward pass instead of
  # keeping its activations (torch.utils.checkpoint): less device
  # memory for more time.
  params.remat = False
  if config_name is None:
    return params

  model_config_name, dataset_config_name = config_name.split('+')
  params.model_config_name = model_config_name
  params.dataset_config_name = dataset_config_name
  if model_config_name == 'transformer_learn_values':
    _set_transformer_learned_embeddings_hparams(params)
  elif model_config_name == 'transformer_learn_values_distill':
    _set_transformer_learned_embeddings_distill_hparams(params)
  else:
    raise NotImplementedError(
        f'model config {model_config_name!r} is not ported yet; the port '
        'serves the transformer_learn_values family (ROADMAP: tail '
        'modules)')
  if dataset_config_name in ('test', 'custom', 'ccs'):
    params.max_passes = 20
  elif dataset_config_name == 'test_bq':
    params.max_passes = 20
    params.use_ccs_bq = True
  else:
    raise ValueError(
        f'dataset_config_name is {dataset_config_name}. Must be one of: '
        'test, test_bq, custom'
    )
  return params


def finalize_params(
    params: Params,
    max_length: Optional[int] = None,
) -> None:
  """Derives dependent parameters (reference modify_params)."""
  if max_length is not None:
    params.max_length = max_length
  if 'max_length' not in params:
    raise ValueError('No params.max_length provided.')
  params.total_rows = _total_rows(params.max_passes, params.use_ccs_bq)
  if 'transformer_learn_values' in params.model_name:
    dim = (
        params.use_bases * params.per_base_hidden_size
        + params.use_pw * params.pw_hidden_size
        + params.use_ip * params.ip_hidden_size
        + params.use_strand * params.strand_hidden_size
        + params.use_ccs_bq * params.ccs_bq_hidden_size
    )
    params.hidden_size = (
        params.max_passes * dim
        + params.use_ccs * params.per_base_hidden_size
        + params.use_ccs_bq * params.ccs_bq_hidden_size
        + params.use_sn * params.sn_hidden_size * 4
    )
  else:
    params.hidden_size = params.total_rows
  if 'transformer' in params.model_name and params.hidden_size % 2 != 0:
    params.hidden_size += 1
  if ('transformer_learn_values' in params.model_name
      and params.condense_transformer_input):
    params.hidden_size = params.transformer_input_size
  if 'transformer' in params.model_name:
    size = params.get('transformer_model_size', 'base')
    for name, value in TRANSFORMER_SIZE_PARAMS[size].items():
      if name not in params:
        params[name] = value


def save_params_as_json(out_dir: str, params: Params) -> str:
  """Writes params.json beside the checkpoints."""
  os.makedirs(out_dir, exist_ok=True)
  path = os.path.join(out_dir, 'params.json')
  with open(path, 'w') as f:
    json.dump(params.to_dict(), f, indent=2, sort_keys=True, default=str)
  return path


def read_params_from_json(path: str) -> Params:
  """Loads params.json: a file, or a directory (or file prefix) at or
  up to two levels below the one holding it. Unknown keys are kept."""
  if os.path.isfile(path) and path.endswith('.json'):
    json_path = path
  else:
    candidates = []
    base = path if os.path.isdir(path) else os.path.dirname(path)
    for _ in range(3):
      candidates.append(os.path.join(base, 'params.json'))
      base = os.path.dirname(base)
    for json_path in candidates:
      if os.path.exists(json_path):
        break
    else:
      raise FileNotFoundError(
          f'params.json not found near {path!r}; looked in {candidates}')
  with open(json_path) as f:
    loaded = json.load(f)
  params = get_config()
  params.update(loaded)
  return params
