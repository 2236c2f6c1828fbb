"""The condensed learned-values transformer: inference and training forwards.

Port of deepconsensus_tpu/models/model.py (DeepConsensusModel for the
transformer_learn_values family). Parameter names and layouts follow
the reference's Flax tree, so `weights.from_flax_params` is a rename:
`encoder.self_attention_0.query.kernel` is [H, heads, head_dim] as in
Flax's DenseGeneral, `output_transform.kernel` [heads, head_dim, H].

Two routes, as in the reference:

* the fused route (K1 -> K2 -> final LayerNorm, logits, softmax)
  through ops/fused_window_attention.py and ops/fused_encoder_block.py,
  for windows of at most FUSED_MAX_WINDOW_LEN (128) positions, as the
  reference's _fused_hotpath_eligible. It runs on the card, where those
  wrappers launch the CUDA kernels, and on the CPU when
  params.use_fused_hotpath is set, where they run their plain versions;
* the module route (MaskedEmbed, condenser, BandedSelfAttention,
  FeedForward, ReZero ResidualWrapper, LayerNorm), the counterpart of
  the reference's XLA path: on the CPU otherwise, and on any device for
  wider windows (the 200 bucket of per-bucket dispatch), where
  attention routes as below.

Training (`forward_train`) takes the module route on any device, as the
reference's training path does, with dropout where Flax puts it: on the
input (input_dropout), on the attention weights, after the FFN's ReLU
and on each sublayer's output inside its ReZero wrapper. Masks are
drawn from an explicit torch.Generator on the rows' device. With
params.remat each encoder sublayer (attention or FFN with its ReZero
wrapper) runs under torch.utils.checkpoint, as the reference's
nn.remat of each block: its activations are recomputed in the backward
pass, with the generator set back so the recompute draws the same
masks. BandedSelfAttention routes as the reference's does, in this order:

* windows of RING_ATTENTION_MIN_LEN (256) and longer without attention
  dropout take the blockwise ring scan (parallel/ring_attention.py),
  whatever use_pallas_attention says;
* with params.use_pallas_attention, windows up to WHOLE_L_LIMIT (128)
  take K7 with a keep-mask drawn where Dropout would draw it when
  attention dropout is on, else K5, both differentiated through K6
  (ops/banded_attention.py); longer windows take the module route with
  dropout, and without it the block-banded flash kernels
  (ops/flash_band_attention.py): K8, with its logsumexp when a gradient
  is wanted, differentiated through K9 and K10;
* otherwise the module route's einsums over [B, N, L, L] logits.

params.attn_softmax_dtype (None or 'float32', or 'bfloat16'; any other
value raises) sets the attention softmax of the fused route's K1, K2
and K4 and of the module route's einsums (ops/fused_window_attention.py
`softmax_chain`), in training and inference. As in the reference, the
K5-K10 and ring routes take no softmax dtype and ignore it, and
inference_dtype leaves it alone.

int8 matmuls (params.quantize_matmuls = 'int8', models/quantize.py):
each encoder layer's six matmul modules hold the dequantized kernel as
their parameter and the int8 values and scales as buffers. K2 reads the
int8 buffers (`kernel_blocks`); K1, K4 and the module route read the
dequantized parameters, as the reference's do. `inference_model` loads
a prepared state dict with its dtypes kept.

Ragged slots (`window_lengths`, inference with --use_ragged_kernel):
rows [B, R, S] hold windows of bucket widths packed back to back per
slot and window_lengths [B, wps] their widths. The fused route runs K4
(ops/ragged_window_attention.py) and K2 with lengths; the module route
recovers each width-w window by reshaping the slots to [B*S/w, w]
(every window starts at a multiple of its width) and gathers
pos[p - start(p)] per position, as the reference's XLA path does.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from deepconsensus_tpu_torch import constants
from deepconsensus_tpu_torch.devices import resolve_device
from deepconsensus_tpu_torch.models import config as config_lib
from deepconsensus_tpu_torch.ops import banded_attention as ba
from deepconsensus_tpu_torch.ops import flash_band_attention as fba
from deepconsensus_tpu_torch.ops import fused_encoder_block as feb
from deepconsensus_tpu_torch.ops import fused_window_attention as fwa
from deepconsensus_tpu_torch.ops import ragged_window_attention as rwa
from deepconsensus_tpu_torch.parallel import ring_attention as ring_lib

_LN_EPS = 1e-6


def sinusoidal_position_encoding(
    length: int, hidden_size: int, min_timescale: float = 1.0,
    max_timescale: float = 1.0e4) -> np.ndarray:
  """Transformer timing signal: [sin | cos] halves."""
  position = np.arange(length, dtype=np.float32)
  num_timescales = hidden_size // 2
  log_increment = np.log(max_timescale / min_timescale) / max(
      num_timescales - 1, 1
  )
  inv_timescales = min_timescale * np.exp(
      np.arange(num_timescales, dtype=np.float32) * -log_increment
  )
  scaled = position[:, None] * inv_timescales[None, :]
  return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1)


def _param(*shape, device) -> nn.Parameter:
  return nn.Parameter(torch.zeros(shape, device=device), requires_grad=False)


class Dropout:
  """Flax nn.Dropout on a torch.Generator: keep with probability
  1 - rate and scale by 1 / (1 - rate); rate 1 gives zeros, rate 0 the
  input. `kind` picks the rate: 'attention' (attention_dropout), 'relu'
  (relu_dropout) or 'post' (layer_postprocess_dropout, also the input
  dropout's)."""

  def __init__(self, params, generator: torch.Generator):
    self.rates = {'attention': float(params.attention_dropout),
                  'relu': float(params.relu_dropout),
                  'post': float(params.layer_postprocess_dropout)}
    self.generator = generator

  def __call__(self, x: torch.Tensor, kind: str) -> torch.Tensor:
    rate = self.rates[kind]
    if rate == 0.0:
      return x
    if rate == 1.0:
      return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    return torch.where(self._keep(x.shape, keep_prob, x.device),
                       x / keep_prob,
                       torch.zeros((), dtype=x.dtype, device=x.device))

  def _keep(self, shape, keep_prob: float, device) -> torch.Tensor:
    return torch.rand(shape, generator=self.generator,
                      device=device) < keep_prob

  def keep_mask(self, shape, kind: str, device
                ) -> Tuple[torch.Tensor, float]:
    """The uint8 keep-mask __call__ would apply to a tensor of `shape`
    (the same random numbers, drawn at the same point of the stream),
    and its keep probability. Rate 1 draws nothing and keeps nothing."""
    rate = self.rates[kind]
    if rate == 1.0:
      return torch.zeros(shape, dtype=torch.uint8, device=device), 1.0
    keep_prob = 1.0 - rate
    return self._keep(shape, keep_prob, device).view(torch.uint8), keep_prob


class Dense(nn.Module):
  """Flax Dense/DenseGeneral: `kernel` keeps the Flax layout; inputs
  and kernel are cast to the compute dtype. quantized (int8 matmuls):
  the module also holds buffers `quant_values` (int8 [in, out]) and
  `quant_scale` (float32 [out]) beside the dequantized kernel
  (models/quantize.py); buffers follow .to(device) and stay int8."""

  def __init__(self, in_shape: Tuple[int, ...], out_shape: Tuple[int, ...],
               use_bias: bool, device, quantized: bool = False):
    super().__init__()
    self.kernel = _param(*in_shape, *out_shape, device=device)
    self.bias = _param(*out_shape, device=device) if use_bias else None
    self.n_in = math.prod(in_shape)
    self.out_shape = out_shape
    n_out = math.prod(out_shape)
    self.register_buffer('quant_values', torch.zeros(
        (self.n_in, n_out), dtype=torch.int8, device=device)
                         if quantized else None)
    self.register_buffer('quant_scale', torch.zeros(
        n_out, device=device) if quantized else None)

  def matrix(self) -> torch.Tensor:
    """The kernel as a 2-D [in, out] matrix."""
    return self.kernel.reshape(self.n_in, -1)

  def kernel_operand(self):
    """K2's operand: the int8 values with their scale when quantized
    (a QuantizedWeight), else the float matrix."""
    if self.quant_values is None:
      return self.matrix()
    return fwa.QuantizedWeight(self.quant_values, self.quant_scale)

  def forward(self, x: torch.Tensor, n_in_dims: int, dtype) -> torch.Tensor:
    lead = x.shape[:x.dim() - n_in_dims]
    y = x.to(dtype).reshape(*lead, self.n_in) @ self.matrix().to(dtype)
    if self.bias is not None:
      y = y + self.bias.to(dtype).reshape(-1)
    return y.reshape(*lead, *self.out_shape)


class MaskedEmbed(nn.Module):
  """Embedding with zero vectors for id 0 and sqrt(dim) output scaling."""

  def __init__(self, vocab_size: int, features: int, device):
    super().__init__()
    self.embedding = _param(vocab_size, features, device=device)
    self.features = features

  def forward(self, ids: torch.Tensor, dtype) -> torch.Tensor:
    vocab = self.embedding.shape[0]
    emb = self.embedding.to(dtype)[ids.clamp(0, vocab - 1).long()]
    emb = emb * torch.tensor(self.features ** 0.5, dtype=dtype)
    return emb * (ids != 0).to(dtype)[..., None]


class BandedSelfAttention(nn.Module):
  """Multi-head self-attention with a static banded mask: the
  reference's ring scan for long windows without dropout, its XLA
  branch, or with use_kernels its Pallas branch (K5-K7, or K8-K10 past
  WHOLE_L_LIMIT)."""

  def __init__(self, hidden_size: int, num_heads: int,
               attn_win_size: Optional[int], device,
               use_kernels: bool = False, quantized: bool = False,
               softmax_dtype: torch.dtype = torch.float32):
    super().__init__()
    if hidden_size % num_heads:
      raise ValueError('hidden_size must be divisible by num_heads')
    self.num_heads = num_heads
    # attn_softmax_dtype: the softmax of `_attend` (the module route);
    # the kernel and ring routes take none, as in the reference.
    self.softmax_dtype = softmax_dtype
    self.head_dim = hidden_size // num_heads
    self.attn_win_size = attn_win_size
    self.use_kernels = use_kernels
    heads = (num_heads, self.head_dim)
    self.query = Dense((hidden_size,), heads, False, device, quantized)
    self.key = Dense((hidden_size,), heads, False, device, quantized)
    self.value = Dense((hidden_size,), heads, False, device, quantized)
    self.output_transform = Dense(heads, (hidden_size,), False, device,
                                  quantized)

  def _attend(self, query, key, value, dtype,
              drop: Optional[Dropout] = None) -> torch.Tensor:
    """[b, L, N, D] q/k/v -> [b, L, N, D], band within each row; the
    softmax in self.softmax_dtype (fwa.softmax_chain)."""
    logits = torch.einsum('btnh,bfnh->bnft', key, query)
    length = query.shape[1]
    if self.attn_win_size:
      i = torch.arange(length, device=query.device)
      band = (i[:, None] - i[None, :]).abs() <= self.attn_win_size
      logits = torch.where(band, logits,
                           torch.full((), -1e9, dtype=logits.dtype,
                                      device=query.device))
    weights = fwa.softmax_chain(logits, self.softmax_dtype).to(dtype)
    if drop is not None:
      weights = drop(weights, 'attention')
    return torch.einsum('bnft,btnh->bfnh', weights, value)

  def forward(self, x: torch.Tensor, dtype,
              ragged_widths: Optional[torch.Tensor] = None,
              ragged_buckets: Tuple[int, ...] = (),
              drop: Optional[Dropout] = None,
              plain: bool = False) -> torch.Tensor:
    """ragged_widths [B, S] (each position's window width, 0 = pad):
    each bucket width w attends over the slots reshaped to width-w
    windows, and each position takes the result of its own width.
    plain: the kernels' plain versions in place of K8 (inference)."""
    query_raw = self.query(x, 1, dtype)
    key = self.key(x, 1, dtype)
    value = self.value(x, 1, dtype)
    length = x.shape[1]
    use_dropout = drop is not None and drop.rates['attention'] > 0.0
    if (ragged_widths is None and not use_dropout
        and length >= config_lib.RING_ATTENTION_MIN_LEN):
      # Long-insert windows: the blockwise ring scan, which scales the
      # scores itself (the unscaled query) and draws no dropout.
      out = ring_lib.ring_attention_blockwise(query_raw, key, value,
                                              self.attn_win_size)
      return self.output_transform(out, 2, dtype)
    query = query_raw * (self.head_dim ** -0.5)
    if ragged_widths is None and self.use_kernels and not (
        use_dropout and length > config_lib.WHOLE_L_LIMIT):
      out = self._attend_kernels(query, key, value, drop if use_dropout
                                 else None, plain)
    elif ragged_widths is None:
      out = self._attend(query, key, value, dtype, drop)
    else:
      out = torch.zeros_like(query)
      b, length = x.shape[:2]
      for w in ragged_buckets:
        shaped = lambda a: a.reshape(b * length // w, w, *a.shape[2:])
        cand = self._attend(shaped(query), shaped(key), shaped(value),
                            dtype).reshape(query.shape)
        out = out + torch.where((ragged_widths == w)[:, :, None, None],
                                cand, torch.zeros((), dtype=cand.dtype))
    return self.output_transform(out, 2, dtype)

  def _attend_kernels(self, query, key, value, drop: Optional[Dropout],
                      plain: bool = False) -> torch.Tensor:
    """Past WHOLE_L_LIMIT (no dropout reaches here) K8, differentiated
    through K9 and K10, or its plain version; else K7 with drop (its
    keep-mask drawn where `_attend` draws the weights' dropout), or K5;
    both differentiate through K6."""
    b, length, n, _ = query.shape
    if length > config_lib.WHOLE_L_LIMIT:
      attend = (fba.flash_band_attention_plain if plain
                else fba.flash_band_attention_vjp)
      return attend(query, key, value, self.attn_win_size)
    if drop is None:
      return ba.banded_attention_vjp(query, key, value, self.attn_win_size)
    mask, keep_prob = drop.keep_mask((b, n, length, length), 'attention',
                                     query.device)
    return ba.banded_attention_dropout_vjp(query, key, value, mask,
                                           self.attn_win_size, keep_prob)


class FeedForward(nn.Module):
  """filter_size ReLU -> hidden_size."""

  def __init__(self, hidden_size: int, filter_size: int, device,
               quantized: bool = False):
    super().__init__()
    self.filter_layer = Dense((hidden_size,), (filter_size,), True, device,
                              quantized)
    self.output_layer = Dense((filter_size,), (hidden_size,), True, device,
                              quantized)

  def forward(self, x: torch.Tensor, dtype,
              drop: Optional[Dropout] = None) -> torch.Tensor:
    h = torch.relu(self.filter_layer(x, 1, dtype))
    if drop is not None:
      h = drop(h, 'relu')
    return self.output_layer(h, 1, dtype)


class ResidualWrapper(nn.Module):
  """ReZero residual holder: x + alpha * f(x)."""

  def __init__(self, device):
    super().__init__()
    self.alpha = _param(device=device)

  def forward(self, x: torch.Tensor, y: torch.Tensor,
              drop: Optional[Dropout] = None) -> torch.Tensor:
    if drop is not None:
      y = drop(y, 'post')
    return x + self.alpha.to(y.dtype) * y


def _checkpointed(fn, x: torch.Tensor, drop: Optional[Dropout]
                  ) -> torch.Tensor:
  """fn(x) under torch.utils.checkpoint (non-reentrant). Its
  preserve_rng_state covers the default generators only, and the masks
  come from drop's explicit generator: the generator's state before the
  first call is set again for the recompute, and its state at that
  point restored after it, so the recompute draws the same masks and
  the stream goes on as if it had not run."""
  from torch.utils import checkpoint

  generator = None if drop is None else drop.generator
  if generator is None:
    return checkpoint.checkpoint(fn, x, use_reentrant=False,
                                 preserve_rng_state=False)
  before = generator.get_state()
  calls = []

  def run(inp):
    if not calls:
      calls.append(1)
      return fn(inp)
    after = generator.get_state()
    generator.set_state(before)
    try:
      return fn(inp)
    finally:
      generator.set_state(after)

  return checkpoint.checkpoint(run, x, use_reentrant=False,
                               preserve_rng_state=False)


class LayerNorm(nn.Module):
  """Flax LayerNorm (float32 statistics, E[x^2] - E[x]^2 variance)."""

  def __init__(self, features: int, device):
    super().__init__()
    self.scale = nn.Parameter(torch.ones(features, device=device),
                              requires_grad=False)
    self.bias = _param(features, device=device)

  def forward(self, x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    mean = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + _LN_EPS) * self.scale
    return (x - mean) * mul + self.bias


class EncoderStack(nn.Module):
  """N x (banded self-attention + FFN) with ReZero wrappers; the final
  LayerNorm is `output_normalization`. Sublayers are siblings of their
  wrappers, as in the Flax tree."""

  def __init__(self, params, device):
    super().__init__()
    self.num_layers = params.num_hidden_layers
    self.remat = bool(params.get('remat', False))
    quantized = params.get('quantize_matmuls') == 'int8'
    softmax_dtype = fwa.resolve_softmax_dtype(
        params.get('attn_softmax_dtype'))
    for n in range(self.num_layers):
      self.add_module(f'self_attention_{n}', BandedSelfAttention(
          params.hidden_size, params.num_heads,
          params.attn_win_size or None, device,
          bool(params.get('use_pallas_attention', False)), quantized,
          softmax_dtype))
      self.add_module(f'attention_wrapper_{n}', ResidualWrapper(device))
      self.add_module(f'ffn_{n}', FeedForward(
          params.hidden_size, params.filter_size, device, quantized))
      self.add_module(f'ffn_wrapper_{n}', ResidualWrapper(device))
    self.output_normalization = LayerNorm(params.hidden_size, device)

  def layer(self, kind: str, n: int) -> nn.Module:
    return getattr(self, f'{kind}_{n}')

  def forward(self, x: torch.Tensor, dtype,
              ragged_widths: Optional[torch.Tensor] = None,
              ragged_buckets: Tuple[int, ...] = (),
              drop: Optional[Dropout] = None,
              plain: bool = False) -> torch.Tensor:
    """remat (a training lever, never on ragged slots) recomputes each
    sublayer in the backward pass."""
    remat = (self.remat and ragged_widths is None
             and torch.is_grad_enabled())
    for n in range(self.num_layers):
      def attention(x, n=n):
        return self.layer('attention_wrapper', n)(
            x, self.layer('self_attention', n)(x, dtype, ragged_widths,
                                               ragged_buckets, drop, plain),
            drop)

      def ffn(x, n=n):
        return self.layer('ffn_wrapper', n)(
            x, self.layer('ffn', n)(x, dtype, drop), drop)

      for sublayer in (attention, ffn):
        x = _checkpointed(sublayer, x, drop) if remat else sublayer(x)
    return self.output_normalization(x)

  def kernel_blocks(self) -> Tuple[feb.EncoderBlockWeights, ...]:
    """K2's per-block weights: the layer-0 FFN-only remainder (K1 ran
    attention 0), then one full block per further layer. Quantized
    matmuls give their int8 values and scales, as the reference's
    blocks_from_params picks them from the 'quant' collection."""
    blocks = []
    for n in range(self.num_layers):
      ffn = self.layer('ffn', n)
      attn = [None] * 5
      if n:
        a = self.layer('self_attention', n)
        attn = [a.query.kernel_operand(), a.key.kernel_operand(),
                a.value.kernel_operand(), a.output_transform.kernel_operand(),
                self.layer('attention_wrapper', n).alpha]
      blocks.append(feb.EncoderBlockWeights(
          *attn,
          w_filter=ffn.filter_layer.kernel_operand(),
          b_filter=ffn.filter_layer.bias,
          w_output=ffn.output_layer.kernel_operand(),
          b_output=ffn.output_layer.bias,
          ffn_alpha=self.layer('ffn_wrapper', n).alpha,
      ))
    return tuple(blocks)


_EMBEDDINGS = (
    # (flag, module name, vocab key or size, width key)
    ('use_bases', 'bases', None, 'per_base_hidden_size'),
    ('use_pw', 'pw', 'PW_MAX', 'pw_hidden_size'),
    ('use_ip', 'ip', 'IP_MAX', 'ip_hidden_size'),
    ('use_strand', 'strand', 'STRAND_MAX', 'strand_hidden_size'),
    ('use_ccs_bq', 'ccs_bq', 'CCS_BQ_MAX', 'ccs_bq_hidden_size'),
    ('use_sn', 'sn', 'SN_MAX', 'sn_hidden_size'),
)


class DeepConsensusModel(nn.Module):
  """Encoder-only transformer with learned per-feature embeddings.

  Input: rows [B, total_rows, L] (or [..., 1]) raw pileup values;
  output: per-position softmax over {gap, A, T, C, G}, float32.
  """

  def __init__(self, params, device=None):
    super().__init__()
    if 'transformer_learn_values' not in params.model_name:
      raise NotImplementedError(
          f'model {params.model_name!r} is not ported yet; the port runs '
          'the transformer_learn_values family (ROADMAP: tail modules)')
    if not (params.condense_transformer_input and params.rezero):
      raise NotImplementedError(
          'the port runs the condensed ReZero transformer only')
    # Any set normalize_window_buckets accepts: each bucket runs on its
    # own (per-bucket dispatch); ragged slots check their divisibility
    # chain where they pack.
    config_lib.resolve_window_buckets(params)
    if params.get('quantize_matmuls') not in (None, 'none', 'int8'):
      raise NotImplementedError(
          f'quantize_matmuls {params.quantize_matmuls!r}: the port '
          'quantizes to int8 only')
    self.softmax_dtype = fwa.resolve_softmax_dtype(
        params.get('attn_softmax_dtype'))
    device = resolve_device(device)
    self.params = params
    self.device = device
    self.compute_dtype = fwa.resolve_dtype(params.get('dtype', 'float32'))
    for flag, name, vocab_key, width_key in _EMBEDDINGS:
      if name == 'bases':
        enabled = params.use_bases or params.use_ccs
        vocab = constants.SEQ_VOCAB_SIZE
      else:
        enabled = params[flag]
        vocab = params[vocab_key] + (0 if name == 'ccs_bq' else 1)
      if enabled:
        self.add_module(f'{name}_embedding',
                        MaskedEmbed(vocab, params[width_key], device))
    specs, _, cond_in = fwa.build_family_specs(params)
    self.specs = specs
    self.condenser = Dense((cond_in,), (params.transformer_input_size,),
                           False, device)
    self.encoder = EncoderStack(params, device)
    self.logits = Dense((params.hidden_size,), (constants.SEQ_VOCAB_SIZE,),
                        True, device)

  @torch.no_grad()
  def init_weights(self, generator: torch.Generator,
                   alpha_range: Tuple[float, float] = (0.1, 0.3)) -> None:
    """Seeded random init (the repository ships no trained weights):
    embeddings N(0, 1/width), projections Glorot-uniform, FFN
    N(0, 1/fan_in) with zero bias, LayerNorm identity. ReZero alphas are
    drawn from alpha_range, not zero as in a fresh Flax init: with
    alpha = 0 every residual branch would be multiplied away. The
    default range is small (ReZero alphas start at 0 and grow in
    training); with alphas in U(0.5, 1) the random model's top two
    classes come so close so often that bfloat16 rounding flips more
    than 1% of its base calls (PERF.md)."""

    def draw(t, fn):
      t.copy_(fn(torch.empty(t.shape), generator).to(t.device))

    for name, p in self.named_parameters():
      if name.endswith('embedding'):
        std = p.shape[1] ** -0.5
        draw(p, lambda t, g, s=std: t.normal_(0.0, s, generator=g))
      elif name.endswith('alpha'):
        lo, hi = alpha_range
        draw(p, lambda t, g: t.uniform_(lo, hi, generator=g))
      elif name.endswith('.kernel'):
        fan_in = p.shape[0]
        if 'output_transform' in name:
          fan_in *= p.shape[1]
        fan_out = p.numel() // fan_in
        if '.ffn_' in name:
          std = fan_in ** -0.5
          draw(p, lambda t, g, s=std: t.normal_(0.0, s, generator=g))
        else:
          bound = (6.0 / (fan_in + fan_out)) ** 0.5
          draw(p, lambda t, g, b=bound: t.uniform_(-b, b, generator=g))
      elif name.endswith('scale'):
        p.fill_(1.0)
      else:
        p.zero_()

  def tables(self):
    _, table_keys, _ = fwa.build_family_specs(self.params)
    return {k: getattr(self, f'{k}_embedding').embedding
            for k in table_keys}, table_keys

  def use_fused(self, device: torch.device, length: int,
                ragged: bool = False, plain: bool = False) -> bool:
    """The fused route (K1 or K4, then K2): windows of at most
    FUSED_MAX_WINDOW_LEN positions (ragged slots: RAGGED_MAX_SLOT_LEN),
    as the reference's _fused_hotpath_eligible, on the card, through
    the plain versions (plain), or on the CPU with use_fused_hotpath."""
    limit = (rwa.RAGGED_MAX_SLOT_LEN if ragged
             else config_lib.FUSED_MAX_WINDOW_LEN)
    return length <= limit and (
        plain or device.type == 'cuda'
        or bool(self.params.get('use_fused_hotpath', False)))

  def _embed_rows(self, rows: torch.Tensor) -> torch.Tensor:
    """[B, R, L] -> [B, L, cond_in] in the family concat order."""
    blocks = []
    for spec in self.specs:
      table = 'bases' if spec.name == 'ccs' else spec.name
      ids = rows[:, spec.row_start:spec.row_start + spec.n_rows].to(
          torch.int32) + spec.shift
      emb = getattr(self, f'{table}_embedding')(ids, self.compute_dtype)
      b, r, l, e = emb.shape
      blocks.append(emb.permute(0, 2, 1, 3).reshape(b, l, r * e))
    return torch.cat(blocks, dim=-1)

  def _position_encoding(self, length: int, dtype, device) -> torch.Tensor:
    pos = sinusoidal_position_encoding(length, self.params.hidden_size)
    return torch.from_numpy(pos).to(device=device, dtype=dtype)

  def encode(self, rows: torch.Tensor, plain: bool = False,
             window_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Encoder output after the final LayerNorm, float32 [B, L, H].
    plain=True runs the kernels' plain versions on any device (the
    on-card reference run): the fused route's, or K8's on the module
    route of wider windows. window_lengths [B, wps]: rows are ragged
    slots (module docstring)."""
    p = self.params
    dt = self.compute_dtype
    if rows.dim() == 4:
      rows = rows.squeeze(-1)
    length = rows.shape[-1]
    pos = (self._position_encoding(length, dt, rows.device)
           if p.add_pos_encoding else None)
    lengths = None
    if window_lengths is not None:
      lengths = window_lengths.to(device=rows.device, dtype=torch.int32)
    win = p.attn_win_size or None
    if not self.use_fused(rows.device, length, lengths is not None, plain):
      x = self.condenser(self._embed_rows(rows), 1, dt)
      if lengths is None:
        if pos is not None:
          x = x + pos
        return self.encoder(x, dt, plain=plain)
      # Only widths that tile the slot are recoverable by reshape.
      buckets = rwa.validate_ragged_buckets(tuple(
          b for b in config_lib.resolve_window_buckets(p) if length % b == 0))
      _, start, width, valid = rwa.slot_geometry(lengths, length)
      if pos is not None:
        off = torch.clamp(torch.arange(length, device=rows.device)
                          - start.long(), 0, length - 1)
        x = x + torch.where(valid[:, :, None], pos[off],
                            torch.zeros((), dtype=x.dtype))
      return self.encoder(x, dt, ragged_widths=width, ragged_buckets=buckets)
    tables, table_keys = self.tables()
    attn0 = self.encoder.layer('self_attention', 0)
    k1_args = (tables, self.condenser.matrix(), attn0.query.matrix(),
               attn0.key.matrix(), attn0.value.matrix(),
               attn0.output_transform.matrix(), pos)
    k1_kw = dict(specs=self.specs, table_keys=table_keys,
                 num_heads=p.num_heads, attn_win_size=win,
                 softmax_dtype=self.softmax_dtype, compute_dtype=dt)
    if lengths is None:
      k1 = (fwa.fused_embed_condense_attention_plain if plain
            else fwa.fused_embed_condense_attention)
      x_base, attn_out = k1(rows, *k1_args, **k1_kw)
    else:
      k4 = (rwa.ragged_embed_condense_attention_plain if plain
            else rwa.ragged_embed_condense_attention)
      x_base, attn_out = k4(rows, lengths, *k1_args, **k1_kw)
    alpha0 = self.encoder.layer('attention_wrapper', 0).alpha
    x = x_base + alpha0.to(x_base.dtype) * attn_out
    k2 = (feb.fused_encoder_stack_plain if plain
          else feb.fused_encoder_stack)
    x = k2(x, self.encoder.kernel_blocks(), num_heads=p.num_heads,
           attn_win_size=win, softmax_dtype=self.softmax_dtype,
           compute_dtype=dt, lengths=lengths)
    return self.encoder.output_normalization(x)

  def forward_train(self, rows: torch.Tensor,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """The training forward: module route on any device (attention
    through K5-K10 with use_pallas_attention), differentiable
    (the caller sets requires_grad on the parameters), dropout drawn
    from `generator` (on the rows' device); without a generator no
    dropout, the reference's eval forward. Returns float32 softmax
    [B, L, V]."""
    p = self.params
    dt = self.compute_dtype
    if rows.dim() == 4:
      rows = rows.squeeze(-1)
    drop = None if generator is None else Dropout(p, generator)
    x = self.condenser(self._embed_rows(rows), 1, dt)
    if p.add_pos_encoding:
      x = x + self._position_encoding(rows.shape[-1], dt, rows.device)
    if drop is not None:
      x = drop(x, 'post')
    encoded = self.encoder(x, dt, drop=drop)
    return torch.softmax(self.logits(encoded, 1, torch.float32), dim=-1)

  @torch.no_grad()
  def forward(self, rows: torch.Tensor, plain: bool = False,
              window_lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    encoded = self.encode(rows, plain=plain, window_lengths=window_lengths)
    logits = self.logits(encoded, 1, torch.float32)
    return torch.softmax(logits, dim=-1)


def inference_model(params, state, device=None) -> DeepConsensusModel:
  """DeepConsensusModel(params) in eval mode holding `state` with its
  dtypes as they are (bfloat16 parameters under inference_dtype, the
  int8 values of quantized matmuls), moved to the device; the state
  comes from models/quantize.prepare_inference_variables."""
  model = DeepConsensusModel(params, device=device)
  model.load_state_dict({k: v.to(model.device) for k, v in state.items()},
                        assign=True)
  return model.eval()
