"""Load-time inference levers: bfloat16 weights and int8 matmuls.

Port of deepconsensus_tpu/models/quantize.py on the port's state dict
(names follow the Flax tree, models/weights.py). Both levers apply once,
at load, before the weights go to the device:

* `params.inference_dtype = 'bfloat16'`: every float parameter is cast
  to bfloat16 (`cast_params`); the runner also sets the compute dtype.
* `params.quantize_matmuls = 'int8'`: per-output-channel symmetric
  quantization of each encoder layer's six matmul kernels (query, key,
  value, output_transform, filter_layer, output_layer):
  scale[n] = max|W[:, n]| / 127 (1 where the column is zero), values =
  round-half-even(W / scale) clipped to +-127, in int8. The parameter
  is replaced by the dequantized weight, values * scale in float32, so
  the module route (and K1, which reads layer 0's attention weights)
  sees the quantized model; the int8 values and float32 scales ride
  beside it as `<module>.quant_values` / `<module>.quant_scale`
  (the reference's 'quant' collection), which the model keeps as
  buffers and K2 reads (ops/fused_encoder_block.py).

Attention kernels quantize in their 2-D matmul form: query/key/value
[H, heads, hd] -> [H, H], output_transform [heads, hd, H] -> [H, H].
The int8 step runs on the float32 weights first, then the bfloat16
cast rounds the dequantized leaves, never the int8 values or scales.
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch

from deepconsensus_tpu_torch.ops import fused_window_attention as fwa

_ATTN_SUBS = ('query', 'key', 'value', 'output_transform')
_FFN_SUBS = ('filter_layer', 'output_layer')
# The buffers of models/model.py's Dense that hold a quantized kernel's
# int8 values and float32 scales, beside its `kernel` parameter.
QUANT_VALUES = 'quant_values'
QUANT_SCALE = 'quant_scale'


def _quantize_2d(w2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
  """[K, N] float -> (int8 values [K, N], float32 scale [N])."""
  w2 = w2.to(torch.float32)
  scale = w2.abs().amax(dim=0) / 127.0
  scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
  values = torch.clamp(torch.round(w2 / scale), -127, 127).to(torch.int8)
  return values, scale


def quantized_modules(num_layers: int) -> Iterator[str]:
  """The state-dict prefixes of the encoder matmuls that int8 covers,
  in the reference's order."""
  for n in range(num_layers):
    for sub in _ATTN_SUBS:
      yield f'encoder.self_attention_{n}.{sub}'
    for sub in _FFN_SUBS:
      yield f'encoder.ffn_{n}.{sub}'


def quantize_matmul_params(state: Dict[str, torch.Tensor], num_layers: int
                           ) -> Tuple[Dict[str, torch.Tensor], int]:
  """int8-quantizes the encoder matmul kernels of a state dict. Returns
  (a new state dict: dequantized kernels plus the int8 values and
  scales, number of quantized matmuls)."""
  state = dict(state)
  n_quantized = 0
  for prefix in quantized_modules(num_layers):
    key = f'{prefix}.kernel'
    if key not in state:
      continue
    kernel = state[key]
    if prefix.endswith('output_transform'):
      w2 = kernel.reshape(-1, kernel.shape[-1])
    else:
      w2 = kernel.reshape(kernel.shape[0], -1)
    values, scale = _quantize_2d(w2)
    state[key] = (values.to(torch.float32) * scale).reshape(
        kernel.shape).to(kernel.dtype)
    state[f'{prefix}.{QUANT_VALUES}'] = values
    state[f'{prefix}.{QUANT_SCALE}'] = scale
    n_quantized += 1
  return state, n_quantized


def _is_quant(name: str) -> bool:
  return name.endswith((QUANT_VALUES, QUANT_SCALE))


def cast_params(state: Dict[str, torch.Tensor], dtype
                ) -> Dict[str, torch.Tensor]:
  """Casts every float parameter to dtype; the int8 values and their
  float32 scales stay as they are."""
  dtype = fwa.resolve_dtype(dtype)
  return {name: t.to(dtype) if t.is_floating_point() and not _is_quant(name)
          else t for name, t in state.items()}


def prepare_inference_variables(state: Dict[str, torch.Tensor], params
                                ) -> Tuple[Dict[str, torch.Tensor], int]:
  """Applies the configured levers to a loaded state dict: int8 first,
  on the float32 weights (full-precision scales), then the bfloat16
  cast. Returns (state, number of quantized matmuls: 6 per layer)."""
  n_quantized = 0
  quantize = params.get('quantize_matmuls')
  if quantize not in (None, 'none', 'int8'):
    raise NotImplementedError(
        f'quantize_matmuls {quantize!r}: the port quantizes to int8 only')
  if quantize == 'int8':
    state, n_quantized = quantize_matmul_params(
        state, params.num_hidden_layers)
  inference_dtype = params.get('inference_dtype')
  if inference_dtype and fwa.resolve_dtype(inference_dtype) != torch.float32:
    state = cast_params(state, inference_dtype)
  return state, n_quantized
