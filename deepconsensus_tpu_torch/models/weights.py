"""Weight bridge between the reference's Flax params tree and the port.

The reference package's checkpoints hold `variables['params']`, a nested
dict of arrays (`jax.device_get` gives numpy). The port's model keeps
the same names and layouts, so the bridge is a rename from '/'-paths to
'.'-paths, checked leaf by leaf against the model's own parameters:

  *_embedding/embedding, condenser/kernel,
  encoder/self_attention_{n}/{query,key,value,output_transform}/kernel,
  encoder/{attention,ffn}_wrapper_{n}/alpha,
  encoder/ffn_{n}/{filter,output}_layer/{kernel,bias},
  encoder/output_normalization/{scale,bias}, logits/{kernel,bias}

`save_npz`/`load_npz` store such a tree as one .npz with '/'-joined
keys, so `cli run --weights w.npz --params params.json` needs no orbax;
`cli train` writes its trained weights the same way.
`gradients_to_flax` maps the port's gradients onto the same tree.
The attention kernels (use_pallas_attention, K5-K7) add no parameters:
a tree from a model with the flag on or off loads the same way.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def flatten_tree(tree: Mapping[str, Any], prefix: str = '') -> Dict[str, Any]:
  """Nested dict -> {'a/b/c': leaf}."""
  flat = {}
  for key, value in tree.items():
    path = f'{prefix}/{key}' if prefix else str(key)
    if isinstance(value, Mapping):
      flat.update(flatten_tree(value, path))
    else:
      flat[path] = value
  return flat


def unflatten_tree(flat: Mapping[str, Any]) -> Dict[str, Any]:
  """{'a/b/c': leaf} -> nested dict."""
  tree: Dict[str, Any] = {}
  for path, value in flat.items():
    node = tree
    *parents, leaf = path.split('/')
    for key in parents:
      node = node.setdefault(key, {})
    node[leaf] = value
  return tree


def from_flax_params(tree: Mapping[str, Any], params) -> Dict[str, torch.Tensor]:
  """Flax params tree (nested dict of arrays) -> the port's state dict
  for DeepConsensusModel(params). Raises on a missing, unexpected or
  misshapen leaf."""
  from deepconsensus_tpu_torch.models import model as model_lib

  # Parameters only: the int8 buffers of quantized matmuls come from
  # models/quantize.py, not from the tree.
  expected = dict(model_lib.DeepConsensusModel(
      params, device='meta').named_parameters())
  state = {}
  for path, value in flatten_tree(tree).items():
    name = path.replace('/', '.')
    if name not in expected:
      raise KeyError(f'unexpected parameter {path!r} for this config')
    arr = np.array(value, dtype=np.float32)
    if tuple(arr.shape) != tuple(expected[name].shape):
      raise ValueError(
          f'{path}: shape {arr.shape}, model expects '
          f'{tuple(expected[name].shape)}')
    state[name] = torch.from_numpy(arr)
  missing = sorted(set(expected) - set(state))
  if missing:
    raise KeyError(f'parameters missing from the tree: {missing}')
  return state


def to_flax_params(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
  """The port's state dict -> a Flax-layout tree of numpy arrays."""
  return unflatten_tree({
      name.replace('.', '/'): t.detach().float().cpu().numpy()
      for name, t in state.items()
  })


def gradients_to_flax(model: torch.nn.Module) -> Dict[str, Any]:
  """The gradients of a model's parameters as a Flax-layout tree, leaf
  for leaf beside jax.grad's; a parameter without a gradient gives
  zeros, as jax.grad does."""
  return to_flax_params({
      name: p.grad if p.grad is not None else torch.zeros_like(p)
      for name, p in model.named_parameters()
  })


def save_npz(path: str, tree: Mapping[str, Any]) -> None:
  """Writes a params tree as one .npz with '/'-joined keys."""
  np.savez(path, **{k: np.asarray(v) for k, v in flatten_tree(tree).items()})


def load_npz(path: str) -> Dict[str, Any]:
  """Reads a save_npz file back into a nested params tree."""
  with np.load(path) as data:
    return unflatten_tree({k: data[k] for k in data.files})
