"""The tensor-core GEMMs' split arithmetic held against the JAX package.

csrc/mma_gemm.cuh splits each float32 operand into bf16 pieces (x1 =
bf16(x), x2 = bf16(x - x1), x3 = bf16(x - x1 - x2)) and sums the
pieces' products, each exact in a bf16 MMA, in float32. Those kernels
run only on the card (tests/test_torch_gpu.py). Here a plain emulation
of their arithmetic (pieces formed in torch, products summed in float64)
is held against the reference's `_dequant_matmul`
(deepconsensus_tpu/ops/fused_encoder_block.py) run on the CPU, on
seeded numpy inputs, and `_kernels.split_pieces`, which picks the piece
counts, is checked for every operand combination.

Bounds, elementwise, in units of (|A| @ |B|) * |scale|:
  3 pieces of A x an int8 or bf16 B, and 3 x 3 pieces with 6 products:
    the emulation equals the float64 product (to 2^-23 for the 6
    products, which drop terms below 2^-24), so it differs from JAX
    only by JAX's float32 summation, bounded by (K + 2) * 2^-24;
  2 pieces of A: 2^-16 (A to 16 bits, <= 2^-17, plus that summation).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepconsensus_tpu.ops import fused_encoder_block as jax_feb
from deepconsensus_tpu_torch.ops import _kernels

SHAPES = [(37, 280, 840), (16, 2048, 280)]


def pieces(t: torch.Tensor, n: int):
  """t as n bf16 pieces, largest first, each widened to float32 as the
  kernel widens it; every remainder is exact in float32."""
  out, rest = [], t.float()
  for _ in range(n):
    piece = rest.to(torch.bfloat16).float()
    out.append(piece)
    rest = rest - piece
  return out


def emulate(a: torch.Tensor, b: torch.Tensor, a_pieces: int,
            b_pieces: int) -> torch.Tensor:
  """The kernel's product: the piece products p + q < max(counts),
  summed in float64 (the MMAs' products are exact)."""
  ap, bp = pieces(a, a_pieces), pieces(b, b_pieces)
  terms = max(a_pieces, b_pieces)
  total = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float64)
  for p in range(a_pieces):
    for q in range(b_pieces):
      if p + q < terms:
        total += ap[p].double() @ bp[q].double()
  return total


def operands(shape, b_kind: str, seed: int):
  """Seeded float32 A, B values as their type holds them (int8 values,
  bf16-rounded, or float32) and an int8 column scale (else None)."""
  m, k, n = shape
  rng = np.random.default_rng(seed)
  a = rng.normal(0, 1, (m, k)).astype(np.float32)
  if b_kind == 'int8':
    b = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scale = rng.uniform(0.5, 1.5, n).astype(np.float32) / 127
    return a, b, scale
  b = rng.normal(0, k ** -0.5, (k, n)).astype(np.float32)
  if b_kind == 'bf16':
    b = torch.from_numpy(b).to(torch.bfloat16).float().numpy()
  return a, b, None


def jax_product(a, b, scale) -> np.ndarray:
  """The reference: _dequant_matmul on the CPU, (a @ values) * scale."""
  out = jax_feb._dequant_matmul(
      jnp.asarray(a), jnp.asarray(b),
      None if scale is None else jnp.asarray(scale))
  return np.asarray(out, dtype=np.float64)


def magnitude(a, b, scale) -> np.ndarray:
  mag = np.abs(a.astype(np.float64)) @ np.abs(b.astype(np.float64))
  return mag if scale is None else mag * np.abs(scale.astype(np.float64))


def scaled(product: torch.Tensor, scale) -> np.ndarray:
  out = product.numpy()
  return out if scale is None else out * scale.astype(np.float64)


@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('b_kind', ['int8', 'bf16'])
def test_three_pieces_are_the_reference_product(shape, b_kind):
  """A float32 run's A (3 pieces) times an int8 or bf16 B (1 piece):
  exact, so only JAX's float32 summation order separates the two."""
  a, b, scale = operands(shape, b_kind, seed=shape[1] + len(b_kind))
  a_t, b_t = torch.from_numpy(a), torch.from_numpy(b.astype(np.float32))
  assert _kernels.split_pieces(
      torch.float32, torch.int8 if b_kind == 'int8' else torch.bfloat16,
      torch.float32) == (3, 1)
  got = emulate(a_t, b_t, 3, 1)
  exact = a_t.double() @ b_t.double()
  mag = magnitude(a, b, scale)
  assert np.all(np.abs(scaled(got, scale) - scaled(exact, scale))
                <= 1e-12 * mag)
  err = np.abs(scaled(got, scale) - jax_product(a, b, scale))
  assert np.all(err <= (shape[1] + 2) * 2.0 ** -24 * mag)


@pytest.mark.parametrize('shape', SHAPES)
@pytest.mark.parametrize('b_kind', ['int8', 'bf16'])
def test_two_pieces_within_two_to_minus_16(shape, b_kind):
  """A bfloat16 run's float32 A (2 pieces): within 2^-16 of
  |A| @ |B| of the reference, and not exact (the bound is used)."""
  a, b, scale = operands(shape, b_kind, seed=shape[1] * 3 + len(b_kind))
  a_t, b_t = torch.from_numpy(a), torch.from_numpy(b.astype(np.float32))
  assert _kernels.split_pieces(
      torch.float32, torch.int8 if b_kind == 'int8' else torch.bfloat16,
      torch.bfloat16) == (2, 1)
  got = scaled(emulate(a_t, b_t, 2, 1), scale)
  want = jax_product(a, b, scale)
  mag = magnitude(a, b, scale)
  assert np.all(np.abs(got - want) <= 2.0 ** -16 * mag)
  exact = scaled(a_t.double() @ b_t.double(), scale)
  assert np.abs(got - exact).max() > 0


@pytest.mark.parametrize('shape', SHAPES)
def test_six_products_of_float32_operands(shape):
  """float32 x float32 (the float K2 in a float32 run): 3 pieces each,
  the 6 products above 2^-24 kept; within 2^-23 of the float64 product
  and within JAX's own summation error of the reference."""
  a, b, _ = operands(shape, 'f32', seed=shape[1] + 11)
  a_t, b_t = torch.from_numpy(a), torch.from_numpy(b)
  assert _kernels.split_pieces(torch.float32, torch.float32,
                               torch.float32) == (3, 3)
  got = emulate(a_t, b_t, 3, 3).numpy()
  mag = magnitude(a, b, None)
  exact = (a_t.double() @ b_t.double()).numpy()
  assert np.all(np.abs(got - exact) <= 2.0 ** -23 * mag)
  want = jax_product(a, b, None)
  assert np.all(np.abs(got - want) <= (shape[1] + 2) * 2.0 ** -24 * mag)


def test_three_pieces_rebuild_every_float32():
  """The split is exact: three pieces sum back to the float32 value, at
  every magnitude from 2^-100 to 2^100 and for both signs."""
  rng = np.random.default_rng(5)
  x = (rng.uniform(1, 2, 4096) * 2.0 ** rng.integers(-100, 101, 4096)
       * rng.choice([-1, 1], 4096)).astype(np.float32)
  t = torch.from_numpy(x)
  total = sum(p.double() for p in pieces(t, 3))
  assert torch.equal(total, t.double())
  two = sum(p.double() for p in pieces(t, 2))
  assert torch.all((two - t.double()).abs() <= 2.0 ** -17 * t.double().abs())


F32, BF16, I8 = torch.float32, torch.bfloat16, torch.int8


@pytest.mark.parametrize('a_dtype,b_dtype,compute,want', [
    (F32, F32, F32, (3, 3)),
    (F32, F32, BF16, (3, 3)),
    (F32, BF16, F32, (3, 1)),
    (F32, BF16, BF16, (2, 1)),
    (F32, I8, F32, (3, 1)),
    (F32, I8, BF16, (2, 1)),
    (BF16, F32, F32, (1, 3)),
    (BF16, F32, BF16, (1, 3)),
    (BF16, BF16, F32, (1, 1)),
    (BF16, BF16, BF16, (1, 1)),
    (BF16, I8, F32, (1, 1)),
    (BF16, I8, BF16, (1, 1)),
])
def test_split_pieces_for_every_operand_pair(a_dtype, b_dtype, compute,
                                             want):
  assert _kernels.split_pieces(a_dtype, b_dtype, compute) == want


@pytest.mark.parametrize('a_dtype,b_dtype', [(I8, F32), (F32, torch.float16),
                                             (torch.float64, F32)])
def test_split_pieces_rejects_types_without_a_split(a_dtype, b_dtype):
  with pytest.raises(ValueError, match='no bf16 split'):
    _kernels.split_pieces(a_dtype, b_dtype, F32)
