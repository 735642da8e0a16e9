#
# The part of `jax.random` the forests draw from, as torch ops on any
# device: `prng_key` (jax.random.PRNGKey), `fold_in`, `split`,
# `random_bits` (32 and 64 bits), `uniform` in float32 and float64, and
# `permutation` of a range. Threefry-2x32 with 20 rounds, in the layout
# JAX uses under `jax_threefry_partitionable=True` (its default):
#
#   * a key is two uint32 words (k1, k2); `prng_key(seed)` is
#     (seed >> 32, seed & 0xffffffff);
#   * the counter of element i of a draw of shape s is i, the flat index,
#     split into its (hi, lo) words; the hash gives two words (b1, b2);
#   * a 32-bit draw is b1 ^ b2, a 64-bit draw b1 << 32 | b2;
#   * `fold_in(k, d)` is the hash of the counter (0, d), `split(k)` the
#     hashes of (0, 0) and (0, 1);
#   * `uniform` keeps the top mantissa bits of a draw of its width under
#     the exponent of 1.0 and subtracts 1;
#   * `permutation(k, n)` sorts arange(n) stably on fresh 32-bit draws,
#     ceil(3 ln n / ln(2^32 − 1)) times, splitting the key each time.
#
# The words are kept in int64 tensors and masked to 32 bits after each
# add and shift, so the same ops run on the CPU and the card and give the
# same bits. Nothing here imports jax; tests/test_torch_trees.py holds it
# to `jax.random` bit for bit.
#
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(key: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter words (x1, x2)
    under `key` [2]: two word tensors of x1's shape."""
    k1, k2 = key[0], key[1]
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for step in range(5):
        for r in _ROTATIONS[step % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(step + 1) % 3]) & _MASK
        x2 = (x2 + ks[(step + 2) % 3] + step + 1) & _MASK
    return x1, x2


def prng_key(seed: int, device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """jax.random.PRNGKey(seed): the words (seed >> 32, seed & 0xffffffff)."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK], dtype=torch.int64, device=device)


def _counters(shape: Sequence[int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (hi, lo) words of the flat index of every element of `shape`."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device).reshape(tuple(shape))
    return idx >> 32, idx & _MASK


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """jax.random.fold_in(key, data): the hash of the counter (0, data)."""
    zero = torch.zeros(1, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(key, zero, zero + (int(data) & _MASK))
    return torch.cat([y1, y2])


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split(key, num): [num, 2], key i the hash of (0, i)."""
    hi, lo = _counters((num,), key.device)
    y1, y2 = threefry2x32(key, hi, lo)
    return torch.stack([y1, y2], dim=1)


def random_bits(key: torch.Tensor, bit_width: int, shape: Sequence[int]) -> torch.Tensor:
    """jax.random.bits at 32 bits (b1 ^ b2, as int64 in [0, 2^32)) or 64
    bits (b1 << 32 | b2, as the int64 of the same bits)."""
    hi, lo = _counters(shape, key.device)
    b1, b2 = threefry2x32(key, hi, lo)
    if bit_width == 32:
        return b1 ^ b2
    if bit_width == 64:
        return (b1 << 32) | b2
    raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")


def uniform(key: torch.Tensor, shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
    """jax.random.uniform(key, shape, dtype) on [0, 1), float32 or float64."""
    if dtype == torch.float64:
        # the top 52 of the 64 bits (a logical shift of the int64's bits)
        mant = (random_bits(key, 64, shape) >> 12) & ((1 << 52) - 1)
        return (mant | 0x3FF0000000000000).view(torch.float64) - 1.0
    if dtype == torch.float32:
        mant = random_bits(key, 32, shape) >> 9
        return (mant | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    raise ValueError(f"uniform draws float32 or float64, got {dtype}")


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """jax.random.permutation(key, n): arange(n) stably sorted on fresh
    32-bit draws, as many rounds as JAX's `_shuffle` takes."""
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(_MASK)))
    for _ in range(rounds):
        key, subkey = split(key)
        order = torch.sort(random_bits(subkey, 32, (n,)), stable=True).indices
        x = x[order]
    return x
