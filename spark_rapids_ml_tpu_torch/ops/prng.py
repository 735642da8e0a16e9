#
# The part of `jax.random` the forests, the k-means|| seeding and CAGRA
# draw from, as torch ops on any device: `prng_key` (jax.random.PRNGKey),
# `fold_in`, `split`, `random_bits` (32 and 64 bits), `uniform` in float32
# and float64 on [minval, maxval), `randint`, `gumbel`, `categorical` and
# `permutation` of a range, and the float32 log and exp of JAX's CPU
# backend (`log_f32`, `exp_f32`). Threefry-2x32 with 20 rounds, in the layout
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
#     ceil(3 ln n / ln(2^32 − 1)) times, splitting the key each time;
#   * `randint(k, shape, lo, hi)` (int32) takes two 32-bit draws a and b
#     from split(k) and returns lo + ((a mod s)·m + b mod s) mod s, s =
#     hi − lo, m = (2^16 mod s)^2 mod s, every product and sum wrapping at
#     2^32 as uint32 arithmetic does; its int64 form (JAX's under
#     jax_enable_x64) takes 64-bit draws and m = (2^32 mod s)^2 mod s;
#   * `gumbel` is −log(−log(u)), u uniform on [tiny, 1) (JAX's "low"
#     mode), and `categorical(k, logits)` the first argmax of
#     gumbel + logits.
#
# The words are kept in int64 tensors and masked to 32 bits after each
# add and shift, so the same ops run on the CPU and the card and give the
# same bits. A key may carry leading batch dimensions ([..., 2]): each
# function then draws for every key at once, as a loop over the keys
# would, in one pass of the hash. The hash also runs on plain Python ints
# (`key_chain` uses that for the short sequential key chains of k-means++,
# off the device). Nothing here imports jax; tests/test_torch_trees.py and
# tests/test_torch_ann.py hold it to `jax.random` bit for bit.
#
from __future__ import annotations

import math
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def _words(key):
    """The two key words of `key`: a tensor [..., 2] or a pair of ints."""
    if isinstance(key, tuple):
        return key
    return key[..., 0], key[..., 1]


def threefry2x32(key, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter words (x1, x2)
    under `key` ([..., 2], broadcast against the counters, or a pair of
    ints with int counters): two word tensors (or ints)."""
    k1, k2 = _words(key)
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


def _batched(key: torch.Tensor, ndim: int) -> torch.Tensor:
    """`key` [..., 2] with `ndim` unit axes before its word axis, so its
    words broadcast against counters of `ndim` dimensions."""
    return key.reshape(key.shape[:-1] + (1,) * ndim + (2,))


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """jax.random.fold_in(key, data): the hash of the counter (0, data).
    `data` may be an int or an int64 tensor; a tensor folds each of its
    values into the key (a batch of keys of its shape)."""
    if isinstance(data, torch.Tensor):
        y1, y2 = threefry2x32(_batched(key, data.dim()), 0, data & _MASK)
        return torch.stack([y1, y2], dim=-1)
    zero = torch.zeros(1, dtype=torch.int64, device=key.device)
    y1, y2 = threefry2x32(_batched(key, 1), zero, zero + (int(data) & _MASK))
    return torch.stack([y1, y2], dim=-1)[..., 0, :]


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split(key, num): [..., num, 2], key i the hash of (0, i)."""
    hi, lo = _counters((num,), key.device)
    y1, y2 = threefry2x32(_batched(key, 1), hi, lo)
    return torch.stack([y1, y2], dim=-1)


def key_chain(seed: int, draws: int) -> List[Tuple[int, int]]:
    """The keys of JAX's sequential chain `key, sub = split(key)` from
    PRNGKey(seed), `draws` times: the `sub` of each step, as int pairs,
    hashed on the host (each step depends on the one before, so it cannot
    be batched)."""
    seed = int(seed)
    key = ((seed >> 32) & _MASK, seed & _MASK)
    subs = []
    for _ in range(draws):
        subs.append(threefry2x32(key, 0, 1))
        key = threefry2x32(key, 0, 0)
    return subs


def uniform_f32_of(keys: Sequence[Tuple[int, int]]) -> np.ndarray:
    """jax.random.uniform(k, (), float32) for each int-pair key in `keys`:
    a float32 array, computed on the host."""
    bits = np.array([(lambda y: y[0] ^ y[1])(threefry2x32(k, 0, 0)) for k in keys], dtype=np.uint32)
    return ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)


def random_bits(key: torch.Tensor, bit_width: int, shape: Sequence[int]) -> torch.Tensor:
    """jax.random.bits at 32 bits (b1 ^ b2, as int64 in [0, 2^32)) or 64
    bits (b1 << 32 | b2, as the int64 of the same bits): [..., *shape] for
    a key [..., 2]."""
    hi, lo = _counters(shape, key.device)
    b1, b2 = threefry2x32(_batched(key, len(shape)), hi, lo)
    if bit_width == 32:
        return b1 ^ b2
    if bit_width == 64:
        return (b1 << 32) | b2
    raise ValueError(f"bit_width must be 32 or 64, got {bit_width}")


def uniform(
    key: torch.Tensor, shape: Sequence[int], dtype: torch.dtype, minval: float = 0.0, maxval: float = 1.0
) -> torch.Tensor:
    """jax.random.uniform(key, shape, dtype, minval, maxval), float32 or
    float64: max(minval, f·(maxval − minval) + minval), f on [0, 1), every
    step at `dtype`."""
    if dtype == torch.float64:
        # the top 52 of the 64 bits (a logical shift of the int64's bits)
        mant = (random_bits(key, 64, shape) >> 12) & ((1 << 52) - 1)
        f = (mant | 0x3FF0000000000000).view(torch.float64) - 1.0
    elif dtype == torch.float32:
        mant = random_bits(key, 32, shape) >> 9
        f = (mant | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    else:
        raise ValueError(f"uniform draws float32 or float64, got {dtype}")
    if minval == 0.0 and maxval == 1.0:
        return f  # f * 1 + 0, exactly
    lo = torch.tensor(minval, dtype=dtype, device=f.device)
    hi = torch.tensor(maxval, dtype=dtype, device=f.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def randint(
    key: torch.Tensor, shape: Sequence[int], minval: int, maxval: int, bit_width: int = 32
) -> torch.Tensor:
    """jax.random.randint(key, shape, minval, maxval, dtype) for dtype int32
    (`bit_width` 32) or int64 (64: JAX's default integer type under
    jax_enable_x64): values on [minval, maxval) (minval when maxval <=
    minval), as int64. At 64 bits the span must be below 2^31, so the
    arithmetic stays inside int64 (a 64-bit draw mod s is taken from its
    32-bit words)."""
    k = split(key)
    span = int(maxval) - int(minval) if int(maxval) > int(minval) else 1
    if bit_width == 32:
        span &= _MASK
        a = random_bits(k[..., 0, :], 32, shape)
        b = random_bits(k[..., 1, :], 32, shape)
        mult = (1 << 16) % span
        mult = ((mult * mult) & _MASK) % span
        off = ((((a % span) * mult) & _MASK) + b % span) & _MASK
        return int(minval) + off % span
    if bit_width != 64 or span >= 1 << 31:
        raise ValueError(f"randint draws 32 bits, or 64 bits for a span below 2^31; got {bit_width}, {span}")
    word = (1 << 32) % span

    def mod_span(k_):  # (b1 << 32 | b2) mod span
        hi, lo = _counters(shape, key.device)
        b1, b2 = threefry2x32(_batched(k_, len(shape)), hi, lo)
        return ((b1 % span) * word + b2 % span) % span

    # every term below 2^62: no wrap, as in JAX's uint64 arithmetic here
    return int(minval) + (mod_span(k[..., 0, :]) * (word * word % span) + mod_span(k[..., 1, :])) % span


# float32 constants of Cephes' logf, as Eigen's plog_float (the float32
# log of JAX's CPU backend) holds them
_LOG_SQRTHF = 0.707106781186547524
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
          -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375


def _fma(a, b, c) -> torch.Tensor:
    """a·b + c rounded once to float32, as an FMA instruction: the float32
    product is exact in float64 and the sum rounds there first (a double
    rounding that differs from one rounding only on a float32 midpoint).
    A Python float is a float32 constant, rounded to float32 first."""
    a, b, c = (v.double() if isinstance(v, torch.Tensor) else float(np.float32(v)) for v in (a, b, c))
    return (a * b + c).float()


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """The float32 natural log as JAX computes it on the CPU: Eigen's
    plog_float (Cephes' polynomial), with each multiply-add fused as XLA's
    compiler fuses it, one step at a time in the same order, so it gives
    the same bits on the CPU and the card, where `torch.log` gives others in
    about one value in four: the exponent and a mantissa m in [sqrt(1/2),
    sqrt(2)), then y = m - 1 through a degree-8 polynomial in three
    interleaved parts. 0 gives -inf, +inf itself, a negative or NaN input
    NaN."""
    f32 = torch.float32
    xc = torch.where(x > torch.finfo(f32).tiny, x, torch.finfo(f32).tiny)
    bits = xc.view(torch.int32)
    e = ((bits >> 23) - 127).to(f32) + 1.0
    m = ((bits & -2139095041) | 0x3F000000).view(f32)  # the mantissa under the exponent of 0.5
    small = m < _LOG_SQRTHF
    e = e - small.to(f32)
    y = (m - 1.0) + torch.where(small, m, 0.0)
    y2 = y * y
    y3 = y2 * y
    p = [_fma(y, _LOG_P[3 * j], _LOG_P[3 * j + 1]) for j in range(3)]
    p = [_fma(p[j], y, _LOG_P[3 * j + 2]) for j in range(3)]
    r = _fma(_fma(_fma(p[0], y3, p[1]), y3, p[2]), y3, e * _LOG_Q1)
    r = _fma(e, _LOG_Q2, _fma(y2, -0.5, y) + r)
    r = torch.where(x < 0, float("nan"), r)
    return torch.where((x == 0) | (x == float("inf")), torch.log(x), r)


# Cephes' expf constants, as XLA's CPU backend evaluates float32 exp
_EXP_LIMIT = 88.72283905206835
_EXP_LOG2E = 1.44269504088896341
_EXP_C1, _EXP_C2 = -0.693359375, 2.12194440e-4
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """The float32 exp as JAX computes it on the CPU: Cephes' expf with
    every multiply-add fused, on x clamped to ±88.72: m = floor(x·log2(e)
    + 1/2), r = x - m·ln2 in two fused parts, a degree-5 polynomial in r,
    scaled by 2^m; results below the smallest normal float32 flushed to
    0, as XLA's CPU code runs with denormals flushed. Bit for bit with
    `jnp.exp` on every x <= 80 (above ~88.4 its last bit may differ), on
    the CPU and the card alike, where `torch.exp` gives others in about one
    value in ten. NaN stays NaN."""
    xc = torch.clamp(x, -_EXP_LIMIT, _EXP_LIMIT)
    m = torch.floor(_fma(xc, _EXP_LOG2E, 0.5))
    r = _fma(m, _EXP_C2, _fma(m, _EXP_C1, xc))
    y = _fma(r, _EXP_P[0], _EXP_P[1])
    for p in _EXP_P[2:]:
        y = _fma(y, r, p)
    y = _fma(y, r * r, r) + 1.0
    # 2^m built from its bits (m in [-128, 128]), so the scaling is exact
    # on every device
    two_m = ((m.to(torch.int64) + 1023) << 52).view(torch.float64)
    v = y.double() * two_m
    return torch.where(v.abs() < torch.finfo(torch.float32).tiny, 0.0, v).float()


def _log(x: torch.Tensor) -> torch.Tensor:
    """JAX's CPU log at x's dtype: `log_f32` for float32; for float64,
    torch's log, which may differ from it in the last bit."""
    return log_f32(x) if x.dtype == torch.float32 else torch.log(x)


def gumbel(key: torch.Tensor, shape: Sequence[int], dtype: torch.dtype) -> torch.Tensor:
    """jax.random.gumbel(key, shape, dtype) in its default ("low") mode."""
    tiny = torch.finfo(dtype).tiny
    return -_log(-_log(uniform(key, shape, dtype, minval=tiny, maxval=1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """jax.random.categorical(key, logits) over the last axis (with
    replacement): the first argmax of gumbel + logits."""
    return torch.argmax(gumbel(key, logits.shape, logits.dtype) + logits, dim=-1)


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
