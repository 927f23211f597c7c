"""TF/Keras-compatible stateless RNG: reproduce ``keras.random.normal(shape, seed=s)``.

The reference seeds its initial diffusion noise with
``tf.random.stateless_normal(shape, seed=[seed, 0])``. This module reimplements TF's
stateless pipeline in numpy so that the same integer seed gives the same initial
noise (and so the same image) as the reference and as the JAX package:

  1. key/counter derivation: one Philox-4x32-10 invocation over the two seed words
     under TF's fixed scramble key;
  2. Philox-4x32-10 counter stream (4 uint32 per 128-bit counter);
  3. TF's ``Uint32ToFloat`` (low-23-bit mantissa into [0,1)) and ``BoxMullerFloat``
     (sin first, then cos; u1 clamped at 1e-7).

The Philox integer stream is bit-exact; the floats match TF to a few float32 ULPs
(libm sin/cos/log differ between numpy and Eigen). Host-side by design: the latent
noise is a few KB.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

_M0 = np.uint64(0xD2511F53)
_M1 = np.uint64(0xCD9E8D57)
_W0 = np.uint32(0x9E3779B9)
_W1 = np.uint32(0xBB67AE85)
# TF's fixed scramble key for stateless seed -> (key, counter) derivation
_SCRAMBLE_KEY = (np.uint32(0x3EC8F720), np.uint32(0x02461E29))


def philox_4x32(counter: np.ndarray, key) -> np.ndarray:
    """Philox-4x32 with 10 rounds. ``counter``: (n, 4) uint32; ``key``: 2 uint32.
    Returns (n, 4) uint32."""
    c = [counter[:, i].copy() for i in range(4)]
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    with np.errstate(over="ignore"):
        for r in range(10):
            p0 = _M0 * c[0].astype(np.uint64)
            p1 = _M1 * c[2].astype(np.uint64)
            lo0 = p0.astype(np.uint32)
            hi0 = (p0 >> np.uint64(32)).astype(np.uint32)
            lo1 = p1.astype(np.uint32)
            hi1 = (p1 >> np.uint64(32)).astype(np.uint32)
            c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
            if r < 9:
                k0 = np.uint32(k0 + _W0)
                k1 = np.uint32(k1 + _W1)
    return np.stack(c, axis=1)


def key_counter_from_seed(seed0: int, seed1: int = 0):
    """TF ``StatelessRandomGetKeyCounter``: scramble the two seed words with one
    Philox run under a fixed key. Returns (key[2] uint32, counter[4] uint32)."""
    s0 = np.uint64(seed0 % (1 << 64))
    s1 = np.uint64(seed1 % (1 << 64))
    ctr = np.zeros((1, 4), np.uint32)
    ctr[0, 0] = np.uint32(s0 & np.uint64(0xFFFFFFFF))
    ctr[0, 1] = np.uint32(s0 >> np.uint64(32))
    ctr[0, 2] = np.uint32(s1 & np.uint64(0xFFFFFFFF))
    ctr[0, 3] = np.uint32(s1 >> np.uint64(32))
    mix = philox_4x32(ctr, _SCRAMBLE_KEY)[0]
    return (mix[0], mix[1]), (np.uint32(0), np.uint32(0), mix[2], mix[3])


def _uint32_to_float(x: np.ndarray) -> np.ndarray:
    """TF ``Uint32ToFloat``: low 23 bits as mantissa of [1,2), minus 1 -> [0,1)."""
    return ((x & np.uint32(0x7FFFFF)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)


def _box_muller(x0: np.ndarray, x1: np.ndarray):
    """TF ``BoxMullerFloat``: returns (u2*sin(v1), u2*cos(v1))."""
    eps = np.float32(1.0e-7)
    u1 = np.maximum(_uint32_to_float(x0), eps)
    v1 = np.float32(2.0 * np.pi) * _uint32_to_float(x1)
    u2 = np.sqrt(np.float32(-2.0) * np.log(u1))
    return (u2 * np.sin(v1)).astype(np.float32), (u2 * np.cos(v1)).astype(np.float32)


def random_bits(n_groups: int, seed: int) -> np.ndarray:
    """(n_groups, 4) uint32 of the TF stateless Philox stream for integer seed."""
    key, c = key_counter_from_seed(seed)
    idx = np.arange(n_groups, dtype=np.uint64)  # counter low-64 starts at 0
    ctr = np.empty((n_groups, 4), np.uint32)
    ctr[:, 0] = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    ctr[:, 1] = (idx >> np.uint64(32)).astype(np.uint32)
    ctr[:, 2] = c[2]
    ctr[:, 3] = c[3]
    return philox_4x32(ctr, key)


def stateless_normal(shape: Sequence[int], seed: int) -> np.ndarray:
    """Standard-normal fp32 matching ``keras.random.normal(shape, seed=seed)``
    (TF backend) up to libm ULPs."""
    # keras floormods the int64 [seed, 0] into int32 range before calling
    # tf.random.stateless_normal; replicate so large and negative seeds match too.
    seed = int(seed) % (2**31 - 2)
    n = int(np.prod(shape))
    bits = random_bits((n + 3) // 4, seed)
    f0, f1 = _box_muller(bits[:, 0], bits[:, 1])
    f2, f3 = _box_muller(bits[:, 2], bits[:, 3])
    out = np.stack([f0, f1, f2, f3], axis=1).reshape(-1)[:n]
    return out.reshape(tuple(shape))
