"""TensorFlow's stateless normal, ``tf.random.stateless_normal(shape, [seed, 0])``,
in numpy: the seed scrambled into a Philox-4x32-10 key and counter, the counter
stream, 23-bit floats in [0, 1) and Box-Muller pairs (sin first, u1 clamped at
1e-7). This is the initial noise a seed stands for.
"""

from __future__ import annotations

import numpy as np

MUL = (0xD2511F53, 0xCD9E8D57)
WEYL = (0x9E3779B9, 0xBB67AE85)
SCRAMBLE = (0x3EC8F720, 0x02461E29)
MASK = 0xFFFFFFFF


def philox(ctr: np.ndarray, key) -> np.ndarray:
    """Ten Philox-4x32 rounds over (n, 4) uint64 counters holding 32-bit words."""
    c0, c1, c2, c3 = (ctr[:, i].astype(np.uint64) for i in range(4))
    k0, k1 = np.uint64(key[0]), np.uint64(key[1])
    for r in range(10):
        p0 = np.uint64(MUL[0]) * c0
        p1 = np.uint64(MUL[1]) * c2
        c0, c1, c2, c3 = ((p1 >> np.uint64(32)) ^ c1 ^ k0, p1 & np.uint64(MASK),
                          (p0 >> np.uint64(32)) ^ c3 ^ k1, p0 & np.uint64(MASK))
        k0 = (k0 + np.uint64(WEYL[0])) & np.uint64(MASK)
        k1 = (k1 + np.uint64(WEYL[1])) & np.uint64(MASK)
    return np.stack([c0, c1, c2, c3], axis=1)


def _unit(x: np.ndarray) -> np.ndarray:
    return ((x.astype(np.uint32) & np.uint32(0x7FFFFF)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)


def stateless_normal(shape, seed: int) -> np.ndarray:
    """Standard normal float32 of ``shape`` for ``seed`` (taken modulo 2**31 - 2,
    as Keras folds it)."""
    seed = int(seed) % (2**31 - 2)
    words = np.array([[seed & MASK, seed >> 32, 0, 0]], np.uint64)
    mix = philox(words, SCRAMBLE)[0]
    n = int(np.prod(shape))
    groups = (n + 3) // 4
    idx = np.arange(groups, dtype=np.uint64)
    ctr = np.stack([idx & np.uint64(MASK), idx >> np.uint64(32),
                    np.full(groups, mix[2], np.uint64), np.full(groups, mix[3], np.uint64)], axis=1)
    bits = philox(ctr, (mix[0], mix[1]))
    out = []
    for a, b in ((0, 1), (2, 3)):
        u1 = np.maximum(_unit(bits[:, a]), np.float32(1e-7))
        v1 = np.float32(2 * np.pi) * _unit(bits[:, b])
        r = np.sqrt(np.float32(-2.0) * np.log(u1))
        out += [(r * np.sin(v1)).astype(np.float32), (r * np.cos(v1)).astype(np.float32)]
    return np.stack(out, axis=1).reshape(-1)[:n].reshape(tuple(shape))
