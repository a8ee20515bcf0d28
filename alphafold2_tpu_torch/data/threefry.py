"""The JAX package's default random-number draws, in numpy.

The JAX serving tools draw their synthetic traffic from
`jax.random.PRNGKey(seed)` (threefry2x32, partitionable bit
generation). The port's tools draw the same traffic token for token, so
a profile, a load-test pool or a poison set made by either package is
the same bytes: `key`, `split` and `randint` reproduce
`jax.random.PRNGKey`, `jax.random.split` and `jax.random.randint`
(32-bit integers) for the shapes these tools use.
"""

from __future__ import annotations

import math

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def threefry2x32(key, c1, c2):
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (c1, c2)
    under `key`, two uint32 arrays of the counters' shape."""
    k1, k2 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = np.asarray(c1, np.uint32) + ks[0]
    x1 = np.asarray(c2, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 = x0 ^ x1
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)`: the seed's high and low 32 bits."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)


def _counters(n: int):
    """The flat 64-bit iota over n values as (high, low) 32-bit halves."""
    flat = np.arange(n, dtype=np.uint64)
    return ((flat >> np.uint64(32)).astype(np.uint32),
            (flat & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def split(k, num: int = 2) -> np.ndarray:
    """`jax.random.split(k, num)`: (num, 2) uint32 keys."""
    b1, b2 = threefry2x32(k, *_counters(num))
    return np.stack([b1, b2], axis=-1)


def random_bits(k, shape) -> np.ndarray:
    """32 random bits per element of `shape`."""
    b1, b2 = threefry2x32(k, *_counters(math.prod(shape)))
    return (b1 ^ b2).reshape(shape)


def randint(k, shape, minval: int, maxval: int) -> np.ndarray:
    """`jax.random.randint(k, shape, minval, maxval)` (int32): twice 32
    bits per value, folded into the span by the same modular sum."""
    k1, k2 = split(k, 2)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    span = np.uint32(max(int(maxval) - int(minval), 1))
    multiplier = np.uint32((2 ** 16 % int(span)) ** 2 % int(span))
    offset = ((higher % span) * multiplier + lower % span) % span
    return (np.int64(minval) + offset.astype(np.int64)).astype(np.int32)
