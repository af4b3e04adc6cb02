"""Vector arithmetic in the ring Z_{2^32-1} on uint32 lanes.

Vectorized replacement for the reference's end-around-carry macro library
(NTT.cu:102-145: modadd/modsub/modmul/moddiv2/neg/normalize), used by the
Nussbaumer negacyclic-convolution path.  Elements are represented in
[0, 2^32-1] with both 0x00000000 and 0xFFFFFFFF denoting zero (normalize
canonicalizes).  Arithmetic is exact because 2^32 ≡ 1 (mod 2^32-1):
a 64-bit product folds by adding its high word to its low word.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .modmul import widemul32

__all__ = ["ring_add", "ring_sub", "ring_mul", "ring_neg", "ring_div2",
           "ring_normalize", "RING_MOD"]

RING_MOD = (1 << 32) - 1
_ALL1 = np.uint32(0xFFFFFFFF)   # numpy scalar: Pallas-kernel friendly


def ring_add(a, b):
    """End-around-carry add: (a + b) with the 2^32 carry folded back in."""
    t = a + b                      # wraps mod 2^32
    return t + (t < a).astype(jnp.uint32)


def ring_sub(a, b):
    """End-around-borrow subtract."""
    return (a - b) - (b > a).astype(jnp.uint32)


def ring_mul(a, b):
    """(a * b) mod (2^32-1): fold hi word into lo (2^32 ≡ 1)."""
    hi, lo = widemul32(a, b)
    return ring_add(lo, hi)


def ring_neg(a):
    """-a: complement (0xFFFFFFFF - a), representation-preserving."""
    return _ALL1 - a


def ring_div2(a):
    """a/2 in the odd-modulus ring: odd representatives pick up 2^31
    ((a + 2^32 - 1) / 2 = (a-1)/2 + 2^31 for odd a)."""
    return (a >> 1) + ((a & jnp.uint32(1)) << 31)


def ring_normalize(a):
    """Canonicalize the double representation of zero."""
    return jnp.where(a == _ALL1, jnp.uint32(0), a)
