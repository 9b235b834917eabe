"""Randomness sources for blinders and verifier weights.

Counterpart of proof_systems_tpu/utils/rng.py: `TestRng` is a seeded
source whose draws equal the JAX package's for the same seed (so blinders,
and hence proofs, agree); `SystemRng` draws from the OS CSPRNG.
"""

from __future__ import annotations

import random
import secrets


class TestRng:
    __test__ = False  # not a pytest test class

    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)

    def field(self, p: int) -> int:
        return self._rng.randrange(p)


class SystemRng:
    def field(self, p: int) -> int:
        return secrets.randbelow(p)
