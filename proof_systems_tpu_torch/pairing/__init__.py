"""Pairing-friendly curve arithmetic (BN254) for the KZG backend.

Capability mirror of the reference's `ark-bn254` dependency
(poly-commitment/src/kzg.rs uses `Pairing<G1Affine, G2Affine>`); the
implementation is original host math: tower fields Fq2/Fq6/Fq12,
optimal-ate Miller loop, and the BN final-exponentiation chain.
"""

from .bn254 import (  # noqa: F401
    FQ,
    FR,
    G1,
    G2,
    g1_add,
    g1_mul,
    g1_neg,
    g2_add,
    g2_mul,
    g2_neg,
    multi_pairing,
    pairing,
)
