from .params import PoseidonParams, fp_kimchi, fp_legacy, fq_kimchi, fq_legacy
from .permutation import poseidon_block_cipher
from .sponge import ArithmeticSponge, FqSponge, FrSponge, ScalarChallenge, poseidon_hash

__all__ = [
    "PoseidonParams",
    "fp_kimchi",
    "fq_kimchi",
    "fp_legacy",
    "fq_legacy",
    "poseidon_block_cipher",
    "ArithmeticSponge",
    "FqSponge",
    "FrSponge",
    "ScalarChallenge",
    "poseidon_hash",
]
