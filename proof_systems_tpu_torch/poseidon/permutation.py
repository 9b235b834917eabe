"""Host (scalar, exact) Poseidon permutation.

Counterpart of proof_systems_tpu/poseidon/permutation.py: the engine of
the Fiat-Shamir transcript sponges (a few dozen permutations a proof), and
the golden model of the card's fused sponge kernel (K10, ops/kernels.py).

Semantics: poseidon/src/permutation.rs:55-163 (full rounds only: sbox,
full 3x3 MDS, add round constants; optional initial ark for legacy).
"""

from __future__ import annotations

from .params import PoseidonParams


def sbox(params: PoseidonParams, x: int) -> int:
    return pow(x, params.sbox, params.field.p)


def full_round(params: PoseidonParams, state: list[int], r: int) -> None:
    p = params.field.p
    s = [sbox(params, x) for x in state]
    new = [sum(m * x for m, x in zip(row, s)) % p for row in params.mds]
    rc = params.round_constants[r]
    for i in range(3):
        state[i] = (new[i] + rc[i]) % p


def poseidon_block_cipher(params: PoseidonParams, state: list[int]) -> None:
    """In-place permutation of a width-3 state: the native C++ permutation
    (native/pasta.cpp) when g++ built it, else the Python golden model."""
    if len(state) != params.sponge_width:
        raise ValueError(f"state has {len(state)} elements, not {params.sponge_width}")
    from ..native import native_poseidon

    nat = native_poseidon(params)
    if nat is not None:
        state[:] = nat.permute(state)
        return
    poseidon_block_cipher_py(params, state)


def poseidon_block_cipher_py(params: PoseidonParams, state: list[int]) -> None:
    """Pure-Python golden model of the permutation."""
    if params.initial_ark:
        rc = params.round_constants[0]
        for i in range(3):
            state[i] = (state[i] + rc[i]) % params.field.p
        for r in range(params.rounds_full):
            full_round(params, state, r + 1)
    else:
        for r in range(params.rounds_full):
            full_round(params, state, r)
