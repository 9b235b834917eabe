"""Circuits of the gadgets, with their witnesses, for the card's checks and
the tests.

  - always_on_circuit: one each of the Poseidon, CompleteAdd, VarBaseMul,
    EndoMul and EndoMulScalar gadgets and a ForeignFieldAdd chain (26 rows:
    a 32-point domain, no lookup table);
  - optional_circuit: one multi-range-check, a 64-bit Xor, a Rot64 (rot 17),
    a ForeignFieldAdd chain (signs [1, -1]) and a ForeignFieldMul over
    secp256k1's p, an And and a Not (25 rows; the range-check table of
    4,096 rows and the XOR table of 256 force a domain of 8,192);
  - gate_mix_circuit: repeated blocks of the gate mix of foreign-field ECDSA
    and Keccak gadgets (a ForeignFieldMul with multi-range-checks of its
    operands, its quotient and, compact, its remainder; a ForeignFieldAdd
    chain; a 64-bit Xor, a Rot64, an And and a Not), as many as fit a
    domain.

Each builder takes the gadget modules it calls (`wg`: witness_gen, `ow`:
optional_witness, `gate`: the gate module) and the curve, field and Poseidon
parameters as arguments, this package's by default, so that another
implementation of the same gadgets builds the same rows from the same seed.
Inputs are drawn from random.Random(seed) in a fixed order. Each returns
(gates, witness), the witness as long as the gate list.
"""

from __future__ import annotations

import random

from ..curves import Pallas
from ..fields import Fp
from ..poseidon import fp_kimchi
from . import gate as gate_mod
from .gate import COLUMNS
from .polynomials import optional_witness, witness_gen

SECP256K1_P = (1 << 256) - (1 << 32) - 977
# The seeds of the committed proofs (tests/vectors/proof_gates_2^5.bin,
# proof_optional_2^13.bin): the circuit's inputs and the prover's TestRng.
ALWAYS_ON_SEED = 101
OPTIONAL_SEED = 113
ROT = 17
FFADD_SIGNS = [1, -1]


def _witness(rows: int) -> list[list[int]]:
    return [[0] * rows for _ in range(COLUMNS)]


def always_on_circuit(seed: int, wg=witness_gen, ow=optional_witness, gate=gate_mod,
                      curve=Pallas, f=Fp, params=fp_kimchi):
    """Poseidon (12 rows), CompleteAdd (1), VarBaseMul of 10 bits (4),
    EndoMul of 8 bits (3), EndoMulScalar of 32 bits (2) and a
    ForeignFieldAdd chain of three secp256k1 elements (4), the witnesses of
    tests/test_gates_e2e.py's gadgets."""
    rng = random.Random(seed)
    g = curve.generator
    endo = curve.endos[0]
    witness = _witness(26)
    gates, row = wg.create_poseidon_gadget(f, 0, params)
    wg.poseidon_witness(f, params, witness, 0, [rng.randrange(f.p) for _ in range(3)])

    gates.append(gate.CircuitGate(gate.GateType.CompleteAdd, gate.new_wires(row), []))
    p1 = curve.scalar_mul(rng.randrange(1, curve.scalar.p), g)
    p2 = curve.scalar_mul(rng.randrange(1, curve.scalar.p), g)
    wg.complete_add_witness_row(curve, witness, row, p1, p2)
    row += 1

    gates += wg.create_vbmul_gates(row, 2)
    base = curve.scalar_mul(rng.randrange(1, curve.scalar.p), g)
    acc0 = curve.scalar_mul(rng.randrange(1, curve.scalar.p), g)
    wg.varbasemul_witness(curve, witness, row, base, [rng.randrange(2) for _ in range(10)], acc0)
    row += 4

    gates += wg.create_endomul_gates(row, 2)
    base = curve.scalar_mul(rng.randrange(1, curve.scalar.p), g)
    acc0 = curve.double(curve.add(base, (endo * base[0] % curve.base.p, base[1])))
    wg.endomul_witness(curve, witness, row, endo, base, [rng.randrange(2) for _ in range(8)],
                       acc0)
    row += 3

    gates += wg.create_endomul_scalar_gates(row, 2)
    wg.endomul_scalar_witness(f, witness, row, rng.randrange(1 << 32), 32)
    row += 2

    gates += ow.create_ffadd_gadget(row, f, SECP256K1_P, FFADD_SIGNS)
    ow.ffadd_witness(witness, row, [rng.randrange(SECP256K1_P) for _ in range(3)],
                     FFADD_SIGNS, SECP256K1_P, f.p)
    assert len(gates) == row + 4 == 26
    return gates, witness


def _optional_gadgets(rng, row: int, ow, f, witness, gates) -> int:
    """A 64-bit Xor, a Rot64, a ForeignFieldAdd chain, an And and a Not from
    `row`; returns the next free row."""
    gates += ow.create_xor_gadget(row, 64)
    ow.xor_witness(witness, row, rng.getrandbits(64), rng.getrandbits(64), 64)
    row += ow.num_xors(64) + 1

    gates += ow.create_rot64_gadget(row, ROT, f)
    ow.rot64_witness(witness, row, rng.getrandbits(64), ROT)
    row += 3

    gates += ow.create_ffadd_gadget(row, f, SECP256K1_P, FFADD_SIGNS)
    ow.ffadd_witness(witness, row, [rng.randrange(SECP256K1_P) for _ in range(3)],
                     FFADD_SIGNS, SECP256K1_P, f.p)
    row += len(FFADD_SIGNS) + 2

    gates += ow.create_and_gadget(row, f, 64)
    ow.and_witness(witness, row, rng.getrandbits(64), rng.getrandbits(64), 64)
    row += ow.num_xors(64) + 2

    gates += ow.create_not_gadget(row, f, 1, 64)
    ow.not_witness(witness, row, [rng.getrandbits(64)], 64)
    return row + 1


OPTIONAL_ROWS = 25


def optional_circuit(seed: int, ow=optional_witness, f=Fp):
    """One multi-range-check of three 88-bit values, then a ForeignFieldMul
    of two secp256k1 elements, then _optional_gadgets."""
    rng = random.Random(seed)
    witness = _witness(OPTIONAL_ROWS)
    gates = ow.create_multi_range_check(0)
    ow.multi_range_check_witness(witness, 0, *(rng.getrandbits(88) for _ in range(3)))
    gates += ow.create_ffmul_gadget(4, f, SECP256K1_P)
    ow.ffmul_witness(witness, 4, rng.randrange(SECP256K1_P), rng.randrange(SECP256K1_P),
                     SECP256K1_P, f.p)
    row = _optional_gadgets(rng, 6, ow, f, witness, gates)
    assert row == len(gates) == OPTIONAL_ROWS
    return gates, witness


BLOCK_ROWS = 37


def _gate_mix_block(rng, row: int, ow, f, witness, gates) -> None:
    """A ForeignFieldMul (2 rows), multi-range-checks of a, b and q (12) and
    a compact one of the remainder (4: the RangeCheck0 of its middle limb
    checks v12 = r1 + 2^88 r2 in the RangeCheck1 row), then
    _optional_gadgets (19)."""
    a, b = rng.randrange(SECP256K1_P), rng.randrange(SECP256K1_P)
    gates += ow.create_ffmul_gadget(row, f, SECP256K1_P)
    q, r = ow.ffmul_witness(witness, row, a, b, SECP256K1_P, f.p)
    row += 2
    for v in (a, b, q):
        gates += ow.create_multi_range_check(row)
        ow.multi_range_check_witness(witness, row, *ow.ff_limbs(v))
        row += 4
    r0, r1, r2 = ow.ff_limbs(r)
    gates += ow.create_multi_range_check(row, compact=True)
    ow.multi_range_check_witness(witness, row, r0, r1, r2, compact=True)
    witness[1][row + 2] = r1 + (r2 << 88)
    _optional_gadgets(rng, row + 4, ow, f, witness, gates)


def gate_mix_circuit(rows: int, seed: int, ow=optional_witness, f=Fp):
    """rows // BLOCK_ROWS blocks (at most `rows` gates). Returns (gates,
    witness, blocks)."""
    rng = random.Random(seed)
    blocks = rows // BLOCK_ROWS
    witness = _witness(blocks * BLOCK_ROWS)
    gates: list = []
    for i in range(blocks):
        _gate_mix_block(rng, i * BLOCK_ROWS, ow, f, witness, gates)
    assert len(gates) == blocks * BLOCK_ROWS
    return gates, witness, blocks
