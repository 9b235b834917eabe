"""The snarky front end (circuits/snarky.py) against the JAX package: each
circuit of tests/test_snarky.py, written once and run through both
packages' Runner, gives the same gates (type, wires, coefficients), the same
witness columns and public values, and the same checker verdict (the
bad-square circuit and the 89-bit range check fail in both, with the same
message); the cubic circuit's proof, on the CPU over its derived SRS, equals
the JAX package's byte for byte, and each verifier accepts the other's
bytes. Every comparison is exact."""

import random

import pytest
import torch

from proof_systems_tpu import verifier as jverifier
from proof_systems_tpu.circuits import checker as jchecker
from proof_systems_tpu.circuits.constraints import ConstraintSystem as JConstraintSystem
from proof_systems_tpu.circuits.snarky import Runner as JRunner
from proof_systems_tpu.curves import Pallas as JPallas
from proof_systems_tpu.curves import Vesta as JVesta
from proof_systems_tpu.fields import Fp as JFp
from proof_systems_tpu.poly_commitment import srs as jsrs
from proof_systems_tpu.poseidon import fp_kimchi as jfp_kimchi
from proof_systems_tpu.prover import create_proof as jcreate_proof
from proof_systems_tpu.prover_index import ProverIndex as JProverIndex
from proof_systems_tpu.serialization import deserialize_proof as jdeserialize_proof
from proof_systems_tpu.serialization import serialize_proof as jserialize_proof
from proof_systems_tpu.utils import TestRng as JTestRng
from proof_systems_tpu_torch import verifier
from proof_systems_tpu_torch.circuits import checker
from proof_systems_tpu_torch.circuits.constraints import ConstraintSystem
from proof_systems_tpu_torch.circuits.snarky import Runner
from proof_systems_tpu_torch.curves import Pallas, Vesta
from proof_systems_tpu_torch.fields import Fp
from proof_systems_tpu_torch.poly_commitment.srs import SRS, derive_g, derive_h
from proof_systems_tpu_torch.poseidon import fp_kimchi
from proof_systems_tpu_torch.prover import create_proof
from proof_systems_tpu_torch.prover_index import ProverIndex
from proof_systems_tpu_torch.serialization import deserialize_proof, serialize_proof
from proof_systems_tpu_torch.utils.rng import TestRng

torch.set_num_threads(2)

P = Fp.p
MDS = [list(r) for r in fp_kimchi.mds]
PORT = dict(Runner=Runner, f=Fp, curve=Pallas, params=fp_kimchi)
JAX = dict(Runner=JRunner, f=JFp, curve=JPallas, params=jfp_kimchi)


def cubic(m, x_val=3):
    rs = m["Runner"](m["f"], public=1)
    x = rs.exists(x_val)
    x3 = rs.mul(rs.square(x), x)
    y = rs.set_public(0, (pow(x_val, 3, P) + x_val + 5) % P)
    rs.assert_eq(x3 + x + 5, y)
    return rs


def ops(m):
    rs = m["Runner"](m["f"])
    a, b = rs.exists(10), rs.exists(4)
    rs.div(a, b)
    rs.inv(b)
    bit = rs.exists(1)
    rs.assert_boolean(bit)
    rs.if_(bit, a, b)
    return rs


def bad_square(m):
    rs = m["Runner"](m["f"])
    rs.assert_square(rs.exists(3), rs.exists(10))
    return rs


def poseidon(m):
    rs = m["Runner"](m["f"])
    ins = [rs.exists(v) for v in (11, 22, 33)]
    rs.poseidon(m["params"], ins)
    rs.poseidon(m["params"], [ins[0] + 1, ins[1], ins[2].scale(2)])
    return rs


def ec_add_complete(m):
    rng, c = random.Random(7), m["curve"]
    p1, p2 = (c.scalar_mul(rng.randrange(1, c.scalar.p), c.generator) for _ in range(2))
    rs = m["Runner"](m["f"])
    x1, y1, x2, y2 = (rs.exists(v) for v in (*p1, *p2))
    x3, y3 = rs.ec_add_complete(c, (x1, y1), (x2, y2))
    rs.ec_add_complete(c, (x3, y3), (x2, y2))
    return rs


def ec_scale(m):
    rng, c = random.Random(17), m["curve"]
    base, acc0 = (c.scalar_mul(rng.randrange(1, c.scalar.p), c.generator) for _ in range(2))
    rs = m["Runner"](m["f"])
    rs.ec_scale(c, (rs.exists(base[0]), rs.exists(base[1])),
                [rs.exists(rng.randrange(2)) for _ in range(10)],
                (rs.exists(acc0[0]), rs.exists(acc0[1])))
    return rs


def ec_endoscale(m):
    rng, c = random.Random(19), m["curve"]
    endo = c.endos[0]
    base = c.scalar_mul(rng.randrange(1, c.scalar.p), c.generator)
    acc0 = c.double(c.add(base, (endo * base[0] % P, base[1])))
    rs = m["Runner"](m["f"])
    rs.ec_endoscale(c, (rs.exists(base[0]), rs.exists(base[1])),
                    [rs.exists(rng.randrange(2)) for _ in range(8)],
                    (rs.exists(acc0[0]), rs.exists(acc0[1])))
    return rs


def ec_endoscalar(m):
    rs = m["Runner"](m["f"])
    rs.ec_endoscalar(rs.exists(random.Random(23).getrandbits(128)), 128)
    return rs


def range_check(m, bits=88):
    rng = random.Random(29)
    vals = [rng.getrandbits(88) for _ in range(3)]
    if bits != 88:
        vals[2] = (1 << 88) + 1
    rs = m["Runner"](m["f"])
    rs.range_check(*(rs.exists(v) for v in vals))
    return rs


def ec_gadgets(m):
    """tests/test_snarky.py's combined circuit: EcScale, EcEndoscale,
    EcEndoscalar and RangeCheck."""
    rng, c = random.Random(31), m["curve"]
    endo = c.endos[0]
    base, acc0 = (c.scalar_mul(rng.randrange(1, c.scalar.p), c.generator) for _ in range(2))
    eacc0 = c.double(c.add(base, (endo * base[0] % P, base[1])))
    rs = m["Runner"](m["f"])
    bx, by = rs.exists(base[0]), rs.exists(base[1])
    rs.ec_scale(c, (bx, by), [rs.exists(rng.randrange(2)) for _ in range(5)],
                (rs.exists(acc0[0]), rs.exists(acc0[1])))
    rs.ec_endoscale(c, (bx, by), [rs.exists(rng.randrange(2)) for _ in range(4)],
                    (rs.exists(eacc0[0]), rs.exists(eacc0[1])))
    rs.ec_endoscalar(rs.exists(rng.getrandbits(32)), 32)
    rs.range_check(*(rs.exists(rng.getrandbits(88)) for _ in range(3)))
    return rs


# name -> (circuit, whether its witness is good); only the cubic one has a
# public input
CIRCUITS = {
    "cubic": (cubic, True), "ops": (ops, True), "bad_square": (bad_square, False),
    "poseidon": (poseidon, True), "ec_add_complete": (ec_add_complete, True),
    "ec_scale": (ec_scale, True), "ec_endoscale": (ec_endoscale, True),
    "ec_endoscalar": (ec_endoscalar, True), "range_check": (range_check, True),
    "range_check_89_bits": (lambda m: range_check(m, 89), False),
    "ec_gadgets": (ec_gadgets, True),
}


def _finalized(build, m, cs_cls):
    rs = build(m)
    gates, witness = rs.finalize()
    cs = cs_cls(gates)
    cs.endo = m["curve"].endos[0]
    n = cs.domain.d1.n
    return rs, gates, [col + [0] * (n - len(col)) for col in witness], cs


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_runner_matches_jax(name):
    build, good = CIRCUITS[name]
    rs, gates, w, cs = _finalized(build, PORT, lambda g: ConstraintSystem.create(
        Fp, g, public=int(name == "cubic"), max_poly_size=1 << 13, device="cpu"))
    jrs, jgates, jw, jcs = _finalized(build, JAX, lambda g: JConstraintSystem.create(
        JFp, g, public=int(name == "cubic"), max_poly_size=1 << 13))
    assert [(int(g.typ), [(x.row, x.col) for x in g.wires], list(g.coeffs)) for g in gates] == [
        (int(g.typ), [(x.row, x.col) for x in g.wires], list(g.coeffs)) for g in jgates]
    assert w == jw and rs.values == jrs.values and rs.public_values() == jrs.public_values()
    assert sorted(map(int, cs.feature_flags)) == sorted(map(int, jcs.feature_flags))
    if good:
        checker.check_witness(cs, w, MDS, public=rs.public_values())
        jchecker.check_witness(jcs, [list(c) for c in w], MDS, public=jrs.public_values())
        return
    with pytest.raises(ValueError) as got:
        checker.check_witness(cs, w, MDS)
    with pytest.raises(ValueError) as want:
        jchecker.check_witness(jcs, [list(c) for c in w], MDS)
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def cubic_proofs():
    """tests/test_snarky.py's proved cubic circuit (x = 7) in both packages,
    over the derived SRS of its domain, TestRng(80)."""
    rs, jrs = cubic(PORT, 7), cubic(JAX, 7)
    gates, witness = rs.finalize()
    jgates, jwitness = jrs.finalize()
    cs = ConstraintSystem.create(Fp, gates, public=1, max_poly_size=1 << 13, device="cpu")
    jcs = JConstraintSystem.create(JFp, jgates, public=1, max_poly_size=1 << 13)
    n = cs.domain.d1.n
    g, h = [derive_g(Vesta, i) for i in range(n)], derive_h(Vesta)
    index = ProverIndex(cs, Vesta, SRS(Vesta, g, h, torch.device("cpu")))
    jindex = JProverIndex(jcs, JVesta, jsrs.SRS(JVesta, g, h))
    proof = create_proof(index, witness, TestRng(80))
    jproof = jcreate_proof(jindex, jwitness, JTestRng(80))
    return dict(index=index, jindex=jindex, public=rs.public_values(),
                raw=serialize_proof(Vesta, proof), jraw=jserialize_proof(JVesta, jproof))


def test_cubic_proof_bytes_equal_jax(cubic_proofs):
    assert cubic_proofs["index"].cs.domain.d1.n == cubic_proofs["jindex"].cs.domain.d1.n
    assert cubic_proofs["raw"] == cubic_proofs["jraw"]


def test_cubic_verifiers_accept_each_others_bytes(cubic_proofs):
    pub = cubic_proofs["public"]
    assert verifier.verify(cubic_proofs["index"].verifier_index(),
                           deserialize_proof(Vesta, cubic_proofs["jraw"]), pub, TestRng(81))
    assert jverifier.verify(cubic_proofs["jindex"].verifier_index(),
                            jdeserialize_proof(JVesta, cubic_proofs["raw"]), pub, JTestRng(81))
    wrong = [(pub[0] + 1) % P]
    assert not verifier.verify(cubic_proofs["index"].verifier_index(),
                               deserialize_proof(Vesta, cubic_proofs["raw"]), wrong, TestRng(82))
