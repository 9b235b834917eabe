"""The optional gates, their gadgets and witnesses, and the witness checker,
on the host, against the JAX package:
  - each optional gate's constraints, evaluated on seeded random cells,
    equal the JAX package's;
  - the linearization with all six feature flags and the Xor, RangeCheck
    and ForeignFieldMul lookup patterns (both fixed tables), evaluated on
    seeded random cells, equals the JAX package's, and its walk over
    16-point CPU columns (eval_dev) equals the host walk at every position;
  - each gadget's gates (type, wires, coefficients) and witness columns,
    from optional_witness, witness_gen and gate_mix, equal the JAX
    package's for the same inputs;
  - each gadget's constraint system at its own domain equals the JAX
    package's (selectors, feature flags, sigma, the lookup constraint
    system);
  - check_witness accepts each gadget's witness in both packages, and for
    the same changed cell both raise ValueError with the same message.
Every comparison is exact."""

import functools
import random

import pytest
import torch

from proof_systems_tpu.circuits import checker as jchecker
from proof_systems_tpu.circuits import expr as jexpr
from proof_systems_tpu.circuits import gate as jgate
from proof_systems_tpu.circuits.constraints import ConstraintSystem as JConstraintSystem
from proof_systems_tpu.circuits.polynomials import optional_gates as joptional_gates
from proof_systems_tpu.circuits.polynomials import optional_witness as jow
from proof_systems_tpu.circuits.polynomials import witness_gen as jwg
from proof_systems_tpu.curves import Pallas as JPallas
from proof_systems_tpu.fields import Fp as JFp
from proof_systems_tpu.poseidon import fp_kimchi as jfp_kimchi
from proof_systems_tpu.prover_index import build_linearization as jbuild_linearization
from proof_systems_tpu_torch.circuits import checker, expr, gate_mix
from proof_systems_tpu_torch.circuits import gate as gate_mod
from proof_systems_tpu_torch.circuits.constraints import ConstraintSystem
from proof_systems_tpu_torch.circuits.polynomials import optional_gates, optional_witness
from proof_systems_tpu_torch.circuits.polynomials import witness_gen
from proof_systems_tpu_torch.curves import Pallas
from proof_systems_tpu_torch.fields import Fp
from proof_systems_tpu_torch.ops import limb
from proof_systems_tpu_torch.poseidon import fp_kimchi
from proof_systems_tpu_torch.prover_index import build_linearization

torch.set_num_threads(1)

MDS = [list(r) for r in fp_kimchi.mds]
PORT = dict(wg=witness_gen, ow=optional_witness, gate=gate_mod, curve=Pallas, f=Fp,
            params=fp_kimchi)
JAX = dict(wg=jwg, ow=jow, gate=jgate, curve=JPallas, f=JFp, params=jfp_kimchi)
SECP = gate_mix.SECP256K1_P


def _walk(e, seen=None):
    """Every node of an AST once (by identity)."""
    seen = set() if seen is None else seen
    stack = [e]
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        yield node
        stack += [getattr(node, k) for k in ("a", "b") if hasattr(node, k)]


def _leaves(e):
    cells = {(n.col, n.row) for n in _walk(e) if isinstance(n, expr.Cell)}
    chals = {n.name for n in _walk(e) if isinstance(n, expr.Challenge)}
    rows = {(n.offset, n.zk_anchored) for n in _walk(e)
            if isinstance(n, expr.UnnormalizedLagrangeBasis)}
    return cells, chals, rows


def _host_ctx(mod, f, cells, chals, point=0, n=32, omega=None, zk_rows=3):
    return mod.HostEvalContext(f=f, get_cell=lambda c, r: cells[(c, r)], challenges=chals,
                               endo=Pallas.endos[0], mds=MDS, point=point, domain_n=n,
                               omega=omega if omega is not None else Fp.root_of_unity(5),
                               zk_rows=zk_rows)


@pytest.mark.parametrize("gate", [g.name for g in optional_gates.OPTIONAL_GATE_ORDER])
def test_gate_constraints_match_jax(gate):
    cs = optional_gates.OPTIONAL_GATE_BUILDERS[getattr(gate_mod.GateType, gate)](Fp)
    jcs = joptional_gates.OPTIONAL_GATE_BUILDERS[getattr(jgate.GateType, gate)](JFp)
    assert len(cs) == len(jcs) == optional_gates.OPTIONAL_GATE_CONSTRAINTS[
        getattr(gate_mod.GateType, gate)]
    rng = random.Random(gate)
    keys = set().union(*(_leaves(c)[0] for c in cs))
    cells = {k: rng.randrange(Fp.p) for k in sorted(keys, key=repr)}
    got = [expr.eval_host(c, _host_ctx(expr, Fp, cells, {})) for c in cs]
    want = [jexpr.eval_host(c, _host_ctx(jexpr, JFp, cells, {})) for c in jcs]
    assert got == want and all(got)


@functools.cache
def optional_systems():
    """The constraint systems of gate_mix.optional_circuit in both packages
    (every optional gate, both fixed tables, n = 8,192)."""
    gates, _ = gate_mix.optional_circuit(gate_mix.OPTIONAL_SEED)
    jgates, _ = gate_mix.optional_circuit(gate_mix.OPTIONAL_SEED, ow=jow, f=JFp)
    return (ConstraintSystem.create(Fp, gates, public=0, max_poly_size=1 << 13, device="cpu"),
            JConstraintSystem.create(JFp, jgates, public=0, max_poly_size=1 << 13))


@functools.cache
def linearizations():
    cs, jcs = optional_systems()
    flags = set(optional_gates.OPTIONAL_GATE_ORDER)
    assert cs.feature_flags == flags
    assert [p.value for p in cs.lookup_cs.info.patterns] == ["xor", "range_check", "ffmul"]
    return (build_linearization(Fp, flags, cs.lookup_cs),
            jbuild_linearization(JFp, set(joptional_gates.OPTIONAL_GATE_ORDER), jcs.lookup_cs))


def test_linearization_all_flags_matches_jax():
    (alphas, lin), (jalphas, jlin) = linearizations()
    for kind, count in (("gate", 21), ("permutation", 3), ("lookup", 7)):
        assert alphas.get_exponents(kind, count) == jalphas.get_exponents(kind, count)
    cells_keys, chal_names, _ = _leaves(lin)
    assert {("index", int(g)) for g in optional_gates.OPTIONAL_GATE_ORDER} <= {
        c for c, _ in cells_keys}
    rng = random.Random(7)
    cells = {k: rng.randrange(Fp.p) for k in sorted(cells_keys, key=repr)}
    chals = {k: rng.randrange(Fp.p) for k in sorted(chal_names)}
    point, n = rng.randrange(Fp.p), 1 << 13
    omega = Fp.root_of_unity(13)
    got = expr.eval_host(lin, _host_ctx(expr, Fp, cells, chals, point, n, omega))
    want = jexpr.eval_host(jlin, _host_ctx(jexpr, JFp, cells, chals, point, n, omega))
    assert got == want


def test_linearization_all_flags_eval_dev_matches_host_walk():
    """eval_dev over 16-point columns (NEXT = 8 positions on) equals
    eval_host at every position; position j evaluates the lookup term's
    Lagrange and zero-knowledge polynomials at its own point x_j."""
    (_, lin), _ = linearizations()
    cells_keys, chal_names, lag_rows = _leaves(lin)
    F = limb.device_field(Fp)
    rng, m, n, zk = random.Random(11), 16, 1 << 13, 3
    omega = Fp.root_of_unity(13)
    cols = {c: [rng.randrange(Fp.p) for _ in range(m)] for c in sorted({c for c, _ in cells_keys},
                                                                        key=repr)}
    chals = {k: rng.randrange(Fp.p) for k in sorted(chal_names)}
    points = [rng.randrange(Fp.p) for _ in range(m)]

    def host(j, node):
        return expr.eval_host(node, _host_ctx(expr, Fp, {(c, r): cols[c][(j + 8 * r) % m]
                                                         for c, r in cells_keys},
                                              chals, points[j], n, omega, zk))

    lag = {}
    for off, anchored in lag_rows:
        i = (off + (n - zk if anchored else 0)) % n
        lag[i] = F.pack_mont([host(j, expr.UnnormalizedLagrangeBasis(off, anchored))
                              for j in range(m)], device="cpu")
    vzk = F.pack_mont([host(j, expr.VanishesOnZeroKnowledgeAndPreviousRows()) for j in range(m)],
                      device="cpu")
    ctx = expr.DeviceEvalContext(
        F=F, columns={c: F.pack_mont(v, device="cpu") for c, v in cols.items()},
        challenges={k: F.pack_mont([v], device="cpu") for k, v in chals.items()},
        endo=Pallas.endos[0], mds=MDS, domain_n=n, zk_rows=zk, omega=omega,
        vanishes_on_zk_and_previous=vzk, unnormalized_lagrange=lag)
    memo = {}
    got = F.unpack_mont(expr.eval_dev(lin, ctx, memo))
    assert memo == {}
    assert got == [host(j, lin) for j in range(m)]


def _gadget(name: str, mods: dict):
    """(gates, witness, outputs) of one gadget at row 0 of its own circuit,
    built by one package's modules from the same seeded inputs."""
    wg, ow, gate, curve, f = (mods[k] for k in ("wg", "ow", "gate", "curve", "f"))
    rng = random.Random(name)
    g = curve.generator
    w = [[0] * 64 for _ in range(15)]
    if name == "poseidon":
        gates, _ = wg.create_poseidon_gadget(f, 0, mods["params"])
        out = wg.poseidon_witness(f, mods["params"], w, 0, [rng.randrange(f.p) for _ in range(3)])
    elif name in ("complete_add", "complete_add_double"):
        gates = [gate.CircuitGate(gate.GateType.CompleteAdd, gate.new_wires(0), [])]
        p1 = curve.scalar_mul(rng.randrange(1, curve.scalar.p), g)
        p2 = p1 if name == "complete_add_double" else curve.scalar_mul(
            rng.randrange(1, curve.scalar.p), g)
        out = wg.complete_add_witness_row(curve, w, 0, p1, p2)
    elif name == "varbasemul":
        gates = wg.create_vbmul_gates(0, 2)
        base, acc0 = (curve.scalar_mul(rng.randrange(1, curve.scalar.p), g) for _ in range(2))
        out = wg.varbasemul_witness(curve, w, 0, base, [rng.randrange(2) for _ in range(10)], acc0)
    elif name == "endomul":
        endo = curve.endos[0]
        gates = wg.create_endomul_gates(0, 2)
        base = curve.scalar_mul(rng.randrange(1, curve.scalar.p), g)
        acc0 = curve.double(curve.add(base, (endo * base[0] % curve.base.p, base[1])))
        out = wg.endomul_witness(curve, w, 0, endo, base, [rng.randrange(2) for _ in range(8)],
                                 acc0)
    elif name == "endomul_scalar":
        gates = wg.create_endomul_scalar_gates(0, 2)
        out = wg.endomul_scalar_witness(f, w, 0, rng.randrange(1 << 32), 32)
    elif name in ("multi_range_check", "multi_range_check_compact"):
        compact = name.endswith("compact")
        gates = ow.create_multi_range_check(0, compact)
        vals = [rng.getrandbits(88) for _ in range(3)]
        out = ow.multi_range_check_witness(w, 0, *vals, compact=compact)
        if compact:
            w[1][2] = vals[1] + (vals[2] << 88)
    elif name == "xor":
        gates = ow.create_xor_gadget(0, 64)
        out = ow.xor_witness(w, 0, rng.getrandbits(64), rng.getrandbits(64), 64)
    elif name == "rot64":
        gates = ow.create_rot64_gadget(0, gate_mix.ROT, f)
        out = ow.rot64_witness(w, 0, rng.getrandbits(64), gate_mix.ROT)
    elif name == "ffadd":
        gates = ow.create_ffadd_gadget(0, f, SECP, gate_mix.FFADD_SIGNS)
        out = ow.ffadd_witness(w, 0, [rng.randrange(SECP) for _ in range(3)],
                               gate_mix.FFADD_SIGNS, SECP, f.p)
    elif name == "ffmul":
        gates = ow.create_ffmul_gadget(0, f, SECP)
        out = ow.ffmul_witness(w, 0, rng.randrange(SECP), rng.randrange(SECP), SECP, f.p)
    elif name == "and":
        gates = ow.create_and_gadget(0, f, 64)
        out = ow.and_witness(w, 0, rng.getrandbits(64), rng.getrandbits(64), 64)
    elif name == "not":
        gates = ow.create_not_gadget(0, f, 3, 64)
        out = ow.not_witness(w, 0, [rng.getrandbits(64) for _ in range(3)], 64)
    elif name == "always_on_circuit":
        gates, w = gate_mix.always_on_circuit(gate_mix.ALWAYS_ON_SEED, **mods)
        out = None
    elif name == "optional_circuit":
        gates, w = gate_mix.optional_circuit(gate_mix.OPTIONAL_SEED, ow=ow, f=f)
        out = None
    else:  # two blocks of the card's gate mix
        gates, w, out = gate_mix.gate_mix_circuit(2 * gate_mix.BLOCK_ROWS, 5, ow=ow, f=f)
    return gates, [col[: max(len(gates), 1)] for col in w], out


GADGETS = ["poseidon", "complete_add", "complete_add_double", "varbasemul", "endomul",
           "endomul_scalar", "multi_range_check", "multi_range_check_compact", "xor", "rot64",
           "ffadd", "ffmul", "and", "not", "always_on_circuit", "optional_circuit", "gate_mix"]


def _as_tuples(gates):
    return [(int(g.typ), [(w.row, w.col) for w in g.wires], list(g.coeffs)) for g in gates]


@pytest.mark.parametrize("name", GADGETS)
def test_gadget_gates_and_witness_match_jax(name):
    gates, w, out = _gadget(name, PORT)
    jgates, jw, jout = _gadget(name, JAX)
    assert _as_tuples(gates) == _as_tuples(jgates)
    assert w == jw and out == jout


@functools.cache
def systems(name: str):
    gates, w, _ = _gadget(name, PORT)
    jgates, jw, _ = _gadget(name, JAX)
    size = 64 if name in ("always_on_circuit", "ffadd") else 1 << 13
    cs = ConstraintSystem.create(Fp, gates, public=0, max_poly_size=size, device="cpu")
    jcs = JConstraintSystem.create(JFp, jgates, public=0, max_poly_size=size)
    cs.endo = jcs.endo = Pallas.endos[0]
    n = cs.domain.d1.n
    return cs, jcs, [col + [0] * (n - len(col)) for col in w]


@pytest.mark.parametrize("name", GADGETS)
def test_gadget_constraint_system_matches_jax(name):
    cs, jcs, _ = systems(name)
    assert cs.domain.d1.n == jcs.domain.d1.n and cs.zk_rows == jcs.zk_rows
    assert {int(g): s for g, s in cs.selectors_d1.items()} == {
        int(g): s for g, s in jcs.selectors_d1.items()}
    assert sorted(map(int, cs.feature_flags)) == sorted(map(int, jcs.feature_flags))
    assert cs.sigma_d1 == jcs.sigma_d1 and cs.coefficients_d1 == jcs.coefficients_d1
    lcs, jlcs = cs.lookup_cs, jcs.lookup_cs
    assert (lcs is None) == (jlcs is None)
    if lcs is not None:
        assert lcs.lookup_table == jlcs.lookup_table and lcs.table_ids == jlcs.table_ids
        assert [p.value for p in lcs.info.patterns] == [p.value for p in jlcs.info.patterns]
        assert {p.value: s for p, s in lcs.selectors_d1.items()} == {
            p.value: s for p, s in jlcs.selectors_d1.items()}
        assert (lcs.info.max_per_row, lcs.info.max_joint_size, lcs.info.joint_lookup_used) == (
            jlcs.info.max_per_row, jlcs.info.max_joint_size, jlcs.info.joint_lookup_used)


def test_two_fixed_tables_share_one_lookup_system():
    """The optional circuit looks up into the XOR table (id 0, 256 rows) and
    the range-check table (id 1, 4,096 rows): has_id_0 holds, so the domain
    bound is 4,352 + 1, and the table ids column tells the two apart."""
    cs, jcs = optional_systems()
    lcs = cs.lookup_cs
    assert cs.domain.d1.n == jcs.domain.d1.n == 1 << 13
    assert lcs.table_ids is not None and set(lcs.table_ids[:4352]) == {0, 1}
    assert lcs.lookup_table == jcs.lookup_cs.lookup_table
    assert lcs.table_ids == jcs.lookup_cs.table_ids


@pytest.mark.parametrize("name", GADGETS)
def test_checker_verdicts_match_jax(name):
    cs, jcs, w = systems(name)
    checker.check_witness(cs, w, MDS)
    jchecker.check_witness(jcs, [list(c) for c in w], MDS)
    bad = [list(c) for c in w]
    bad[0][0] = (bad[0][0] + 1) % Fp.p
    with pytest.raises(ValueError) as got:
        checker.check_witness(cs, bad, MDS)
    with pytest.raises(ValueError) as want:
        jchecker.check_witness(jcs, [list(c) for c in bad], MDS)
    assert str(got.value) == str(want.value)
