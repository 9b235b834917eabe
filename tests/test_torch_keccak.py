"""o1vm's Keccak-f proof (o1vm/keccak.py) on the CPU, against the JAX
package's, at the inputs of tests/test_keccak.py:
  - keccak_f, keccak256 and sha3_256 on its vectors and seeded states;
  - the witness of state0 from random.Random(93) at n = 32: all 4,160 bit
    columns, the selector and the 64 round-constant columns, and the final
    state;
  - every round constraint and state pin under eval_host at seeded cell
    values and a seeded point;
  - the class-batched quotient numerator over d8: the port's (its limb ops,
    through the plain versions) equals the JAX package's (jit) on the same
    d8 evaluations of that trace (the JAX package's NTT) and the same alpha,
    and equals eval_host of the combined constraint at four d8 points;
  - a corrupted trace breaks a constraint (tests/test_keccak.py:94).
Every comparison is exact. The proofs themselves run on the card
(chip_smoke.py, tests/test_torch_cuda.py), against the JAX package's vector
(tests/test_torch_column_vectors.py)."""

import hashlib
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proof_systems_tpu.circuits import expr as JE
from proof_systems_tpu.circuits.domains import EvaluationDomains as JEvaluationDomains
from proof_systems_tpu.fields import Fp as JFp
from proof_systems_tpu.o1vm import keccak as jkeccak
from proof_systems_tpu.ops import limb as jlimb
from proof_systems_tpu_torch.circuits import expr as E
from proof_systems_tpu_torch.circuits.domains import EvaluationDomains
from proof_systems_tpu_torch.convert import limbs_from_numpy, limbs_to_numpy
from proof_systems_tpu_torch.fields import Fp
from proof_systems_tpu_torch.o1vm import keccak, pickles
from proof_systems_tpu_torch.o1vm.keccak import LAYOUT, ROUNDS
from proof_systems_tpu_torch.ops import limb

torch.set_num_threads(2)

P = Fp.p
N = 32
CPU = torch.device("cpu")


def state(seed: int):
    rng = random.Random(seed)
    return [[rng.getrandbits(64) for _ in range(5)] for _ in range(5)]


def test_hashes_and_permutation_equal_jax():
    for data in (b"", b"abc", bytes(range(256)) * 3):
        assert keccak.keccak256(data) == jkeccak.keccak256(data)
        assert keccak.sha3_256(data) == jkeccak.sha3_256(data) == hashlib.sha3_256(data).digest()
    assert keccak.keccak256(b"abc").hex() == (
        "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45")
    for seed in (90, 91, 92, 93):
        assert keccak.keccak_f(state(seed)) == jkeccak.keccak_f(state(seed))


@pytest.fixture(scope="module")
def trace():
    """tests/test_keccak.py's statement at n = 32: the port's columns (the
    4,160 bit columns, then the selector and the 64 round-constant columns)
    and the final state, with the JAX package's."""
    state0 = state(93)
    cols, final = keccak.build_columns(Fp, state0, N)
    jcols, jfinal = jkeccak.build_columns(JFp, state0, N)
    fixed = keccak._fixed_columns(Fp, N)
    jfixed = [jkeccak.round_selector_column(JFp, N)] + [
        [(jkeccak.RC[r] >> z) & 1 if r < ROUNDS else 0 for r in range(N)] for z in range(64)]
    return dict(state0=state0, cols=cols + fixed, final=final, jcols=jcols + jfixed,
                jfinal=jfinal)


def test_build_columns_equal_jax(trace):
    assert len(trace["cols"]) == LAYOUT.ncols + 65 == 4225
    assert trace["cols"] == trace["jcols"]
    assert trace["final"] == trace["jfinal"] == keccak.keccak_f(trace["state0"])


def _host_ctx(mod, get_cell, point, omega, alpha=1):
    return mod.HostEvalContext(
        f=Fp if mod is E else JFp, get_cell=get_cell,
        challenges={"alpha": alpha, "beta": 0, "gamma": 0, "joint_combiner": 0},
        endo=0, mds=[], point=point, domain_n=N, omega=omega, zk_rows=0)


def test_constraints_and_pins_equal_jax(trace):
    """Each constraint of both packages (round constraints, then the state
    pins) under eval_host at seeded cell values and a seeded point."""
    sel_idx, rc_idx, cons = keccak._statement_constraints(Fp, trace["state0"], trace["final"])
    jcons = jkeccak.constraints(JFp, sel_idx, rc_idx) + jkeccak.state_pin_constraints(
        JFp, trace["state0"], trace["final"], ROUNDS)
    assert len(cons) == len(jcons) == LAYOUT.ncols + 320 + 1600 + 1600 + 2 * 1600
    rng = random.Random(94)
    ncols = len(trace["cols"])
    cur = [rng.randrange(P) for _ in range(ncols)]
    nxt = [rng.randrange(P) for _ in range(ncols)]
    get = lambda c, row: cur[c[1]] if row == E.CURR else nxt[c[1]]  # noqa: E731
    omega = EvaluationDomains.create(Fp, N, device=CPU).d1.group_gen
    point = rng.randrange(P)
    ctx, jctx = _host_ctx(E, get, point, omega), _host_ctx(JE, get, point, omega)
    got = [E.eval_host(c, ctx) for c in cons]
    assert got == [JE.eval_host(c, jctx) for c in jcons]
    assert len(set(got)) > len(got) // 2  # the values are not all alike


@pytest.fixture(scope="module")
def numerators(trace):
    """The d8 evaluations of the trace (the JAX package's NTT), a seeded
    128-bit alpha, and each package's batched numerator over them."""
    JF = jlimb.device_field(JFp)
    jdomain = JEvaluationDomains.create(JFp, N)
    cols = trace["cols"]
    coeffs = jdomain.d1.intt(JF.pack_mont([v for c in cols for v in c], shape=(len(cols), N)))
    jev8 = jdomain.d8.ntt(jnp.concatenate(
        [coeffs, jnp.zeros((16, len(cols), 7 * N), dtype=coeffs.dtype)], axis=-1))
    ev8 = limbs_from_numpy(np.asarray(jev8), device=CPU)

    F = limb.device_field(Fp)
    domain = EvaluationDomains.create(Fp, N, device=CPU)
    sel_idx, rc_idx, cons = keccak._statement_constraints(Fp, trace["state0"], trace["final"])
    alpha = random.Random(95).getrandbits(128)
    lag = pickles._unnormalized_lagrange_evals(F, cons, N, domain.d1.group_gen, domain.d8, P,
                                               device=CPU)
    ctx = E.DeviceEvalContext(F=F, columns={}, challenges={"alpha": alpha}, endo=0, mds=[],
                              domain_n=N, zk_rows=0, omega=domain.d1.group_gen,
                              unnormalized_lagrange=lag)
    num = keccak.batched_numerator(Fp, sel_idx, rc_idx, trace["state0"], trace["final"])(ev8, ctx)

    jctx = JE.DeviceEvalContext(
        F=JF, columns={}, challenges={"alpha": alpha}, endo=0, mds=[], domain_n=N, zk_rows=0,
        omega=domain.d1.group_gen,
        unnormalized_lagrange={i: jnp.asarray(limbs_to_numpy(v)) for i, v in lag.items()})
    jrun = jkeccak.batched_numerator(JFp, sel_idx, rc_idx, trace["state0"], trace["final"])
    jnum = np.asarray(jax.jit(lambda e: jrun(e, jctx))(jev8))
    return dict(ev8=ev8, num=num, jnum=jnum, alpha=alpha, lag=lag, cons=cons, domain=domain)


def test_numerator_equals_jax(numerators):
    assert numerators["num"].shape == (limb.NLIMBS, 8 * N)
    assert (limbs_to_numpy(numerators["num"]) == numerators["jnum"]).all()
    assert not limb.is_zero(limb.device_field(Fp), numerators["num"]).all()


@pytest.mark.parametrize("k", [3, 77, 8 * ROUNDS + 5, 8 * N - 1])
def test_numerator_equals_combined_constraint(numerators, k):
    """At d8 point k (off the d1 rows, where (x^n - 1)/(x - w^i) is the
    rational form) the numerator is eval_host of sum_i alpha^i c_i, the
    NEXT row being point k + 8."""
    F = limb.device_field(Fp)
    d8, n8 = numerators["domain"].d8, 8 * N
    ev8 = numerators["ev8"]
    cur = F.unpack_mont(ev8[:, :, k])
    nxt = F.unpack_mont(ev8[:, :, (k + 8) % n8])
    get = lambda c, row: cur[c[1]] if row == E.CURR else nxt[c[1]]  # noqa: E731
    ctx = _host_ctx(E, get, pow(d8.group_gen, k, P), numerators["domain"].d1.group_gen,
                    numerators["alpha"])
    combined = E.combine_constraints(range(len(numerators["cons"])), numerators["cons"])
    assert E.eval_host(combined, ctx) == F.unpack_mont(numerators["num"][:, k])[0]


def test_corrupted_trace_breaks_a_constraint(trace):
    """tests/test_keccak.py:94: one state bit flipped in round 5 breaks a
    constraint of round 4 (its NEXT row), in both packages."""
    cols = [list(c) for c in trace["cols"]]
    cols[LAYOUT.abit(2, 3, 17)][5] ^= 1
    sel_idx, rc_idx, cons = keccak._statement_constraints(Fp, trace["state0"], trace["final"])
    jcons = jkeccak.constraints(JFp, sel_idx, rc_idx)
    get = lambda c, row: cols[c[1]][4 if row == E.CURR else 5]  # noqa: E731
    for mod, cs in ((E, cons[: len(jcons)]), (JE, jcons)):
        ctx = _host_ctx(mod, get, 0, 1)
        assert any(mod.eval_host(c, ctx) != 0 for c in cs)
    ctx = _host_ctx(E, lambda c, row: trace["cols"][c[1]][4 if row == E.CURR else 5], 0, 1)
    assert all(E.eval_host(c, ctx) == 0 for c in cons[: len(jcons)])
