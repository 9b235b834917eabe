"""The foreign-field MSM circuit (msm_circuit.py) on the CPU, against the
JAX package's, at the inputs of tests/test_msm_circuit.py and at the
production layout:
  - the planner and execute equal the JAX package's (and the naive sum of
    tests/test_msm_circuit.py) on the toy curve;
  - at TOY_LAYOUT, n = 256, scalars [11, 6] over toy_points(2):
    build_columns, MultiLogup's phase1_columns and phase2_host (seeded beta
    and joint combiner), the device make_phase2 columns (plain versions)
    and every constraint under eval_host at seeded cell values equal the
    JAX package's, and every constraint holds on every row (the array
    checker of tests/test_torch_mips.py);
  - tests/test_msm_circuit.py's negatives: a q limb past the range table
    is not in the table, and a changed final y3 breaks a constraint, at the
    same constraint and row in both packages;
  - the production layout, Layout() (16-bit limbs, 256-bit elements) over
    secp256k1: 465 trace columns, 467 after phase 1, 52 phase-2 columns, 301
    lookup slots and 453 constraints; build_columns of a plan of a few
    hundred rows equals the JAX package's, and its 453 constraints at
    seeded cell values equal the JAX package's.
Every comparison is exact. The toy proof's vector is in
tests/test_torch_column_vectors.py; the proofs run on the card
(chip_smoke.py, tests/test_torch_cuda.py)."""

import random

import numpy as np
import pytest
import torch

from proof_systems_tpu import msm_circuit as JM
from proof_systems_tpu.circuits import expr as JE
from proof_systems_tpu.fields import Fp as JFp
from proof_systems_tpu.ops import limb as jlimb
from proof_systems_tpu_torch import msm_circuit as M
from proof_systems_tpu_torch.circuits import expr as E
from proof_systems_tpu_torch.circuits.domains import EvaluationDomains
from proof_systems_tpu_torch.convert import limbs_to_numpy
from proof_systems_tpu_torch.fields import Fp
from proof_systems_tpu_torch.ops import limb
from tests.test_msm_circuit import TOY_F, naive_msm, toy_points
from tests.test_torch_mips import first_violation

# One intra-op thread: the suite runs a test process per core, and torch's
# default of one thread per core in each of them oversubscribes the machine
torch.set_num_threads(1)

P = Fp.p
CPU = torch.device("cpu")
BETA, JOINT = 4242, 777
TOY = M.ForeignCurve(f=TOY_F, a=5, b=7)
JTOY = JM.ForeignCurve(f=TOY_F, a=5, b=7)
TOY_LAYOUT, JTOY_LAYOUT = M.Layout(limb_bits=8, fbits=64), JM.Layout(limb_bits=8, fbits=64)
# secp256k1 (SEC 2, 2.4.1): the production case's foreign curve
SECP_F = (1 << 256) - (1 << 32) - 977
SECP_G = (0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
          0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8)


def both(fn, *args):
    """fn over the port's module, then over the JAX package's."""
    return fn(M, TOY, TOY_LAYOUT, Fp, *args), fn(JM, JTOY, JTOY_LAYOUT, JFp, *args)


def host_run(m, curve, scalars, points):
    start, ops = m.plan_msm(curve, scalars, points)
    rows, result = m.execute(curve, start, ops)
    return start, ops, rows, result


@pytest.mark.parametrize("scalars,k", [([13, 9, 21], 3), ([1], 1), ([11, 6], 2)])
def test_planner_and_execute_equal_jax(scalars, k):
    pts = toy_points(k)
    got, want = both(lambda m, c, L, f: host_run(m, c, scalars, pts))
    assert got == want
    assert got[3] == naive_msm(JTOY, scalars, pts)


def toy_trace(m, curve, L, f, n=256, corrupt=None):
    """The toy statement's columns, lookups and constraints in one package."""
    from proof_systems_tpu.circuits.domains import EvaluationDomains as JDomains

    start, ops, rows, result = host_run(m, curve, [11, 6], toy_points(2))
    cols = m.build_columns(f, curve, start, rows, n, L)
    if corrupt:
        corrupt(cols, len(rows))
    lg = m.make_logup(f, n, L)
    full = lg.phase1_columns(cols)
    omega = (EvaluationDomains.create(Fp, n, device=CPU) if m is M else JDomains.create(
        JFp, n)).d1.group_gen
    cons = m.constraints(f, curve, lg, start, result, len(rows), L, omega)
    return dict(cols=cols, lg=lg, full=full, phase2=lg.phase2_host(BETA, JOINT), cons=cons,
                omega=omega, n=n, nrows=len(rows))


@pytest.fixture(scope="module")
def toy():
    return both(toy_trace)


def test_columns_and_lookups_equal_jax(toy):
    got, want = toy
    assert got["cols"] == want["cols"]
    assert got["full"] == want["full"]
    assert got["phase2"] == want["phase2"]
    lg, jlg = got["lg"], want["lg"]
    assert (lg.phase1_end, lg.num_phase2, lg.h_cols, lg.phi_col, lg.m_col, lg.table_col) == (
        jlg.phase1_end, jlg.num_phase2, jlg.h_cols, jlg.phi_col, jlg.m_col, jlg.table_col)
    # TOY_LAYOUT: 292 trace columns, 294 after phase 1, 208 lookup slots, 36
    # phase-2 columns
    assert (TOY_LAYOUT.ncols, len(got["full"]), len(lg.specs), lg.num_phase2) == (292, 294, 208,
                                                                                   36)
    rng = random.Random(94)
    beta, joint = rng.randrange(P), rng.randrange(P)
    dev = lg.make_phase2(limb.device_field(Fp), CPU)(beta, joint)
    jdev = jlg.make_phase2(jlimb.device_field(JFp))(beta, joint)
    assert dev.shape == (limb.NLIMBS, 36, 256)
    assert (limbs_to_numpy(dev) == np.asarray(jdev)).all()


def eval_at_seeded_cells(cons, expr, f, ncols, n, omega, seed):
    rng = random.Random(seed)
    cur = [rng.randrange(P) for _ in range(ncols)]
    nxt = [rng.randrange(P) for _ in range(ncols)]
    ctx = expr.HostEvalContext(
        f=f, get_cell=lambda c, row: cur[c[1]] if row == expr.CURR else nxt[c[1]],
        challenges={"alpha": 1, "beta": BETA, "gamma": 0, "joint_combiner": JOINT}, endo=0,
        mds=[], point=rng.randrange(P), domain_n=n, omega=omega, zk_rows=0)
    return [expr.eval_host(c, ctx) for c in cons]


def test_constraints_equal_jax_and_hold(toy):
    got, want = toy
    assert len(got["cons"]) == len(want["cons"]) == 245
    ncols = len(got["full"]) + len(got["phase2"])
    assert eval_at_seeded_cells(got["cons"], E, Fp, ncols, 256, got["omega"], 95) == (
        eval_at_seeded_cells(want["cons"], JE, JFp, ncols, 256, want["omega"], 95))
    assert first_violation(got["full"] + got["phase2"], got["cons"], 256, got["omega"], BETA,
                           JOINT) is None


def test_corrupt_q_limb_not_in_range():
    def corrupt(cols, nrows):
        cols[TOY_LAYOUT.q[0][0]][0] += 1 << TOY_LAYOUT.lb

    for m, curve, L, f in ((M, TOY, TOY_LAYOUT, Fp), (JM, JTOY, JTOY_LAYOUT, JFp)):
        with pytest.raises(ValueError, match=r"lookup \(\d+,\) not in table 1 \(row 0\)"):
            toy_trace(m, curve, L, f, corrupt=corrupt)


def test_corrupt_result_breaks_the_same_constraint():
    def corrupt(cols, nrows):
        y = TOY_LAYOUT.y3[0]
        cols[y][nrows - 1] = (cols[y][nrows - 1] + 1) % 256

    found = []
    for (m, curve, L, f), expr in (((M, TOY, TOY_LAYOUT, Fp), E),
                                   ((JM, JTOY, JTOY_LAYOUT, JFp), JE)):
        t = toy_trace(m, curve, L, f, corrupt=corrupt)
        found.append(first_violation(t["full"] + t["phase2"], t["cons"], 256, t["omega"], BETA,
                                     JOINT, expr=expr, f=f))
    assert found[0] is not None and found[0] == found[1]


def production_plan(m):
    """Two secp256k1 points (G and 3G) and two 96-bit scalars: about 96
    doublings and 96 additions."""
    curve = m.ForeignCurve(f=SECP_F, a=0, b=7)
    g3 = curve.add(curve.dbl(SECP_G)[:2], SECP_G)[:2]
    rng = random.Random(96)
    scalars = [rng.getrandbits(96) | (1 << 95) for _ in range(2)]
    return curve, scalars, [SECP_G, g3]


@pytest.fixture(scope="module")
def production():
    out = []
    for m, f in ((M, Fp), (JM, JFp)):
        curve, scalars, points = production_plan(m)
        start, ops, rows, result = host_run(m, curve, scalars, points)
        L = m.Layout()
        cols = m.build_columns(f, curve, start, rows, 256, L)
        lg = m.make_logup(f, 1 << 16, L)
        cons = m.constraints(f, curve, lg, start, result, len(rows), L,
                             Fp.root_of_unity(16))
        out.append(dict(rows=rows, cols=cols, lg=lg, cons=cons, L=L))
    return out


def test_production_layout_columns_equal_jax(production):
    got, want = production
    assert 150 < len(got["rows"]) < 256
    assert got["cols"] == want["cols"]
    lg, L = got["lg"], got["L"]
    assert (L.ncols, lg.phase1_end, lg.num_phase2, len(lg.specs)) == (465, 467, 52, 301)
    assert (want["L"].ncols, want["lg"].phase1_end, want["lg"].num_phase2) == (465, 467, 52)


def test_production_layout_constraints_equal_jax(production):
    got, want = production
    assert len(got["cons"]) == len(want["cons"]) == 453
    ncols = got["lg"].phase1_end + got["lg"].num_phase2
    omega = Fp.root_of_unity(16)
    assert eval_at_seeded_cells(got["cons"], E, Fp, ncols, 1 << 16, omega, 97) == (
        eval_at_seeded_cells(want["cons"], JE, JFp, ncols, 1 << 16, omega, 97))
