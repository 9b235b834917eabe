"""The port's curve layer (proof_systems_tpu_torch.ops.curve_ops) against the
JAX package's DeviceCurve.add_xla / double_xla and the host curves, on the
CPU. The elementwise formulas are the same, so raw Jacobian limbs must
match exactly; to_affine is checked against the host golden model."""

import random

import numpy as np
import pytest
import torch

from proof_systems_tpu.curves import Pallas as JPallas
from proof_systems_tpu.curves import Vesta as JVesta
from proof_systems_tpu.ops.curve_ops import JPoint as JJPoint
from proof_systems_tpu.ops.curve_ops import device_curve as jdevice_curve
from proof_systems_tpu_torch import convert
from proof_systems_tpu_torch.curves import Pallas, Vesta
from proof_systems_tpu_torch.ops.curve_ops import JPoint, device_curve

# One intra-op thread: the suite runs a test process per core, and torch's
# default of one thread per core in each of them oversubscribes the machine.
torch.set_num_threads(1)

CURVES = {"Vesta": (Vesta, JVesta), "Pallas": (Pallas, JPallas)}


def special_pairs(curve, rng, n=8):
    """P+P, P+(-P), infinity on either side and on both."""
    g = curve.generator
    ps = [curve.scalar_mul(rng.randrange(1, curve.scalar.p), g) for _ in range(n)]
    qs = [curve.scalar_mul(rng.randrange(1, curve.scalar.p), g) for _ in range(n)]
    qs[0] = ps[0]
    qs[1] = curve.neg(ps[1])
    ps[2] = None
    qs[3] = None
    ps[4] = qs[4] = None
    return ps, qs


def to_port(jp: JJPoint) -> JPoint:
    return JPoint(*(convert.limbs_from_numpy(np.asarray(t), device="cpu") for t in jp))


def same_limbs(port: JPoint, jax_pt: JJPoint) -> bool:
    return all(
        np.array_equal(convert.limbs_to_numpy(a), np.asarray(b)) for a, b in zip(port, jax_pt)
    )


@pytest.mark.parametrize("name", CURVES)
def test_add_double_neg_match_jax(name):
    curve, jcurve = CURVES[name]
    rng = random.Random(201)
    ps, qs = special_pairs(curve, rng)
    jdc, dc = jdevice_curve(jcurve), device_curve(curve)
    jP, jQ = jdc.to_jacobian(jdc.pack_affine(ps)), jdc.to_jacobian(jdc.pack_affine(qs))
    P, Q = to_port(jP), to_port(jQ)

    added = dc.add(P, Q)
    assert same_limbs(added, jdc.add_xla(jP, jQ))
    assert dc.unpack_jacobian(added) == [curve.add(p, q) for p, q in zip(ps, qs)]
    doubled = dc.double(P)
    assert same_limbs(doubled, jdc.double_xla(jP))
    assert dc.unpack_jacobian(doubled) == [curve.double(p) for p in ps]
    assert same_limbs(dc.neg(P), jdc.neg(jP))


def test_select_matches_jax():
    """DeviceCurve.select per batch lane, with infinity on either side."""
    rng = random.Random(204)
    ps, qs = special_pairs(Vesta, rng)
    cond = [rng.randrange(2) == 1 for _ in ps]
    jdc, dc = jdevice_curve(JVesta), device_curve(Vesta)
    jP, jQ = jdc.to_jacobian(jdc.pack_affine(ps)), jdc.to_jacobian(jdc.pack_affine(qs))
    got = dc.select(torch.tensor(cond), to_port(jP), to_port(jQ))
    assert same_limbs(got, jdc.select(np.array(cond), jP, jQ))
    assert dc.unpack_jacobian(got) == [p if c else q for c, p, q in zip(cond, ps, qs)]


@pytest.mark.parametrize("m", [8, 6], ids=["pow2-batch-inverse", "elementwise-inverse"])
def test_to_affine_both_branches(m):
    """m = 8 goes through batch_inverse (K5 + K4), m = 6 through inv (K4)."""
    rng = random.Random(202)
    dc = device_curve(Vesta)
    ps, qs = special_pairs(Vesta, rng, n=m)
    P = dc.to_jacobian(dc.pack_affine(ps, device="cpu"))
    Q = dc.to_jacobian(dc.pack_affine(qs, device="cpu"))
    S = dc.add(dc.double(P), Q)  # z no longer 1
    aff = dc.to_affine(S)
    want = [Vesta.add(Vesta.double(p), q) for p, q in zip(ps, qs)]
    assert dc.unpack_affine(aff) == want
    assert aff.inf.tolist() == [w is None for w in want]


def test_pack_and_jacobian_roundtrip():
    rng = random.Random(203)
    dc = device_curve(Vesta)
    ps, _ = special_pairs(Vesta, rng)
    A = dc.pack_affine(ps, device="cpu")
    assert dc.unpack_affine(A) == ps
    assert dc.unpack_jacobian(dc.to_jacobian(A)) == ps
    inf = dc.inf_jacobian((3,), device="cpu")
    assert dc.unpack_jacobian(inf) == [None] * 3
