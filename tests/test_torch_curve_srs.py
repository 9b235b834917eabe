"""The rest of the port's curve and SRS layer against the JAX package on the
CPU: DeviceCurve.add_mixed and sum_points, scalar_mul_const,
SRS.lagrange_commitments (and its memory and disk caches) and
load_reference_srs. Inputs are seeded; every comparison is exact, raw
Jacobian limbs where both sides return them, and each result is also held
against the host curve."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proof_systems_tpu.circuits.domains import EvaluationDomains as JEvaluationDomains
from proof_systems_tpu.curves import Pallas as JPallas
from proof_systems_tpu.curves import Vesta as JVesta
from proof_systems_tpu.fields import Fp as JFp
from proof_systems_tpu.ops import curve_ops as jcurve_ops
from proof_systems_tpu.ops import limb as jlimb
from proof_systems_tpu.ops.curve_ops import APoint as JAPoint
from proof_systems_tpu.ops.curve_ops import JPoint as JJPoint
from proof_systems_tpu.ops.curve_ops import device_curve as jdevice_curve
from proof_systems_tpu.poly_commitment import srs as jsrs
from proof_systems_tpu_torch import convert
from proof_systems_tpu_torch.circuits.domains import EvaluationDomains
from proof_systems_tpu_torch.curves import Pallas, Vesta
from proof_systems_tpu_torch.fields import Fp
from proof_systems_tpu_torch.ops import curve_ops, limb, msm
from proof_systems_tpu_torch.ops.curve_ops import APoint, JPoint, device_curve
from proof_systems_tpu_torch.poly_commitment import srs as srs_mod

# One intra-op thread: the suite runs a test process per core.
torch.set_num_threads(1)

CURVES = {"Vesta": (Vesta, JVesta), "Pallas": (Pallas, JPallas)}


def to_port(jp: JJPoint) -> JPoint:
    return JPoint(*(convert.limbs_from_numpy(np.asarray(t), device="cpu") for t in jp))


def to_port_affine(ja: JAPoint) -> APoint:
    x, y = (convert.limbs_from_numpy(np.asarray(t), device="cpu") for t in ja[:2])
    return APoint(x, y, torch.from_numpy(np.asarray(ja.inf).copy()))


def same_limbs(port: JPoint, jax_pt: JJPoint) -> bool:
    return all(
        np.array_equal(convert.limbs_to_numpy(a), np.asarray(b)) for a, b in zip(port, jax_pt)
    )


def random_points(curve, rng, n):
    g = curve.generator
    return [curve.scalar_mul(rng.randrange(1, curve.scalar.p), g) for _ in range(n)]


@pytest.mark.parametrize("doubled", [False, True], ids=["z=1", "z-doubled"])
@pytest.mark.parametrize("name", CURVES)
def test_add_mixed_matches_jax(name, doubled):
    """Lanes: q = p (doubling), q = -p, p at infinity, q at infinity, both,
    then generic lanes. With `doubled` the Jacobian operand is 2p, whose z
    is not 1."""
    curve, jcurve = CURVES[name]
    rng = random.Random(211)
    ps = random_points(curve, rng, 8)
    qs = random_points(curve, rng, 8)
    lhs = [curve.double(p) for p in ps] if doubled else list(ps)
    qs[0], qs[1] = lhs[0], curve.neg(lhs[1])
    ps[2] = lhs[2] = None
    qs[3] = None
    ps[4] = lhs[4] = qs[4] = None
    jdc, dc = jdevice_curve(jcurve), device_curve(curve)
    jP = jdc.to_jacobian(jdc.pack_affine(ps))
    if doubled:
        jP = jdc.double_xla(jP)
    jQ = jdc.pack_affine(qs)

    got = dc.add_mixed(to_port(jP), to_port_affine(jQ))
    assert same_limbs(got, jdc.add_mixed(jP, jQ))
    assert dc.unpack_jacobian(got) == [curve.add(p, q) for p, q in zip(lhs, qs)]


@pytest.mark.parametrize("size", [1, 3, 4, 7])
def test_sum_points_matches_jax(size):
    """Two rows of `size` points with infinity inside, summed along the
    last axis (padded with infinity to a power of two)."""
    rng = random.Random(212 + size)
    pts = random_points(Vesta, rng, 2 * size)
    pts[0] = None
    if size > 2:
        pts[size + 1] = Vesta.neg(pts[size])  # a row with a cancelling pair
    jdc, dc = jdevice_curve(JVesta), device_curve(Vesta)
    jP = jdc.to_jacobian(jdc.pack_affine(pts))
    jP = JJPoint(*(t.reshape(16, 2, size) for t in jP))

    got = dc.sum_points(to_port(jP))
    assert got.x.shape == (limb.NLIMBS, 2, 1)
    assert same_limbs(got, jdc.sum_points(jP))
    want = [None, None]
    for r in range(2):
        for p in pts[r * size : (r + 1) * size]:
            want[r] = Vesta.add(want[r], p)
    assert dc.unpack_jacobian(JPoint(*(t.reshape(8, 2) for t in got))) == want


@pytest.mark.parametrize("which", ["zero", "one", "r-1", "seeded"])
def test_scalar_mul_const_matches_jax(which):
    """[k]P for one scalar over three points (one at infinity)."""
    r = Vesta.scalar.p
    k = {"zero": 0, "one": 1, "r-1": r - 1, "seeded": random.Random(213).randrange(r)}[which]
    pts = random_points(Vesta, random.Random(214), 3)
    pts[1] = None
    jdc, dc = jdevice_curve(JVesta), device_curve(Vesta)
    jP = jdc.to_jacobian(jdc.pack_affine(pts))
    jk = jnp.asarray(jlimb.ints_to_limbs([k]).reshape(16))
    port_k = torch.from_numpy(limb.ints_to_limbs([k])).reshape(limb.NLIMBS)

    got = curve_ops.scalar_mul_const(dc, port_k, to_port(jP))
    assert same_limbs(got, jcurve_ops.scalar_mul_const(jdc, jk, jP))
    assert dc.unpack_jacobian(got) == [Vesta.scalar_mul(k, p) for p in pts]


N_LAG = 16


@pytest.fixture(scope="module")
def lagrange_srs():
    g = [srs_mod.derive_g(Vesta, i) for i in range(N_LAG)]
    return g, srs_mod.derive_h(Vesta)


@pytest.mark.parametrize("m", [1, 2, 5])
def test_lagrange_commitments_match_jax(lagrange_srs, m, tmp_path, monkeypatch):
    """The m commitments equal the JAX package's and the host MSM of the
    Lagrange coefficients n^-1 w^(-ij); a second call and a call on a new
    SRS over the same cache directory run no MSM."""
    g, h = lagrange_srs
    domain = EvaluationDomains.create(Fp, N_LAG, device="cpu").d1
    srs = srs_mod.SRS(Vesta, g, h, torch.device("cpu"), cache_dir=tmp_path)
    got = srs.lagrange_commitments(domain, m)

    monkeypatch.setattr(jsrs, "CACHE_DIR", tmp_path / "jax")
    jdomain = JEvaluationDomains.create(JFp, N_LAG).d1
    assert got == jsrs.SRS(JVesta, g, h).lagrange_commitments(jdomain, m)
    p, w_inv = Fp.p, pow(domain.group_gen, -1, Fp.p)
    n_inv = pow(N_LAG, -1, p)
    for i, pt in enumerate(got):
        coeffs = [n_inv * pow(w_inv, i * j, p) % p for j in range(N_LAG)]
        assert pt == Vesta.msm(coeffs, g)

    def no_msm(*args, **kw):
        raise AssertionError("a cached call ran the MSM")

    monkeypatch.setattr(msm, "msm", no_msm)
    assert srs.lagrange_commitments(domain, m) == got
    assert srs.lagrange_commitments(domain, 1) == got[:1]
    fresh = srs_mod.SRS(Vesta, g, h, torch.device("cpu"), cache_dir=tmp_path)
    assert fresh.lagrange_commitments(domain, m) == got
    assert [p.name for p in tmp_path.glob("lagrange_*.npy")] == [f"lagrange_vesta_{N_LAG}_{m}.npy"]


def compress(curve, pt, flag_override=None) -> bytes:
    """33-byte arkworks compressed point with its rmp bin8 header."""
    if pt is None:
        raw = bytes(32) + bytes([0x40])
    else:
        x, y = pt
        raw = x.to_bytes(32, "little") + bytes([0x80 if y > curve.base.p - y else 0x00])
    return b"\xc4\x21" + raw


@pytest.mark.parametrize("limit", [None, 5])
def test_load_reference_srs_matches_jax(tmp_path, limit):
    """A file in the reference's rmp layout [Vec<G>, G], written here from
    the derived points with one at infinity, read back by the port and by
    the JAX package."""
    g = [srs_mod.derive_g(Vesta, i) for i in range(8)]
    g[3] = None
    h = srs_mod.derive_h(Vesta)
    flags = {compress(Vesta, pt)[-1] for pt in g}
    assert flags == {0x00, 0x40, 0x80}, "the file must hold both roots and infinity"
    path = tmp_path / "vesta.srs"
    path.write_bytes(b"\x92\xdd" + len(g).to_bytes(4, "big")
                     + b"".join(compress(Vesta, pt) for pt in g) + compress(Vesta, h))

    got = srs_mod.load_reference_srs(path, Vesta, limit)
    assert got == (g[:limit], h)
    assert got == jsrs.load_reference_srs(str(path), JVesta, limit)


def test_load_reference_srs_rejects_other_files(tmp_path):
    path = tmp_path / "bad.srs"
    path.write_bytes(b"\x93\xdd" + bytes(4))
    with pytest.raises(ValueError, match="not an rmp"):
        srs_mod.load_reference_srs(path, Vesta)
