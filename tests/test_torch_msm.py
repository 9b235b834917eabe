"""The port's Pippenger MSM (proof_systems_tpu_torch.ops.msm) on the CPU,
where the plain versions of K2, K6, K7 and K8 run inside it, against the
JAX package's _msm_affine_scaled and the host golden MSM, over pre-scaled
bases and over unscaled ones (shared, one set per MSM, and a table with
composed row indices); and K6's reconstruction identity against
ops/scan.blocked_prefix_scan.

Scaled bases are built with exact host arithmetic, as
tests/test_msm_graph.py does (the doubling chain is slow on the CPU)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proof_systems_tpu.curves import Vesta as JVesta
from proof_systems_tpu.ops import msm as jmsm
from proof_systems_tpu.ops.curve_ops import JPoint as JJPoint
from proof_systems_tpu.ops.curve_ops import device_curve as jdevice_curve
from proof_systems_tpu.ops.scan import blocked_prefix_scan
from proof_systems_tpu_torch import convert
from proof_systems_tpu_torch.curves import Vesta
from proof_systems_tpu_torch.ops import kernels, limb, msm
from proof_systems_tpu_torch.ops.curve_ops import JPoint, device_curve

# One intra-op thread: the suite runs a test process per core, and torch's
# default of one thread per core in each of them oversubscribes the machine.
torch.set_num_threads(1)


def rand_points(rng, n):
    g = Vesta.generator
    return [Vesta.scalar_mul(rng.randrange(1, Vesta.scalar.p), g) for _ in range(n)]


def host_scaled(pts, c):
    """(8, W, n) affine-encoded scaled basis 2^(cw)*P_i, host-exact."""
    dc = device_curve(Vesta)
    W, n = msm.num_windows(c), len(pts)
    flat = [
        None if p is None else Vesta.scalar_mul(1 << (c * w), p)
        for w in range(W)
        for p in pts
    ]
    A = dc.pack_affine(flat, device="cpu")
    J = dc.to_jacobian(A)
    return JPoint(*(t.reshape(8, W, n) for t in J))


def scalar_rows(rng, b, n, zero_row=None):
    rows = [[rng.randrange(Vesta.scalar.p) for _ in range(n)] for _ in range(b)]
    rows[0][3] = 0
    if zero_row is not None:
        rows[zero_row] = [0] * n
    flat = [s for row in rows for s in row]
    return rows, torch.from_numpy(limb.ints_to_limbs(flat, shape=(b, n)))


def test_msm_b3_matches_jax_and_host():
    """b = 3 (one all-zero row), c = 6, n = 24 (not a multiple of 128),
    an infinity point."""
    rng = random.Random(401)
    n, b, c = 24, 3, 6
    pts = rand_points(rng, n)
    pts[5] = None
    scaled = host_scaled(pts, c)
    rows, scal = scalar_rows(rng, b, n, zero_row=1)
    got = msm.msm(Vesta, scal, c=c, scaled=scaled, device="cpu")
    assert got == [Vesta.msm(row, pts) for row in rows]
    assert got[1] is None

    jdc = jdevice_curve(JVesta)
    jscaled = JJPoint(*(jnp.asarray(convert.limbs_to_numpy(t)) for t in scaled))
    jscal = jnp.asarray(convert.limbs_to_numpy(scal))
    want = jmsm._decode_packed_affine(jdc, jmsm._msm_affine_scaled(jdc, jscal, jscaled, c))
    assert got == want


@pytest.mark.parametrize("c", [5, 7])
def test_msm_b1_small_c_matches_host(c):
    """b = 1, the shape the TPU build padded to b = 2; sparse scalars."""
    rng = random.Random(402 + c)
    n = 30
    pts = rand_points(rng, n)
    pts[0] = None
    rows, scal = scalar_rows(rng, 1, n)
    rows[0][10:20] = [0] * 10
    scal = torch.from_numpy(limb.ints_to_limbs(rows[0], shape=(1, n)))
    got = msm.msm(Vesta, scal, c=c, scaled=host_scaled(pts, c), device="cpu")
    assert got == [Vesta.msm(rows[0], pts)]


def test_msm_builds_scaled_basis_and_splits(monkeypatch):
    """Without a scaled basis msm takes the unscaled path (window sums, then
    K8), as the JAX package does, and builds no scaled basis; a small batch
    limit forces the batch split."""
    rng = random.Random(404)
    n, b, c = 6, 2, 6
    pts = rand_points(rng, n)
    dc = device_curve(Vesta)
    rows, scal = scalar_rows(rng, b, n)
    monkeypatch.setattr(msm, "MAX_WINDOW_ELEMS", msm.num_windows(c) * n)

    def no_scaled_basis(*args):
        raise AssertionError("msm built a scaled basis for unscaled points")

    monkeypatch.setattr(msm, "scale_basis", no_scaled_basis)
    got = msm.msm(Vesta, scal, dc.pack_affine(pts, device="cpu"), c=c, device="cpu")
    assert got == [Vesta.msm(row, pts) for row in rows]


def _jax_prefix(jdc, pts_rows, n):
    """Inclusive prefix sums by the JAX package's blocked scan."""
    ps = [jdc.to_jacobian(jdc.pack_affine(r)) for r in pts_rows]
    stacked = JJPoint(*(jnp.stack([getattr(p, k) for p in ps]) for k in ("x", "y", "z")))
    stacked = JJPoint(*(jnp.moveaxis(t, 0, 1) for t in stacked))  # (16, B, n)
    ident = jdc.inf_jacobian((len(pts_rows), 1))
    return blocked_prefix_scan(lambda p, q: jdc.add(p, q), ident, stacked, n)


@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "general"])
def test_scan_parts_reconstruction_matches_blocked_scan(mixed):
    """K6 (plain on the CPU): excl[j // cp] + partial[j] is the inclusive
    prefix, as group elements, for a row length of 300 (cp = 3)."""
    rng = random.Random(405)
    B, n = 2, 300
    rows = [rand_points(rng, n) for _ in range(B)]
    rows[0][7] = rows[1][299] = None
    dc = device_curve(Vesta)
    J = dc.to_jacobian(dc.pack_affine([p for r in rows for p in r], device="cpu"))
    if not mixed:  # a general Jacobian input: z != 1
        J = dc.double(J)
        rows = [[Vesta.double(p) for p in r] for r in rows]
    J = JPoint(*(t.reshape(8, B, n) for t in J))
    partial, excl, cp = kernels.ec_prefix_scan_parts(dc.F, *J, mixed=mixed)
    assert cp == 3 and partial[0].shape == (8, B, 384) and excl[0].shape == (8, B, 128)
    j = torch.arange(n)
    lane = (j // cp).expand(8, B, n)
    at = j.expand(8, B, n)
    pref = dc.add(
        JPoint(*(torch.gather(t, -1, lane) for t in excl)),
        JPoint(*(torch.gather(t, -1, at) for t in partial)),
    )
    got = dc.unpack_jacobian(JPoint(*(t.reshape(8, B * n) for t in pref)))

    jdc = jdevice_curve(JVesta)
    jp = _jax_prefix(jdc, rows, n)
    want = jdc.unpack_jacobian(JJPoint(*(t.reshape(16, B * n) for t in jp)))
    assert got == want

    fused = kernels.ec_prefix_scan_fused(dc.F, *J)
    assert dc.unpack_jacobian(JPoint(*(t.reshape(8, B * n) for t in fused))) == want


def test_default_window_bits_matches_jax():
    for n in [9, 65, 257, 2**11 + 1, 2**15 + 1, 2**16 + 1, 2**20]:
        assert msm.default_window_bits(n) == jmsm.default_window_bits(n)
    assert msm.default_window_bits(2**16 + 1) == 11


def test_window_digits_sort_and_gather():
    rng = random.Random(406)
    n, b, c = 50, 2, 9
    rows, scal = scalar_rows(rng, b, n)
    digits = msm.window_digits(scal, c)
    for w in range(msm.num_windows(c)):
        for i in range(b):
            assert digits[w, i].tolist() == [(s >> (c * w)) & ((1 << c) - 1) for s in rows[i]]
    order, sdig = msm.sort_digits(digits)
    assert torch.equal(sdig, torch.sort(digits, dim=-1).values)
    assert torch.equal(torch.gather(digits, -1, order), sdig)
    stable = torch.sort(digits, dim=-1, stable=True).indices
    assert torch.equal(order, stable)
    jdig = np.stack(
        [np.asarray(jmsm._digits(jnp.asarray(convert.limbs_to_numpy(scal)), c, w))
         for w in range(msm.num_windows(c))]
    )
    assert np.array_equal(jdig, digits.numpy())


@pytest.mark.parametrize("b", [1, 2])
def test_unscaled_msm_matches_jax_host_msm(b):
    """msm() over shared affine bases with no scaled basis, at the default
    window size, against the JAX package's msm (its host path on the CPU);
    a point at infinity among the bases."""
    rng = random.Random(407 + b)
    n = 12
    pts = rand_points(rng, n)
    pts[4] = None
    rows, scal = scalar_rows(rng, b, n)
    dc = device_curve(Vesta)
    got = msm.msm(Vesta, scal, dc.pack_affine(pts, device="cpu"), device="cpu")
    jdc = jdevice_curve(JVesta)
    want = jmsm.msm(JVesta, jnp.asarray(convert.limbs_to_numpy(scal)), jdc.pack_affine(pts))
    assert got == want


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("source", ["per_msm_points", "table_rows"])
def test_unscaled_sources_match_host_msm(source, b):
    """MSMs over one point set each, given as (8, b, n) bases or as a
    packed table with composed row indices (the IPA rounds' forms), with a
    point at infinity."""
    rng = random.Random(409 + b)
    n, c = 10, 6
    table_pts = rand_points(rng, 2 * n)
    table_pts[3] = None
    sets = [table_pts[:n], table_pts[n:][::-1]][:b]  # MSM 0 and MSM 1
    rows, scal = scalar_rows(rng, b, n)
    dc = device_curve(Vesta)
    if source == "per_msm_points":
        A = dc.pack_affine([p for pts in sets for p in pts], device="cpu")
        src = type(A)(A.x.reshape(8, b, n), A.y.reshape(8, b, n), A.inf.reshape(b, n))
    else:
        idx = torch.tensor([list(range(n)), list(range(2 * n - 1, n - 1, -1))][:b])
        src = (dc.pack_affine(table_pts, device="cpu"), idx.expand(msm.num_windows(c), b, n))
    got = dc.unpack_affine(msm.msm_affine(dc, scal, src, c))
    want = [JVesta.msm(row, pts) for row, pts in zip(rows, sets)]
    assert got == want
