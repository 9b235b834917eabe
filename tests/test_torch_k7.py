"""K7 (ec_prefix_scan_fused) on the CPU. On the card the wrapper runs K6's
kernels with general adds (k_ec_parts, a team of S threads a lane chunk,
then k_ec_lane_offsets) into scratch, and a combine kernel that adds each
position's lane offset to its partial sum, one thread a position
(csrc/curve_kernels.cu k_ec_combine). That association order is modelled
here with the plain curve formulas (tests/test_torch_k6.py's team_model,
then add(excl[j // cp], partial[j])) and held, as group elements, against
the host curve's running sums and the JAX package's prefix scan, for every
team size, on rows where the combine meets P + (-P) and P + P at a lane
boundary, identities at a boundary, a lane of identities and rows that
start with lanes of identities, written as the MSM writes them, (R, R, 0);
at S = 1 the model is the plain version limb for limb. Also the scratch
and the geometry the wrapper derives at the main path's shapes. The kernel
itself: tests/test_torch_cuda.py."""

import functools

import numpy as np
import pytest
import torch

from proof_systems_tpu.curves import Vesta as JVesta
from proof_systems_tpu.ops import msm as jmsm
from proof_systems_tpu.ops.curve_ops import JPoint as JJPoint
from proof_systems_tpu.ops.curve_ops import device_curve as jdevice_curve
from proof_systems_tpu_torch.curves import Vesta
from proof_systems_tpu_torch.ops import kernels, msm
from proof_systems_tpu_torch.ops.curve_ops import JPoint, device_curve
from test_torch_k6 import host_prefix, team_model

torch.set_num_threads(1)

NL, LANES = kernels.NL, kernels.LANES
TEAMS = [1, 2, 4, 8, 16]
# K7's calls on the main path at k = 16: (windows, columns) and the buckets
# but bucket 0 (2^c - 1): the witness, t and z commits, the fold steps, the
# tail rounds, the sg MSM (the verifier's MSM has the z commit's shape)
MAIN_SHAPES = [((24, 15), 2047), ((24, 7), 2047), ((24, 1), 2047), ((26, 2), 1023),
               ((29, 2), 511), ((32, 2), 255), ((37, 2), 127), ((37, 1), 127)]


def k7_model(F, x, y, z, S: int):
    """K7's values on (8, rows, n) rows with S threads a lane chunk: K6's
    general partial sums and lane offsets (team_model), then the combine,
    excl[j // cp] + partial[j] for j < n (the padding is not read)."""
    n = x.shape[-1]
    partial, excl, cp = team_model(F, x, y, z, False, S)
    j = torch.arange(n)
    off = tuple(kernels.to16(t)[..., j // cp] for t in excl)
    part = tuple(kernels.to16(t)[..., :n] for t in partial)
    return tuple(map(kernels.from16, kernels.ec_add16(kernels.field16(F, x.device), off, part)))


def k7_rows(seed: int, rows: int, n: int):
    """Host points, row-major, from 32 random points picked by a numpy
    generator; where the row is long enough: in rows 0 and 1 lane 0 holds
    only P (at its first position), so lane 1's offset is P, and lane 1
    starts with -P in row 0 (the combine's infinity fallback) and with P in
    row 1 (its doubling fallback), with identities at the last position of
    lane 2 and the first of lane 3 and lane 4 all identities; row 2 starts
    with three lanes of identities (as the top window's rows of an MSM's
    bucket scan do), so its offsets and outputs there are the identity."""
    gen = np.random.default_rng(seed)
    pool = [Vesta.scalar_mul(int(k), Vesta.generator)
            for k in gen.integers(1, 1 << 62, size=32)]
    idx = gen.integers(0, 32, size=(rows, n))
    cp = kernels.scan_chunk(n)
    out = []
    for r in range(rows):
        row = [pool[i] for i in idx[r]]
        P = pool[r]

        def put(lo, hi, pt):
            for j in range(lo, min(hi, n)):
                row[j] = pt

        if r % 3 == 2:
            put(0, 3 * cp, None)
        else:
            put(0, 1, P)
            put(1, cp, None)
            put(cp, cp + 1, Vesta.neg(P) if r % 3 == 0 else P)
            put(3 * cp - 1, 3 * cp + 1, None)
            put(4 * cp, 5 * cp, None)
        out += row
    return out


def general_input(pts, rows: int, n: int):
    """The host points doubled, as (8, rows, n) general Jacobian limbs (z !=
    R) with the identities as the MSM makes them, (R, R, 0); and the
    doubled host points."""
    dc = device_curve(Vesta)
    J = dc.double(dc.to_jacobian(dc.pack_affine(pts, device="cpu")))
    inf = torch.tensor([p is None for p in pts])
    one = dc.F.one_mont((rows * n,), device="cpu")
    J = JPoint(torch.where(inf, one, J.x), torch.where(inf, one, J.y), J.z)
    return dc, JPoint(*(t.reshape(NL, rows, n) for t in J)), [Vesta.double(p) for p in pts]


def as_points(dc, out, rows: int, n: int):
    """Host affine points of (8, rows, n) Jacobian limbs, through to_affine's
    batch inversion (the points padded to a power of two with z = R)."""
    m = rows * n
    one = dc.F.one_mont(((1 << (m - 1).bit_length()) - m,), device="cpu")
    J = JPoint(*(torch.cat([t.reshape(NL, m), one], -1) for t in out))
    return dc.unpack_jacobian(J)[:m]


@pytest.mark.parametrize("n,S", [(n, S) for n in (1, 100, 127, 129) for S in TEAMS]
                         + [(511, 2), (511, 4), (511, 8), (2047, 1), (2047, 16)])
def test_k7_model_gives_running_sums(n, S):
    """Every team size at n = 1, n < 128 (cp = 1), 127 (the tail rounds) and
    129 (one past 128, cp = 2); teams of 2-8 at 511 (cp = 4: a position or
    more a member, none for half of a team of 8); one thread and a team of
    16 at 2,047 (the commits' rows, cp = 16)."""
    rows = 3
    dc, J, pts = general_input(k7_rows(800 + n, rows, n), rows, n)
    out = k7_model(dc.F, *J, S)
    assert all(t.shape == (NL, rows, n) for t in out)
    assert as_points(dc, out, rows, n) == host_prefix(pts, rows, n)
    if S == 1:  # one thread a chunk: the plain version's association order
        for a, b in zip(out, kernels.ec_prefix_scan_fused_plain(dc.F, *J)):
            assert torch.equal(a, b)


@functools.lru_cache(maxsize=None)
def _jax_prefix(seed: int, rows: int, n: int):
    """The JAX package's inclusive prefix scan (ops/msm.py _ec_prefix: the
    blocked scan on the CPU) of k7_rows(seed, rows, n), doubled, as host
    affine points."""
    pts = k7_rows(seed, rows, n)
    jdc = jdevice_curve(JVesta)
    J = jdc.double(jdc.to_jacobian(jdc.pack_affine(pts)))
    J = JJPoint(*(t.reshape(16, rows, n) for t in J))
    out = jmsm._ec_prefix(jdc, J, n, jdc.inf_jacobian((rows, 1)))
    return jdc.unpack_jacobian(JJPoint(*(t.reshape(16, rows * n) for t in out)))


@pytest.mark.parametrize("S", TEAMS)
def test_k7_model_matches_jax_prefix_scan(S):
    """Three rows of 2,047 (cp = 16, so every team size splits the chunk)."""
    rows, n, seed = 3, 2047, 811
    dc, J, _ = general_input(k7_rows(seed, rows, n), rows, n)
    assert as_points(dc, k7_model(dc.F, *J, S), rows, n) == _jax_prefix(seed, rows, n)


@pytest.mark.parametrize("batch,n", MAIN_SHAPES, ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_k7_scratch_and_geometry_at_main_path_shapes(batch, n):
    """The window count and bucket count of each shape follow from its
    window size; the scratch holds every position of the 128 lane chunks
    and one offset a lane; on the 132 SMs of an H100 only the z commit's
    and the verifier's 24 rows take a team (S = 2), and no shape has a
    chunk of 64 positions (KT = 4)."""
    c = (n + 1).bit_length() - 1
    assert n == (1 << c) - 1 and batch[0] == msm.num_windows(c)
    rows = batch[0] * batch[1]
    cp, words = kernels.ec_scan_scratch(rows, n)
    assert cp == kernels.scan_chunk(n) and LANES * (cp - 1) < n <= LANES * cp
    assert words == 3 * NL * rows * LANES * cp + 3 * NL * rows * LANES
    if (batch, n) == ((24, 15), 2047):  # the largest: 70.8 MB of partial sums, 4.4 of offsets
        assert 4 * words == 70_778_880 + 4_423_680
    S, kt = kernels.parts_geometry(rows, cp, 132)
    assert (S, kt) == ((2, 4) if rows == 24 else (1, 4))
