"""Each CUDA kernel against its plain PyTorch version on the card, at small
shapes with the edge cases. Needs a CUDA device and nvcc; skips without
them. On the card: `python -m pytest -m cuda tests/test_torch_cuda.py`."""

import random

import pytest
import torch

import chip_smoke
from proof_systems_tpu_torch.curves import Pallas, Vesta
from proof_systems_tpu_torch.fields import Fp, Fq
from proof_systems_tpu_torch.ops import kernels, limb
from proof_systems_tpu_torch.ops.curve_ops import JPoint, device_curve

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pair(name, *args, **kw):
    got = kernels.WRAPPERS[name](*args, **kw)
    want = getattr(kernels, name + "_plain")(*args, **kw)
    return got, want


def _flat(x):
    if torch.is_tensor(x):
        return [x]
    return [t for item in x if not isinstance(item, int) for t in _flat(item)]


@pytest.mark.parametrize("field", [Fp, Fq], ids=["Fp", "Fq"])
def test_field_kernels_exact(dev, field):
    rng = random.Random(601)
    F = limb.device_field(field)
    xs = [0, 1, field.p - 1, (1 << 254) - 1] + [rng.randrange(field.p) for _ in range(296)]
    a = F.pack_mont(xs, device=dev)
    b = F.pack_mont(xs[::-1], device=dev)
    before = kernels.launch_counts()
    for name, args in [
        ("mont_mul", (F, a, b)),
        ("mont_pow", (F, a, field.p - 2)),
        ("mont_prefix_scan", (F, a.reshape(8, 2, 150).contiguous())),
    ]:
        got, want = _pair(name, *args)
        assert torch.equal(got, want), name
        assert kernels.launch_counts()[name] == before[name] + 1


def test_curve_kernels_match_plain(dev):
    """K2/K3 elementwise, K6 both ways and K7 on a row of 300 with
    identities inside: the plain versions mirror the kernels' association
    order, so the limbs agree exactly."""
    rng = random.Random(602)
    dc = device_curve(Vesta)
    g = Vesta.generator
    ps = [Vesta.scalar_mul(rng.randrange(1, Vesta.scalar.p), g) for _ in range(300)]
    qs = [Vesta.scalar_mul(rng.randrange(1, Vesta.scalar.p), g) for _ in range(300)]
    qs[0], qs[1], ps[2], qs[3] = ps[0], Vesta.neg(ps[1]), None, None
    P = dc.to_jacobian(dc.pack_affine(ps, device=dev))
    Q = dc.to_jacobian(dc.pack_affine(qs, device=dev))
    row = [t.reshape(8, 1, 300).contiguous() for t in P]
    for name, args, kw in [
        ("jacobian_add", (dc.F, *P, *Q), {}),
        ("jacobian_double", (dc.F, *P), {}),
        ("ec_prefix_scan_parts", (dc.F, *row), {"mixed": True}),
        ("ec_prefix_scan_parts", (dc.F, *row), {"mixed": False}),
        ("ec_prefix_scan_fused", (dc.F, *row), {}),
    ]:
        got, want = _pair(name, *args, **kw)
        for x, y in zip(_flat(got), _flat(want)):
            assert torch.equal(x, y), name
    sums = dc.unpack_jacobian(type(P)(*kernels.jacobian_add(dc.F, *P, *Q)))
    assert sums == [Vesta.add(p, q) for p, q in zip(ps, qs)]


def _pool_pairs(rng, dev, shape):
    """Two (8, *shape) general Jacobian operands (z != R) gathered on the
    card from 32 host points, their negations and the identity: random
    pairs, with P + P at every 7th position (the doubling fallback), P + (-P)
    at the next (the infinity fallback) and identities on either side."""
    dc = device_curve(Vesta)
    pool = [Vesta.scalar_mul(rng.randrange(1, Vesta.scalar.p), Vesta.generator)
            for _ in range(32)]
    table = [None] + pool + [Vesta.neg(p) for p in pool]  # k and k + 32 negate
    n = 1
    for d in shape:
        n *= d
    gen = torch.Generator().manual_seed(n)
    ip = torch.randint(0, len(table), (n,), generator=gen)
    iq = torch.randint(0, len(table), (n,), generator=gen)
    pos = torch.arange(n)
    iq = torch.where(pos % 7 == 0, ip, iq)
    iq = torch.where((pos % 7 == 1) & (ip > 0), (ip - 1 + 32) % 64 + 1, iq)
    J = dc.double(dc.to_jacobian(dc.pack_affine(table, device=dev)))
    return dc, [[t[:, i.to(dev)].reshape(8, *shape).contiguous() for t in J] for i in (ip, iq)]


# K2's call shapes on the main path: the witness commit's cum add and two of
# the fold steps' adds with g_lo, and the widest tail shape
K2_SHAPES = [(24, 15, 4096), (24, 7, 4096), (37, 2, 256), (16384,), (1024,)]


@pytest.mark.parametrize("shape", K2_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_jacobian_add_main_path_shapes(dev, shape):
    """K2 (the inlined complete add) as the wrapper launches it, one launch
    a call, limb for limb against the plain version, with the doubling,
    negation and identity lanes."""
    rng = random.Random(612)
    dc, (p, q) = _pool_pairs(rng, dev, shape)
    before = kernels.launch_counts()["jacobian_add"]
    got, want = _pair("jacobian_add", dc.F, *p, *q)
    assert kernels.launch_counts()["jacobian_add"] == before + 1
    for x, y in zip(got, want):
        assert torch.equal(x, y), shape


def _ladder_input(curve, rng, dev, n):
    """(8, n) affine-encoded points of `curve` (z in {0, R}), the second at
    infinity, gathered from 64 host points."""
    dc = device_curve(curve)
    pool = [None] + [curve.scalar_mul(rng.randrange(1, curve.scalar.p), curve.generator)
                     for _ in range(63)]
    idx = torch.randint(1, 64, (n,), generator=torch.Generator().manual_seed(n))
    idx[1 % n] = 0
    J = dc.to_jacobian(dc.pack_affine(pool, device=dev))
    return dc, [t[:, idx.to(dev)].contiguous() for t in J]


@pytest.mark.parametrize("pattern", ["random", "zeros", "ones"])
@pytest.mark.parametrize("curve", [Vesta, Pallas], ids=["Vesta", "Pallas"])
def test_endo_ladder_matches_plain_and_host(dev, curve, pattern):
    """The ladder kernel, one launch, limb for limb against its plain
    version (the loop of K2 and K3) on 40 points with one at infinity, and
    against the host's [u]P as points."""
    from proof_systems_tpu_torch.poseidon.sponge import ScalarChallenge

    rng = random.Random(613)
    bits = {"zeros": [0] * 128, "ones": [1] * 128,
            "random": [rng.randrange(2) for _ in range(128)]}[pattern]
    dc, P = _ladder_input(curve, rng, dev, 40)
    t = torch.tensor(bits, dtype=torch.int32, device=dev)
    before = kernels.launch_counts()["endo_ladder"]
    got, want = _pair("endo_ladder", dc.F, curve.endos[0], *P, t)
    assert kernels.launch_counts()["endo_ladder"] == before + 1
    for x, y in zip(got, want):
        assert torch.equal(x, y), pattern
    u = ScalarChallenge(sum(b << i for i, b in enumerate(bits))).to_field(curve.endos[1],
                                                                         curve.scalar)
    host = [None if q is None else curve.scalar_mul(u, q) for q in dc.unpack_jacobian(JPoint(*P))]
    assert dc.unpack_jacobian(JPoint(*got)) == host


@pytest.mark.parametrize("n", [32768, 16384, 8192, 4096, 2048])
def test_endo_ladder_fold_sizes(dev, n):
    """The ladder at the five fold steps' sizes of a k = 16 opening, limb for
    limb against its plain version."""
    rng = random.Random(614)
    dc, P = _ladder_input(Vesta, rng, dev, n)
    t = torch.tensor([rng.randrange(2) for _ in range(128)], dtype=torch.int32, device=dev)
    got, want = _pair("endo_ladder", dc.F, Vesta.endos[0], *P, t)
    for x, y in zip(got, want):
        assert torch.equal(x, y), n


def _k6_rows(rng, dev, rows, n, mixed):
    """(8, rows, n) points gathered on the card from a pool of 32: lane 3
    only P, P at 3 and 4 of its chunk, lane 5 only P, -P there, lane 6 only
    P, P at 1 and 2 (across sub-chunk boundaries), lane 7 all identities,
    identities at 3 and 4 of lane 9, random pool points elsewhere; doubled
    (z != R) for the general variant."""
    dc = device_curve(Vesta)
    pool = [Vesta.scalar_mul(rng.randrange(1, Vesta.scalar.p), Vesta.generator)
            for _ in range(32)]
    table = [None] + pool + [Vesta.neg(pool[0])]  # 0: identity, 33: -pool[0]
    cp = kernels.scan_chunk(n)
    idx = torch.randint(1, 33, (rows, n), generator=torch.Generator().manual_seed(rows * n))
    for L, pairs in [(3, [(3, 1), (4, 1)]), (5, [(3, 1), (4, 33)]), (6, [(1, 1), (2, 1)]),
                     (7, [])]:
        idx[:, L * cp:L * cp + cp] = 0
        for j, k in pairs:
            if j < cp and L * cp + j < n:
                idx[:, L * cp + j] = k
    for j in (3, 4):
        if j < cp:
            idx[:, 9 * cp + j:9 * cp + j + 1] = 0
    J = dc.to_jacobian(dc.pack_affine(table, device=dev))
    if not mixed:
        J = dc.double(J)
    flat = idx.reshape(-1).to(dev)
    return dc, [t[:, flat].reshape(8, rows, n).contiguous() for t in J]


def _same_points(dc, p, q):
    """Whether the Jacobian tuples p, q hold the same group elements: the
    infinity flags agree and X1 Z2^2 = X2 Z1^2, Y1 Z2^3 = Y2 Z1^3 where
    finite (on the card, through K1)."""
    F = dc.F
    pinf, qinf = limb.is_zero(F, p[2]), limb.is_zero(F, q[2])
    if not torch.equal(pinf, qinf):
        return False
    z1z1, z2z2 = limb.mont_sqr(F, p[2]), limb.mont_sqr(F, q[2])
    ex = limb.mont_mul(F, p[0], z2z2) != limb.mont_mul(F, q[0], z1z1)
    ey = (limb.mont_mul(F, p[1], limb.mont_mul(F, z2z2, q[2]))
          != limb.mont_mul(F, q[1], limb.mont_mul(F, z1z1, p[2])))
    return not bool(((ex | ey) & ~pinf[None]).any())


# every (team size, tile width) k_ec_parts is built for
K6_GEOMETRIES = [(1, 4), (1, 16), (2, 4), (4, 4), (8, 4), (16, 4)]


@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "general"])
@pytest.mark.parametrize("rows,n", [(2, 1), (2, 100), (1, 300), (2, 8321), (2, 65537),
                                    (24, 65537)])
def test_ec_parts_team_sizes_match_plain(dev, rows, n, mixed):
    """K6 as the wrapper launches it, and with every team size and tile
    width through its launcher, against the plain version as group elements
    (cp unchanged): n = 1, n < 128 (cp = 1), n = 300 (cp = 3 < S), n =
    8,321 and 65,537 (not multiples of S * 128), b = 1 with 24 rows, on
    rows with identities at sub-chunk boundaries and filling a lane, and P
    then P and P then -P across a boundary."""
    rng = random.Random(609)
    dc, pts = _k6_rows(rng, dev, rows, n, mixed)
    want_p, want_e, want_cp = kernels.ec_prefix_scan_parts_plain(dc.F, *pts, mixed=mixed)
    before = kernels.launch_counts()["ec_prefix_scan_parts"]
    got = kernels.ec_prefix_scan_parts(dc.F, *pts, mixed=mixed)
    assert kernels.launch_counts()["ec_prefix_scan_parts"] == before + 1
    runs = [got] + [kernels._ec_parts_launch(dc.F, *pts, mixed, team, kt)
                    for team, kt in K6_GEOMETRIES]
    for part, excl, cp in runs:
        assert cp == want_cp
        assert _same_points(dc, part, want_p) and _same_points(dc, excl, want_e)
    # one thread a chunk keeps the plain version's association order
    for kt in (4, 16):
        part, excl, _ = kernels._ec_parts_launch(dc.F, *pts, mixed, 1, kt)
        for x, y in zip(part + excl, want_p + want_e):
            assert torch.equal(x, y)


# K7's call shapes on the main path at k = 16: the witness, t and z commits
# (the verifier's MSM has the z commit's), the five fold steps, the tail
# rounds and the sg MSM
K7_SHAPES = [(24, 15, 2047), (24, 7, 2047), (24, 1, 2047), (26, 2, 1023), (29, 2, 511),
             (32, 2, 255), (37, 2, 127), (37, 1, 127)]


def _msm_identities(dc, pts, lead: int):
    """pts with the first `lead` positions of the first row made the
    identity (as an MSM's top window starts), and every identity written as
    the MSM writes it, (R, R, 0)."""
    x, y, z = (t.clone() for t in pts)
    z.view(8, -1, z.shape[-1])[:, 0, :lead] = 0
    inf = limb.is_zero(dc.F, z)
    one = dc.F.one_mont(inf.shape, device=z.device)
    return [torch.where(inf, one, x), torch.where(inf, one, y), z]


def _assert_scan_fused(dc, got, want, exact: bool):
    assert _same_points(dc, got, want)
    if exact:
        for x, y in zip(got, want):
            assert torch.equal(x, y)


@pytest.mark.parametrize("shape", K7_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ec_scan_fused_main_path_shapes(dev, shape):
    """K7 as the wrapper launches it (K6's kernels with general adds, then
    the combine), one launch counted a call, against its plain version on
    general Jacobian rows with doubling, negation and identity neighbours:
    as group elements, and limb for limb where one thread scans a lane
    chunk (every shape but the 24 rows of the z commit, where a team of two
    does); through the launcher with one thread a chunk, limb for limb. The
    first row starts with three lanes of identities, and every identity is
    (R, R, 0)."""
    rng = random.Random(615)
    dc, (p, _) = _pool_pairs(rng, dev, shape)
    p = _msm_identities(dc, p, 3 * kernels.scan_chunk(shape[-1]))
    rows, n = p[0][0].numel() // shape[-1], shape[-1]
    team, kt = kernels.parts_geometry(rows, kernels.scan_chunk(n), kernels._sm_count(dev))
    assert team == (2 if rows == 24 else 1)
    before = kernels.launch_counts()["ec_prefix_scan_fused"]
    got, want = _pair("ec_prefix_scan_fused", dc.F, *p)
    assert kernels.launch_counts()["ec_prefix_scan_fused"] == before + 1
    _assert_scan_fused(dc, got, want, team == 1)
    _assert_scan_fused(dc, kernels._ec_fused_launch(dc.F, *p, 1, 4), want, True)


@pytest.mark.parametrize("rows,n", chip_smoke.K6_EDGE_SHAPES)
def test_ec_scan_fused_edge_rows(dev, rows, n):
    """K7 on K6's edge rows, general input (n = 1, n < 128, one past a
    multiple of 128, 24 rows of 65,537), the identities (R, R, 0): the
    wrapper and every team size and tile width through the launcher, as
    group elements, limb for limb with one thread a chunk."""
    rng = random.Random(616)
    dc, pts = _k6_rows(rng, dev, rows, n, False)
    pts = _msm_identities(dc, pts, 0)
    got, want = _pair("ec_prefix_scan_fused", dc.F, *pts)
    team, _ = kernels.parts_geometry(rows, kernels.scan_chunk(n), kernels._sm_count(dev))
    _assert_scan_fused(dc, got, want, team == 1)
    for team, kt in K6_GEOMETRIES:
        _assert_scan_fused(dc, kernels._ec_fused_launch(dc.F, *pts, team, kt), want, team == 1)


def test_ec_scan_fused_combine_has_no_local_memory(dev):
    """K7's combine inlines the complete add: no stack frame, no spill."""
    regs, local, _, _ = kernels.ec_prefix_scan_fused_attrs()
    assert local == 0 and 0 < regs <= 255


def test_wrappers_reject_mixed_devices(dev):
    F = limb.device_field(Fp)
    a = F.pack([1, 2], device=dev)
    with pytest.raises(ValueError):
        kernels.mont_mul(F, a, a.cpu())


def _window_partials(rng, dev, W, b):
    """(8, W, b) general Jacobian window sums (z != 1), one at infinity."""
    dc = device_curve(Vesta)
    g = Vesta.generator
    pts = [Vesta.scalar_mul(rng.randrange(1, Vesta.scalar.p), g) for _ in range(W * b)]
    pts[1] = None
    J = dc.double(dc.to_jacobian(dc.pack_affine(pts, device=dev)))
    return dc, [t.reshape(8, W, b).contiguous() for t in J]


def test_combine_windows_matches_plain(dev):
    """K8 at the verifier's shape (W = 24, c = 11, b = 1) and a fold
    step's (b = 2), and at W = 3, c = 2, b = 130 (more than one block)."""
    rng = random.Random(603)
    for W, b, c in [(24, 1, 11), (26, 2, 10), (3, 130, 2)]:
        dc, win = _window_partials(rng, dev, W, b)
        got, want = _pair("combine_windows", dc.F, c, *win)
        for x, y in zip(got, want):
            assert torch.equal(x, y), (W, b, c)


# (W, b, c) of every K8 call on the main path: the fold steps, the 11 tail
# rounds, the sg MSM and the verifier's MSM
K8_MAIN_SHAPES = [(26, 2, 10), (29, 2, 9), (32, 2, 8), (37, 2, 7), (37, 1, 7), (24, 1, 11)]


@pytest.mark.parametrize("W,b,c", K8_MAIN_SHAPES)
def test_combine_windows_main_path_shapes(dev, W, b, c):
    """K8 as the wrapper launches it (one launch a call) at every main-path
    call shape, limb for limb against the plain version."""
    rng = random.Random(610 + W + b)
    dc, win = _window_partials(rng, dev, W, b)
    before = kernels.launch_counts()["combine_windows"]
    got, want = _pair("combine_windows", dc.F, c, *win)
    assert kernels.launch_counts()["combine_windows"] == before + 1
    for x, y in zip(got, want):
        assert torch.equal(x, y), (W, b, c)


@pytest.mark.parametrize("W,b,c", chip_smoke.K8_EDGE_SHAPES)
def test_combine_windows_edge_rows(dev, W, b, c):
    """K8 through the wrapper on chip_smoke.py's edge rows: an all-identity
    column, a window equal to 2^c times the accumulator (the doubling
    fallback, at the first add and mid-chain), one equal to its negation
    (the infinity fallback), W = 1, c = 1, b = 33 and b = 130; limb for limb
    against the plain version, and as points against host Horner."""
    rng = random.Random(611 + W * b * c)
    dc = device_curve(Vesta)
    wins = chip_smoke.k8_windows(Vesta, dc, rng, W, b, c, dev)
    want = kernels.combine_windows_plain(dc.F, c, *wins)
    got = kernels.combine_windows(dc.F, c, *wins)
    for x, y in zip(got, want):
        assert torch.equal(x, y), (W, b, c)
    host_wins = dc.unpack_jacobian(JPoint(*(t.reshape(8, W * b) for t in wins)))
    host = []
    for col in range(b):
        acc = None
        for w in range(W - 1, -1, -1):
            for _ in range(c):
                acc = Vesta.double(acc)
            acc = Vesta.add(acc, host_wins[w * b + col])
        host.append(acc)
    assert dc.unpack_jacobian(JPoint(*got)) == host


def test_sponge_squeeze2_matches_plain_and_host(dev):
    """K10 on the kimchi Fq sponge, with L at infinity as (0, 0)."""
    from proof_systems_tpu_torch.poseidon import fq_kimchi, poseidon_block_cipher

    rng = random.Random(604)
    Fqd = limb.device_field(Fq)
    state = [rng.randrange(Fq.p) for _ in range(3)]
    R = Vesta.scalar_mul(rng.randrange(1, Vesta.scalar.p), Vesta.generator)
    xs, ys = [0, R[0]], [0, R[1]]
    args = (Fqd, fq_kimchi.rounds_full, Fqd.pack_mont(state, device=dev),
            Fqd.pack_mont(xs, device=dev), Fqd.pack_mont(ys, device=dev),
            kernels.sponge_consts(fq_kimchi, dev))
    (st, chal), (st_p, chal_p) = _pair("sponge_squeeze2", *args)
    assert torch.equal(st, st_p) and torch.equal(chal, chal_p)
    host = list(state)
    for k in range(2):
        host[0] = (host[0] + xs[k]) % Fq.p
        host[1] = (host[1] + ys[k]) % Fq.p
        poseidon_block_cipher(fq_kimchi, host)
    assert Fqd.unpack_mont(st) == host
    assert Fqd.unpack(chal) == [host[0]]


@pytest.mark.parametrize("pattern", ["zeros", "ones", "random"])
def test_endo_inv_matches_plain(dev, pattern):
    rng = random.Random(605)
    bits = {"zeros": [0] * 128, "ones": [1] * 128,
            "random": [rng.randrange(2) for _ in range(128)]}[pattern]
    F = limb.device_field(Fp)
    endo_r = Vesta.endos[1]
    t = torch.tensor(bits, dtype=torch.int32, device=dev)
    (u, u_inv), (u_p, u_inv_p) = _pair("endo_inv", F, endo_r, t)
    assert torch.equal(u, u_p) and torch.equal(u_inv, u_inv_p)
    [uv], [uiv] = F.unpack_mont(u), F.unpack_mont(u_inv)
    assert uv * uiv % Fp.p == 1


def _field_row(rng, F, rows, n, dev, zero_at=None):
    xs = [rng.randrange(F.p) for _ in range(rows * n)]
    if zero_at is not None:
        xs[zero_at] = 0
    return F.pack_mont(xs, shape=(rows, n), device=dev)


# (rows, n, c) of K9: n = 1, not a multiple of 128, the prover's 2^16 and
# one past it; 1, 2 and 24 rows; c = 0, 1 (a prefix sum), p - 1, random and
# the boundary's omega^(n - 3)
K9_CASES = ([(2, n, c) for n, c in [(1, 5), (300, 0), (300, 1), (300, "random"),
                                    (1 << 16, "omega")]]
            + [(rows, n, "omega") for rows in (1, 2, 24) for n in (127, 129, 8321, 65537)]
            + [(1, 65537, c) for c in (0, 1, "p-1", "random")])
# every team size the K12 and K9 kernels take
FIELD_SCAN_TEAMS = [1, 2, 4, 8, 16, 32]


def _k9_c(rng, c, n):
    return {"random": rng.randrange(Fp.p), "p-1": Fp.p - 1,
            "omega": pow(Fp.root_of_unity(16), n - 3, Fp.p)}.get(c, c)


@pytest.mark.parametrize("rows,n,c", K9_CASES, ids=str)
def test_linear_scan_matches_plain(dev, rows, n, c):
    """K9 as the wrapper launches it (the team of field_scan_team), one
    launch a call, limb for limb against the plain version."""
    rng = random.Random(606)
    F = limb.device_field(Fp)
    c = _k9_c(rng, c, n)
    x = _field_row(rng, F, rows, n, dev)
    before = kernels.launch_counts()["linear_scan"]
    got, want = _pair("linear_scan", F, x, c)
    assert torch.equal(got, want)
    assert kernels.launch_counts()["linear_scan"] == before + 1


@pytest.mark.parametrize("rows,n", [(2, 1), (2, 129), (2, 8321), (1, 1 << 16), (24, 65537)],
                         ids=str)
def test_linear_scan_teams_match_plain(dev, rows, n):
    """K9 with every team size through its launcher (which counts nothing),
    limb for limb against the plain version."""
    rng = random.Random(617)
    F = limb.device_field(Fp)
    c = _k9_c(rng, "omega", n)
    x = _field_row(rng, F, rows, n, dev)
    want = kernels.linear_scan_plain(F, x, c)
    before = kernels.launch_counts()
    for team in FIELD_SCAN_TEAMS:
        assert torch.equal(kernels._linear_scan_launch(F, x, c, team), want), team
    assert kernels.launch_counts() == before


# (rows, n) of K12: the smallest K12 row (C = Cp = 65), padded lanes (n =
# 8,321: Cp = 70 > C = 66; 65,537: Cp = 528 > C = 513), the prover's 2^16;
# 1, 2, 3 and 24 rows
K12_CASES = [(2, 8321), (2, 1 << 16), (1, 8193), (3, 8321), (1, 65537), (24, 65537),
             (1, 1 << 16)]


@pytest.mark.parametrize("rows,n", K12_CASES, ids=str)
def test_mont_prefix_scan_parts_matches_plain(dev, rows, n):
    """K12 as the wrapper launches it, one launch a call, limb for limb
    against the plain version (partial, excl and cp), on rows with a zero
    element."""
    rng = random.Random(607)
    F = limb.device_field(Fp)
    x = _field_row(rng, F, rows, n, dev, zero_at=(rows - 1) * n + 17)
    before = kernels.launch_counts()["mont_prefix_scan_parts"]
    (part, excl, cp), (part_p, excl_p, cp_p) = _pair("mont_prefix_scan_parts", F, x)
    assert kernels.launch_counts()["mont_prefix_scan_parts"] == before + 1
    assert cp == cp_p == kernels.scan_geometry(n)[2]
    assert torch.equal(part, part_p) and torch.equal(excl, excl_p)


@pytest.mark.parametrize("rows,n", [(1, 8193), (3, 8321), (1, 1 << 16), (24, 65537)], ids=str)
def test_mont_prefix_scan_parts_teams_match_plain(dev, rows, n):
    """K12 with every team size through its launcher (which counts
    nothing), limb for limb against the plain version, with zeros at
    lane 9's first position and at the middle of lane 5 (a member's first
    position where sc divides cp / 2: at 2^16, every team)."""
    rng = random.Random(618)
    F = limb.device_field(Fp)
    cp = kernels.scan_geometry(n)[2]
    xs = [rng.randrange(Fp.p) for _ in range(rows * n)]
    base = (rows - 1) * n
    xs[base + 5 * cp + cp // 2] = 0
    xs[base + 9 * cp] = 0
    x = F.pack_mont(xs, shape=(rows, n), device=dev)
    want_p, want_e, _ = kernels.mont_prefix_scan_parts_plain(F, x)
    before = kernels.launch_counts()
    for team in FIELD_SCAN_TEAMS:
        part, excl, got_cp = kernels._prefix_parts_launch(F, x, team)
        assert got_cp == cp
        assert torch.equal(part, want_p) and torch.equal(excl, want_e), team
    assert kernels.launch_counts() == before


def test_field_scan_kernels_have_no_local_memory(dev):
    """K12's, K9's and K5's kernels keep nothing on a stack."""
    for name, (regs, local, _, _) in kernels.field_scan_attrs().items():
        assert local == 0 and 0 < regs <= 255, name


@pytest.mark.parametrize("n", [64 * 128, 64 * 128 + 1])
def test_prefix_mul_dispatch_on_the_card(dev, n):
    """prefix_mul at C = 64 (K5) and C = 65 (K12 + K1) against the host."""
    rng = random.Random(608)
    F = limb.device_field(Fp)
    x = _field_row(rng, F, 1, n, dev)
    before = kernels.launch_counts()
    got = F.unpack_mont(limb.prefix_mul(F, x))
    acc, want = 1, []
    for v in F.unpack_mont(x):
        acc = acc * v % Fp.p
        want.append(acc)
    assert got == want
    after = kernels.launch_counts()
    long_row = n > 64 * 128
    assert after["mont_prefix_scan_parts"] - before["mont_prefix_scan_parts"] == int(long_row)
    assert after["mont_prefix_scan"] - before["mont_prefix_scan"] == int(not long_row)


def _sponge_host(state, xs, ys):
    from proof_systems_tpu_torch.poseidon import fq_kimchi, poseidon_block_cipher

    host = list(state)
    for k in range(2):
        host[0] = (host[0] + xs[k]) % Fq.p
        host[1] = (host[1] + ys[k]) % Fq.p
        poseidon_block_cipher(fq_kimchi, host)
    return host


@pytest.mark.parametrize("case", ["random", "edge_state", "L_at_infinity", "R_at_infinity",
                                  "both_at_infinity"])
def test_sponge_squeeze2_lanes_match_plain_and_host(dev, case):
    """K10 (chain_field.cuh's product, one warp) on random and edge states:
    0, 1 and p - 1 in the state, points at infinity as (0, 0)."""
    from proof_systems_tpu_torch.poseidon import fq_kimchi

    rng = random.Random(609)
    Fqd = limb.device_field(Fq)
    state = [0, 1, Fq.p - 1] if case == "edge_state" else [rng.randrange(Fq.p) for _ in range(3)]
    L, R = (Vesta.scalar_mul(rng.randrange(1, Vesta.scalar.p), Vesta.generator)
            for _ in range(2))
    if case in ("L_at_infinity", "both_at_infinity"):
        L = None
    if case in ("R_at_infinity", "both_at_infinity"):
        R = None
    xs = [0 if P is None else P[0] for P in (L, R)]
    ys = [0 if P is None else P[1] for P in (L, R)]
    args = (Fqd, fq_kimchi.rounds_full, Fqd.pack_mont(state, device=dev),
            Fqd.pack_mont(xs, device=dev), Fqd.pack_mont(ys, device=dev),
            kernels.sponge_consts(fq_kimchi, dev))
    before = kernels.launch_counts()["sponge_squeeze2"]
    (st, chal), (st_p, chal_p) = _pair("sponge_squeeze2", *args)
    assert kernels.launch_counts()["sponge_squeeze2"] == before + 1
    assert torch.equal(st, st_p) and torch.equal(chal, chal_p)
    host = _sponge_host(state, xs, ys)
    assert Fqd.unpack_mont(st) == host
    assert Fqd.unpack(chal) == [host[0]]


@pytest.mark.parametrize("e", ["p-2", "small"])
@pytest.mark.parametrize("n", [1, 2, 3, 32, 33, (24, 65537)], ids=str)
@pytest.mark.parametrize("field", [Fp, Fq], ids=["Fp", "Fq"])
def test_mont_pow_shapes_match_plain(dev, field, n, e):
    """K4 at the proof's one-element and small shapes and at 24 x 65,537,
    with 0, 1 and p - 1 among the inputs, for e = p - 2 and an alpha
    exponent of the permutation (21)."""
    F = limb.device_field(field)
    shape = n if isinstance(n, tuple) else (n,)
    count = shape[0] * shape[-1] if len(shape) == 2 else shape[0]
    if count > 1000:
        gen = torch.Generator(device=dev).manual_seed(610)
        a = limb.to_mont(F, torch.randint(0, 1 << 30, (8, *shape), dtype=torch.int32, device=dev,
                                          generator=gen)).contiguous()
    else:
        rng = random.Random(610 + count)
        xs = ([0, 1, field.p - 1] + [rng.randrange(field.p) for _ in range(count)])[:count]
        a = F.pack_mont(xs, shape=shape, device=dev)
    exp = field.p - 2 if e == "p-2" else 21
    before = kernels.launch_counts()["mont_pow"]
    got, want = _pair("mont_pow", F, a, exp)
    assert kernels.launch_counts()["mont_pow"] == before + 1
    assert torch.equal(got, want)
    if count <= 1000:
        assert F.unpack_mont(got) == [pow(x, exp, field.p) for x in F.unpack_mont(a)]


@pytest.mark.parametrize("curve", [Vesta, Pallas], ids=["Vesta", "Pallas"])
def test_endo_inv_both_scalar_fields(dev, curve):
    """K11 over both scalar fields."""
    rng = random.Random(611)
    F = limb.device_field(curve.scalar)
    t = torch.tensor([rng.randrange(2) for _ in range(128)], dtype=torch.int32, device=dev)
    (u, u_inv), (u_p, u_inv_p) = _pair("endo_inv", F, curve.endos[1], t)
    assert torch.equal(u, u_p) and torch.equal(u_inv, u_inv_p)
    [uv], [uiv] = F.unpack_mont(u), F.unpack_mont(u_inv)
    assert uv * uiv % curve.scalar.p == 1


def test_chain_kernels_have_no_stack(dev):
    attrs = kernels.chain_attrs()
    for name in ("k_sponge_squeeze2", "k_mont_pow", "k_endo_inv"):
        assert attrs[name][1] == 0, attrs


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
@pytest.mark.parametrize("curve", [Vesta, Pallas], ids=["Vesta", "Pallas"])
def test_endo_inv_seeded_bits(dev, curve, seed):
    """K11 (closed form, binary-GCD inverse) against its plain version on
    numpy-seeded challenge bits, one launch a call."""
    import numpy as np

    bits = np.random.default_rng(1200 + seed).integers(0, 2, 128).tolist()
    F = limb.device_field(curve.scalar)
    t = torch.tensor(bits, dtype=torch.int32, device=dev)
    before = kernels.launch_counts()["endo_inv"]
    (u, u_inv), (u_p, u_inv_p) = _pair("endo_inv", F, curve.endos[1], t)
    assert kernels.launch_counts()["endo_inv"] == before + 1
    assert torch.equal(u, u_p) and torch.equal(u_inv, u_inv_p)


@pytest.mark.parametrize("field", [Fp, Fq], ids=["Fp", "Fq"])
def test_inverse_chain_edge_values(dev, field):
    """K11's inverse on the card (product_chain's INVERSE_CHAIN: inv(x) R^3
    in Montgomery form) on 0, 1, 2, p - 1, p - 2, R, R^2 and 2^255 mod p as
    integers, and on seeded values; twice gives x back."""
    p = field.p
    r = (1 << 256) % p
    F = limb.device_field(field)
    rng = random.Random(1210)
    xs = [0, 1, 2, p - 1, p - 2, r, r * r % p, (1 << 255) % p] + [rng.randrange(p)
                                                                   for _ in range(8)]
    for x in xs:
        ops = F.pack([x, r * r % p * r % p, 0, 0], device=dev)  # x, R^3 as integers
        [once] = F.unpack(kernels.product_chain(F, kernels.INVERSE_CHAIN, ops, 1))
        assert once == (pow(x, -1, p) * r * r % p if x else 0), x
        [twice] = F.unpack(kernels.product_chain(F, kernels.INVERSE_CHAIN, ops, 2))
        assert twice == x, x


# K5 (limb.prefix_mul's rows of at most 64 chunks): the opening's calls (L
# and R: 1 and 2; g2's to_affine: 2,048, 4,096 and 8,192), and the edge
# rows around a warp, a block of 128 and the longest row
K5_ROWS = [1, 2, 2048, 4096, 8192, 3, 31, 32, 33, 127, 128, 129, 2047, 8191]


@pytest.mark.parametrize("n", K5_ROWS)
def test_mont_prefix_scan_shapes(dev, n):
    """One row and two (a zero in the second), both fields, one launch a
    call, limb for limb."""
    rng = random.Random(1220 + n)
    for field in (Fp, Fq):
        F = limb.device_field(field)
        for rows, zero in ((1, None), (2, n + n // 2)):
            x = _field_row(rng, F, rows, n, dev, zero_at=zero)
            before = kernels.launch_counts()["mont_prefix_scan"]
            got, want = _pair("mont_prefix_scan", F, x)
            assert kernels.launch_counts()["mont_prefix_scan"] == before + 1
            assert torch.equal(got, want), (field.name, rows)


@pytest.mark.parametrize("n", [1, 2, 33, 2047, 4096, 8192])
def test_mont_prefix_scan_block_sizes(dev, n):
    """Every block size through the launcher (which counts nothing) against
    the plain version."""
    rng = random.Random(1230 + n)
    F = limb.device_field(Fq)
    x = _field_row(rng, F, 2, n, dev)
    want = kernels.mont_prefix_scan_plain(F, x)
    before = kernels.launch_counts()
    for threads in (32, 64, 128, 256, 512):
        assert torch.equal(kernels._mont_prefix_launch(F, x, threads), want), threads
    assert kernels.launch_counts() == before


def test_chain_wrappers_reject_other_fields(dev):
    """K4, K10, K11 and K5 run the Pasta moduli's product: another modulus
    raises before anything is launched."""
    from proof_systems_tpu_torch.fields import FieldParams
    from proof_systems_tpu_torch.poseidon import fq_kimchi

    bn254_r = FieldParams("bn254_r", 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001,
                          5, 28)
    F = limb.device_field(bn254_r)
    two = F.pack_mont([1, 2], device=dev)
    three = F.pack_mont([1, 2, 3], device=dev)
    consts = kernels.sponge_consts(fq_kimchi, dev)
    bits = torch.zeros(128, dtype=torch.int32, device=dev)
    names = ("mont_pow", "sponge_squeeze2", "endo_inv", "mont_prefix_scan")
    before = {k: kernels.launch_counts()[k] for k in names}
    with pytest.raises(ValueError, match="Pasta"):
        kernels.mont_prefix_scan(F, two[:, None, :].contiguous())
    with pytest.raises(ValueError, match="Pasta"):
        kernels.mont_pow(F, two, 7)
    with pytest.raises(ValueError, match="Pasta"):
        kernels.sponge_squeeze2(F, fq_kimchi.rounds_full, three, two, two, consts)
    with pytest.raises(ValueError, match="Pasta"):
        kernels.endo_inv(F, 2, bits)
    assert {k: kernels.launch_counts()[k] for k in names} == before


def test_lagrange_commitments_match_host_msm(dev, tmp_path):
    """n = 2^12, m = 5: the b = 5 unscaled MSM over g (K6, K2, K7, K8) and
    the to_affine of 5 points (K4's elementwise inverse), against the
    native host MSM of the Lagrange coefficients; the cached call runs no
    kernel."""
    from proof_systems_tpu_torch.circuits.domains import EvaluationDomains
    from proof_systems_tpu_torch.native import native_curve
    from proof_systems_tpu_torch.poly_commitment.srs import SRS

    n, m = 1 << 12, 5
    srs = SRS.create(Vesta, n, device=dev, cache_dir=tmp_path)
    domain = EvaluationDomains.create(Fp, n, device=dev).d1
    before = kernels.launch_counts()
    got = srs.lagrange_commitments(domain, m)
    used = {k: v - before[k] for k, v in kernels.launch_counts().items()}
    assert all(used[k] > 0 for k in ("ec_prefix_scan_parts", "jacobian_add",
                                     "ec_prefix_scan_fused", "combine_windows", "mont_pow"))
    p, n_inv = Fp.p, pow(n, -1, Fp.p)
    w_inv = pow(domain.group_gen, -1, p)
    nat = native_curve(Vesta)
    for i, pt in enumerate(got):
        w = pow(w_inv, i, p)
        coeffs, c = [], n_inv
        for _ in range(n):
            coeffs.append(c)
            c = c * w % p
        assert pt == nat.msm(coeffs, srs.g), i
    before = kernels.launch_counts()
    assert srs.lagrange_commitments(domain, 3) == got[:3]
    assert kernels.launch_counts() == before


def test_curve_layer_ops_match_host(dev):
    """add_mixed (equal, negated and infinite lanes), sum_points over 7 and
    scalar_mul_const on the card, against the host curve."""
    from proof_systems_tpu_torch.ops.curve_ops import scalar_mul_const

    rng = random.Random(611)
    dc = device_curve(Vesta)
    g = Vesta.generator
    ps = [Vesta.scalar_mul(rng.randrange(1, Vesta.scalar.p), g) for _ in range(7)]
    qs = [Vesta.scalar_mul(rng.randrange(1, Vesta.scalar.p), g) for _ in range(7)]
    qs[0], qs[1], ps[2], qs[3] = ps[0], Vesta.neg(ps[1]), None, None
    P = dc.to_jacobian(dc.pack_affine(ps, device=dev))
    got = dc.add_mixed(dc.double(P), dc.pack_affine(qs, device=dev))
    assert dc.unpack_jacobian(got) == [Vesta.add(Vesta.double(p), q) for p, q in zip(ps, qs)]

    total = dc.sum_points(JPoint(*(t[:, None, :] for t in P)))
    want = None
    for p in ps:
        want = Vesta.add(want, p)
    assert dc.unpack_jacobian(JPoint(*(t.reshape(8, 1) for t in total))) == [want]

    k = rng.randrange(Vesta.scalar.p)
    scal = torch.from_numpy(limb.ints_to_limbs([k])).reshape(limb.NLIMBS).to(dev)
    assert dc.unpack_jacobian(scalar_mul_const(dc, scal, P)) == [Vesta.scalar_mul(k, p) for p in ps]


def test_bench_proof_k11_has_no_fold_step(dev, tmp_path):
    """bench_torch's k = 11 proof: n = 2,048 = IPA_FOLD_TAIL, so the opening
    runs only tail rounds and the endo ladder never launches; it verifies."""
    import bench_torch
    from proof_systems_tpu_torch.utils.rng import TestRng
    from proof_systems_tpu_torch.verifier import verify

    index, witness = bench_torch.setup(11, dev, cache_dir=tmp_path)
    kernels.reset_launch_counts()
    proof, _ = bench_torch.prove_once(index, witness, TestRng(11))
    counts = kernels.launch_counts()
    assert counts["endo_ladder"] == 0
    assert len(proof.proof.lr) == 11
    assert verify(index.verifier_index(), proof, [], TestRng(12))


# Call shapes that the lookup, chunked and batch paths add (chip_smoke.py's
# recorded calls at k = 16): K12 over 2^17 (the chunked z) and over the d8
# domain of 2^19 (the lookup constraints' batch inverses); K9 over 2^17 with
# c = 1 and c = omega^(n - 5) (the chunked boundary divisions, zk_rows 5);
# K4 over 2^19 with e = 2^16 (x^n over d8); K1 on 28 x 2^19 (the chunked
# index's d8 columns); K6 mixed on the 24 x 1 x 65,995 of a five-proof batch;
# K7 and K2 on the 2-, 3- and 4-row commits of the chunked z and the sorted
# and lookup columns.
NEW_PATH_FIELD_SHAPES = [("mont_prefix_scan_parts", 1 << 17, None),
                         ("mont_prefix_scan_parts", 1 << 19, None),
                         ("linear_scan", 1 << 17, 1), ("linear_scan", 1 << 17, "omega17"),
                         ("mont_pow", 1 << 19, 1 << 16), ("mont_mul", 28 << 19, None)]


@pytest.mark.parametrize("name,n,arg", NEW_PATH_FIELD_SHAPES, ids=str)
def test_new_path_field_shapes_match_plain(dev, name, n, arg):
    """K12, K9, K4 and K1 at the lookup and chunked paths' shapes as the
    wrappers launch them, one launch a call, limb for limb against the
    plain versions, on rows with a zero element."""
    F = limb.device_field(Fp)
    gen = torch.Generator(device=dev).manual_seed(620)

    def row():  # canonical values below 2^254 < p, as the mont_pow test draws them
        std = torch.randint(0, 1 << 30, (8, 1, n), dtype=torch.int32, device=dev, generator=gen)
        return limb.to_mont(F, std).contiguous()

    x = row()
    x[:, 0, 17] = 0
    if arg == "omega17":
        arg = pow(Fp.root_of_unity(17), n - 5, Fp.p)
    args = {"mont_prefix_scan_parts": (x,), "linear_scan": (x, arg), "mont_pow": (x, arg),
            "mont_mul": (x, row())}[name]
    before = kernels.launch_counts()[name]
    got, want = _pair(name, F, *args)
    assert kernels.launch_counts()[name] == before + 1
    for a, b in zip(_flat(got), _flat(want)):
        assert torch.equal(a, b), name


def test_new_path_batch_msm_scan_matches_plain(dev):
    """K6 (mixed) at the five-proof batch's 24 x 1 x 65,995 as the wrapper
    launches it, against the plain version as group elements."""
    rng = random.Random(621)
    dc, pts = _k6_rows(rng, dev, 24, 65995, True)
    want_p, want_e, want_cp = kernels.ec_prefix_scan_parts_plain(dc.F, *pts, mixed=True)
    part, excl, cp = kernels.ec_prefix_scan_parts(dc.F, *pts, mixed=True)
    assert cp == want_cp
    assert _same_points(dc, part, want_p) and _same_points(dc, excl, want_e)


@pytest.mark.parametrize("shape", [(24, 2, 2047), (24, 3, 2047), (24, 4, 2047)],
                         ids=lambda s: "x".join(map(str, s)))
def test_new_path_ec_scan_fused_shapes(dev, shape):
    """K7 at the 2-, 3- and 4-row commits of the new paths, as group
    elements against the plain version, the first row starting with three
    lanes of identities (R, R, 0)."""
    rng = random.Random(622)
    dc, (p, _) = _pool_pairs(rng, dev, shape)
    p = _msm_identities(dc, p, 3 * kernels.scan_chunk(shape[-1]))
    got, want = _pair("ec_prefix_scan_fused", dc.F, *p)
    assert _same_points(dc, got, want)


@pytest.mark.parametrize("shape", [(24, 2, 4096), (24, 3, 4096), (24, 4, 4096), (24, 3, 2048),
                                   (16, 3), (16, 4), (24, 4, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_new_path_jacobian_add_shapes(dev, shape):
    """K2 at the new paths' commit shapes, limb for limb against the plain
    version, with the doubling, negation and identity lanes."""
    rng = random.Random(623)
    dc, (p, q) = _pool_pairs(rng, dev, shape)
    got, want = _pair("jacobian_add", dc.F, *p, *q)
    for x, y in zip(got, want):
        assert torch.equal(x, y), shape


# Call shapes that the optional-gate paths add (chip_smoke.py's recorded calls
# of the gate mix at k = 16): K1 on the 34 index columns (28 + the six
# optional selectors); K6 mixed, K7 and K2 on the 17-column halves of the
# b = 34 verifier-index commit.
@pytest.mark.parametrize("name,n,arg", [("mont_mul", 34 << 18, None)], ids=str)
def test_optional_path_field_shapes_match_plain(dev, name, n, arg):
    test_new_path_field_shapes_match_plain(dev, name, n, arg)


def test_optional_path_vk_msm_scan_matches_plain(dev):
    """K6 (mixed) at 24 x 17 x 65,537 (as 408 rows) as the wrapper launches
    it, against the plain version as group elements."""
    rng = random.Random(624)
    dc, pts = _k6_rows(rng, dev, 24 * 17, 65537, True)
    want_p, want_e, want_cp = kernels.ec_prefix_scan_parts_plain(dc.F, *pts, mixed=True)
    part, excl, cp = kernels.ec_prefix_scan_parts(dc.F, *pts, mixed=True)
    assert cp == want_cp
    assert _same_points(dc, part, want_p) and _same_points(dc, excl, want_e)


@pytest.mark.parametrize("shape", [(24, 17, 2047)], ids=lambda s: "x".join(map(str, s)))
def test_optional_path_ec_scan_fused_shapes(dev, shape):
    test_new_path_ec_scan_fused_shapes(dev, shape)


@pytest.mark.parametrize("shape", [(24, 17, 4096), (24, 17, 2048), (24, 17, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_optional_path_jacobian_add_shapes(dev, shape):
    test_new_path_jacobian_add_shapes(dev, shape)


# Call shapes that the column path adds (chip_smoke.py's recorded calls of
# the three k = 16 column proofs): K1 on 11 x 2^18 (the d8 columns of the
# MultiLogUp); K6 on the 9-column commit (mixed at 24 x 9 x 65,537 as 216
# rows, general at 24 x 9 x 2,047); K7 and K2 at that commit's shapes; K4 on
# the 9 chunk evaluations' inverses.
@pytest.mark.parametrize("name,n,arg", [("mont_mul", 11 << 18, None)], ids=str)
def test_column_path_field_shapes_match_plain(dev, name, n, arg):
    test_new_path_field_shapes_match_plain(dev, name, n, arg)


@pytest.mark.parametrize("mixed,rows,n", [(True, 24 * 9, 65537), (False, 24 * 9, 2047)], ids=str)
def test_column_path_msm_scan_matches_plain(dev, mixed, rows, n):
    """K6 at the 9-column commit's shapes as the wrapper launches it,
    against the plain version as group elements."""
    rng = random.Random(625)
    dc, pts = _k6_rows(rng, dev, rows, n, mixed)
    want_p, want_e, want_cp = kernels.ec_prefix_scan_parts_plain(dc.F, *pts, mixed=mixed)
    part, excl, cp = kernels.ec_prefix_scan_parts(dc.F, *pts, mixed=mixed)
    assert cp == want_cp
    assert _same_points(dc, part, want_p) and _same_points(dc, excl, want_e)


@pytest.mark.parametrize("shape", [(24, 9, 2047)], ids=lambda s: "x".join(map(str, s)))
def test_column_path_ec_scan_fused_shapes(dev, shape):
    test_new_path_ec_scan_fused_shapes(dev, shape)


@pytest.mark.parametrize("shape", [(24, 9, 4096), (24, 9, 2048), (24, 9, 1), (16, 9), (8, 9),
                                   (4, 9), (2, 9), (1, 9)],
                         ids=lambda s: "x".join(map(str, s)))
def test_column_path_jacobian_add_shapes(dev, shape):
    test_new_path_jacobian_add_shapes(dev, shape)


@pytest.mark.parametrize("field", [Fp, Fq], ids=["Fp", "Fq"])
def test_column_path_mont_pow_shape(dev, field):
    test_mont_pow_shapes_match_plain(dev, field, 9, "p-2")


def _column_trace(n: int, device):
    """tests/test_torch_pickles.py's cyclic trace at n rows with a boundary
    row at 0: (columns, constraints, domain)."""
    from proof_systems_tpu_torch.circuits import expr as E
    from proof_systems_tpu_torch.circuits.domains import EvaluationDomains
    from proof_systems_tpu_torch.o1vm.pickles import col

    rng = random.Random(611)
    domain = EvaluationDomains.create(Fp, n, device=device)
    omega, p = domain.d1.group_gen, Fp.p
    c0 = [pow(omega, i, p) for i in range(n)]
    c1 = [rng.randrange(p) for _ in range(n)]
    c2 = [a * b % p for a, b in zip(c0, c1)]
    cols = limb.device_field(Fp).pack_mont(c0 + c1 + c2, shape=(3, n), device=device)
    cell = lambda i, row=E.CURR: E.Cell(col(i), row)  # noqa: E731
    cons = [cell(2) - cell(0) * cell(1), cell(0, E.NEXT) - E.Literal(omega) * cell(0),
            E.UnnormalizedLagrangeBasis(0) * (cell(0) - E.Literal(1))]
    return cols, cons, domain


def test_column_boundary_rows_match_cpu(dev):
    """The boundary row's d8 values at n = 2^11 (a row of 16,384: K12, then
    K4's inverse and K1) on the card equal the CPU's, n * w^0 at point 0."""
    from proof_systems_tpu_torch.o1vm import pickles

    F = limb.device_field(Fp)
    n = 1 << 11
    out = {}
    for d in (dev, torch.device("cpu")):
        _, cons, domain = _column_trace(n, d)
        before = kernels.launch_counts()
        out[d.type] = pickles._unnormalized_lagrange_evals(
            F, cons, n, domain.d1.group_gen, domain.d8, Fp.p, device=d)[0]
        if d.type == "cuda":
            assert kernels.launch_counts()["mont_prefix_scan_parts"] > before[
                "mont_prefix_scan_parts"]
    assert torch.equal(out["cuda"].cpu(), out["cpu"])
    assert F.unpack_mont(out["cpu"][:, :1]) == [n]


def test_column_proof_matches_cpu(dev):
    """A column proof at n = 2^11 on the card, field for field the CPU's,
    verified on the card; every kernel launches but K3 (the basis is built
    before), K9 (no division by x - c) and the endo ladder (n = 2^11 is
    IPA_FOLD_TAIL: the opening has no fold step)."""
    from proof_systems_tpu_torch.convert import column_proof_fields
    from proof_systems_tpu_torch.o1vm.pickles import prove_columns, verify_columns
    from proof_systems_tpu_torch.ops import msm
    from proof_systems_tpu_torch.poly_commitment.srs import SRS, derive_g, derive_h
    from proof_systems_tpu_torch.utils.rng import TestRng

    n = 1 << 11
    g, h = [derive_g(Vesta, i) for i in range(n)], derive_h(Vesta)
    proofs = {}
    for d in (dev, torch.device("cpu")):
        cols, cons, domain = _column_trace(n, d)
        srs = SRS(Vesta, g, h, d)
        srs.scaled_basis(msm.default_window_bits(n + 1))  # K3, outside the counted proof
        before = kernels.launch_counts()
        proofs[d.type] = prove_columns(domain, srs, Vesta, cols, cons, TestRng(612), device=d)
        if d.type == "cuda":
            used = {k: v - before[k] for k, v in kernels.launch_counts().items()}
            assert verify_columns(domain, srs, Vesta, cons, proofs["cuda"], TestRng(613))
            assert [k for k, v in used.items() if v == 0] == ["jacobian_double", "linear_scan",
                                                              "endo_ladder"]
    assert column_proof_fields(proofs["cuda"]) == column_proof_fields(proofs["cpu"])


# The o1vm Keccak-f, RV32IM and MIPS paths (chip_smoke.py's keccak, riscv and
# mips phases): the port's proofs of the JAX package's vectors on the card, and
# the call shapes these paths add: K6 mixed on a pass of the Keccak commit
# (37 x 2,113 x 33) and of the RV32IM commit at n = 2^14 (29 x 69 x 16,385),
# its plain version on slices of rows as chip_smoke.plain_call holds it; K1
# on the d8 transform's stage of the RV32IM proof at n = 2^15 (300 x 2^17).
def _vector_setup(n: int, dev):
    from proof_systems_tpu_torch.circuits.domains import EvaluationDomains
    from proof_systems_tpu_torch.poly_commitment.srs import SRS, derive_g, derive_h

    return (EvaluationDomains.create(Fp, n, device=dev),
            SRS(Vesta, [derive_g(Vesta, i) for i in range(n)], derive_h(Vesta), dev))


def test_keccak_vector_proof_on_the_card(dev):
    """tests/test_keccak.py's statement proved on the card equals
    tests/vectors/column_keccak_2^5 byte for byte; it verifies, and a
    changed final or initial state is rejected."""
    from proof_systems_tpu_torch.convert import column_proof_fields
    from proof_systems_tpu_torch.o1vm import keccak
    from proof_systems_tpu_torch.serialization import serialize_column_proof
    from proof_systems_tpu_torch.utils.rng import TestRng

    raw, st = chip_smoke.column_vector("keccak")
    domain, srs = _vector_setup(st["n"], dev)
    proof, final = keccak.prove_keccak(domain, srs, Vesta, st["state0"], TestRng(61))
    assert final == st["final"]
    assert serialize_column_proof(Vesta, column_proof_fields(proof)) == raw
    assert keccak.verify_keccak(domain, srs, Vesta, proof, st["state0"], final, TestRng(62))
    bad = [row[:] for row in final]
    bad[1][2] ^= 1 << 7
    assert not keccak.verify_keccak(domain, srs, Vesta, proof, st["state0"], bad, TestRng(63))
    bad0 = [row[:] for row in st["state0"]]
    bad0[0][0] ^= 1
    assert not keccak.verify_keccak(domain, srs, Vesta, proof, bad0, final, TestRng(64))


def test_riscv_vector_proof_on_the_card(dev):
    """tests/test_riscv.py's program proved on the card (Layout(2), n = 256)
    equals tests/vectors/column_riscv_2^8 byte for byte with the same
    statement; it verifies, and regs[3] = 14 is rejected."""
    from proof_systems_tpu_torch.convert import column_proof_fields
    from proof_systems_tpu_torch.o1vm import riscv
    from proof_systems_tpu_torch.serialization import serialize_column_proof
    from proof_systems_tpu_torch.utils.rng import TestRng

    raw, st = chip_smoke.column_vector("riscv")
    want = riscv.statement_from_json(st["statement"])
    domain, srs = _vector_setup(st["n"], dev)
    proof, statement = riscv.prove_execution(domain, srs, Vesta, want["program"], st["n"],
                                             TestRng(81), L=riscv.Layout(want["bitwise_bits"]))
    assert riscv.statement_to_json(statement) == st["statement"]
    assert serialize_column_proof(Vesta, column_proof_fields(proof)) == raw
    assert riscv.verify_execution(domain, srs, Vesta, proof, statement, TestRng(82))
    bad = dict(statement, final=dict(statement["final"], regs=list(statement["final"]["regs"])))
    bad["final"]["regs"][3] = 14
    assert not riscv.verify_execution(domain, srs, Vesta, proof, bad, TestRng(83))


def _mips_vector(name: str, seed: int, dev, **kw):
    """A MIPS vector's statement proved on the card: the proof, its statement,
    the domain and SRS; the bytes and statement equal the vector's, and it
    verifies."""
    from proof_systems_tpu_torch.convert import column_proof_fields
    from proof_systems_tpu_torch.o1vm import mips
    from proof_systems_tpu_torch.serialization import serialize_column_proof
    from proof_systems_tpu_torch.utils.rng import TestRng

    raw, st = chip_smoke.column_vector(name)
    want = mips.statement_from_json(st["statement"])
    domain, srs = _vector_setup(st["n"], dev)
    proof, statement = mips.prove_execution(
        domain, srs, Vesta, want["program"], st["n"], TestRng(seed),
        L=mips.Layout(want["bitwise_bits"]), pc0=want["init"]["pc"],
        preimages=want["preimages"], **kw)
    assert mips.statement_to_json(statement) == st["statement"]
    assert serialize_column_proof(Vesta, column_proof_fields(proof)) == raw
    assert mips.verify_execution(domain, srs, Vesta, proof, statement, TestRng(seed + 1))
    return proof, statement, domain, srs


def test_mips_vector_proof_on_the_card(dev):
    """tests/test_mips.py's program proved on the card (Layout(2), n = 256)
    equals tests/vectors/column_mips_2^8 byte for byte with the same
    statement; it verifies, and regs[5] = 43 and init_memory[32] = 9 are
    rejected."""
    from proof_systems_tpu_torch.o1vm import mips
    from proof_systems_tpu_torch.utils.rng import TestRng

    proof, statement, domain, srs = _mips_vector("mips", 71, dev)
    bad = dict(statement, final=dict(statement["final"], regs=list(statement["final"]["regs"])))
    bad["final"]["regs"][5] = 43
    assert not mips.verify_execution(domain, srs, Vesta, proof, bad, TestRng(73))
    bad = dict(statement, init_memory={**statement["init_memory"], 32: 9})
    assert not mips.verify_execution(domain, srs, Vesta, proof, bad, TestRng(74))


def test_mips_cannon_vector_proof_on_the_card(dev):
    """The Cannon snapshot segment (pc0 = 0x1000, a preimage read, exit 3)
    proved on the card (Layout(2), n = 512) equals
    tests/vectors/column_mips_cannon_2^9 byte for byte; it verifies, and a
    preimage with its last byte changed is rejected."""
    from proof_systems_tpu_torch.o1vm import mips
    from proof_systems_tpu_torch.utils.rng import TestRng

    data = {0x100 + 4 * w: int.from_bytes(bytes(range(64 + 4 * w, 68 + 4 * w)), "big")
            for w in range(8)}
    proof, statement, domain, srs = _mips_vector("mips_cannon", 81, dev, memory=data)
    assert statement["final"]["exit_code"] == 3 and statement["final"]["regs"][9] == 0x11223344
    key = bytes(range(64, 96))
    bad = dict(statement, preimages={key: b"\x11\x22\x33\x45"})
    assert not mips.verify_execution(domain, srs, Vesta, proof, bad, TestRng(83))


@pytest.mark.parametrize("name,n,arg", [("mont_mul", 300 << 17, None)], ids=str)
def test_o1vm_path_field_shapes_match_plain(dev, name, n, arg):
    test_new_path_field_shapes_match_plain(dev, name, n, arg)


@pytest.mark.parametrize("rows,n", [(37 * 2113, 33), (29 * 69, 16385)], ids=str)
def test_o1vm_path_msm_scan_matches_plain(dev, rows, n):
    """K6 (mixed) at a pass of the Keccak commit and of the RV32IM commit as
    the wrapper launches it, against the plain version (on slices of rows)
    as group elements."""
    rng = random.Random(626)
    dc, pts = _k6_rows(rng, dev, rows, n, True)
    want_p, want_e, want_cp = chip_smoke.plain_call(
        kernels.ec_prefix_scan_parts_plain, "ec_prefix_scan_parts", [dc.F, *pts],
        {"mixed": True})
    part, excl, cp = kernels.ec_prefix_scan_parts(dc.F, *pts, mixed=True)
    assert cp == want_cp
    assert _same_points(dc, part, want_p) and _same_points(dc, excl, want_e)


# The foreign-field MSM circuit and arrabbiata folding (chip_smoke.py's msm
# and folding phases): the port's proofs of the JAX package's vectors on the
# card, the decider's over Vesta / Fp and over Pallas / Fq.
def test_msm_vector_proof_on_the_card(dev):
    """tests/test_msm_circuit.py's statement proved on the card equals
    tests/vectors/column_msm_2^8 byte for byte; it verifies, and a changed
    result and changed scalars are rejected."""
    from proof_systems_tpu_torch import msm_circuit
    from proof_systems_tpu_torch.convert import column_proof_fields
    from proof_systems_tpu_torch.serialization import serialize_column_proof
    from proof_systems_tpu_torch.utils.rng import TestRng

    raw, st = chip_smoke.column_vector("msm")
    curve, layout = msm_circuit.ForeignCurve(*st["curve"]), msm_circuit.Layout(*st["layout"])
    pts = [tuple(pt) for pt in st["points"]]
    domain, srs = _vector_setup(st["n"], dev)
    proof, result = msm_circuit.prove_msm(domain, srs, Vesta, curve, st["scalars"], pts,
                                          TestRng(41), L=layout)
    assert list(result) == st["result"]
    assert serialize_column_proof(Vesta, column_proof_fields(proof)) == raw

    def verify(scalars, res, seed):
        return msm_circuit.verify_msm(domain, srs, Vesta, curve, scalars, pts, res, proof,
                                      TestRng(seed), L=layout)

    assert verify(st["scalars"], result, 42)
    assert not verify(st["scalars"], ((result[0] + 1) % curve.f, result[1]), 43)
    assert not verify([11, 7], result, 44)


def test_ivc_decider_vector_proofs_on_the_card(dev):
    """tests/test_ivc.py's heavy statement (n = 256, TestRng(9), two steps,
    decide with TestRng(10)) on the card: both decider proofs equal
    tests/vectors/column_ivc_vesta_2^8 and column_ivc_pallas_2^8 byte for
    byte."""
    from proof_systems_tpu_torch.circuits.domains import EvaluationDomains
    from proof_systems_tpu_torch.convert import column_proof_fields
    from proof_systems_tpu_torch.folding import ivc
    from proof_systems_tpu_torch.poly_commitment.srs import SRS, derive_g, derive_h
    from proof_systems_tpu_torch.serialization import serialize_column_proof
    from proof_systems_tpu_torch.utils.rng import TestRng

    n = 256
    iv = ivc.IVC(*(SRS(c, [derive_g(c, i) for i in range(n)], derive_h(c), dev)
                   for c in (Vesta, Pallas)), n=n, rng=TestRng(9))
    iv.run(2, steps=2)
    proofs = []
    assert iv.decide({f: EvaluationDomains.create(f, n, device=dev) for f in (Fp, Fq)},
                     TestRng(10), proofs)
    for (proof, _), curve, name in zip(proofs, (Vesta, Pallas), ("ivc_vesta", "ivc_pallas")):
        raw, _ = chip_smoke.column_vector(name)
        assert serialize_column_proof(curve, column_proof_fields(proof)) == raw


def test_nccl_world_of_one(dev):
    """tests/torch_mesh_ranks.py's statements on a world of one over NCCL
    (one spawned rank on cuda:0): the distributed NTT inverts, every MSM
    equals the host MSM through the batch-sharded route, and the fixed 2^5
    proof under the mesh, with its row-sharded quotient, is byte for byte
    tests/vectors/proof_2^5.bin and verifies."""
    import pathlib

    import torch_mesh_ranks as R
    from proof_systems_tpu_torch.parallel.spawn import Ranks

    # the earlier tests' plain versions leave tens of GiB cached in this
    # process's allocator; hand them back before the rank allocates
    torch.cuda.empty_cache()
    (out,) = Ranks(R.mesh_checks, 1).results(timeout=600)
    assert (out["rank"], out["size"]) == (0, 1)
    rng = random.Random(8)
    assert out["ntt_back"] == [rng.randrange(Fp.p) for _ in range(1 << R.NTT_LOG_N)]
    for name, n, b, c, scaled, pts, rows in R.msm_cases():
        assert out["msm"][name] == [Vesta.msm(row, pts) for row in rows], name
    assert out["msm_routes"] == {"_batch_sharded_msm": 3}
    fixture = pathlib.Path(__file__).parent / "vectors" / "proof_2^5.bin"
    assert out["proof"] == fixture.read_bytes() and out["verifies"]
    assert out["quotient_gathers"] == 1
