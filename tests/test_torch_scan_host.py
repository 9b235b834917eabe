"""K12's, K9's and K5's CUDA source run on the CPU: csrc/scan_field.cuh
compiled with the host C++ compiler against the stand-in cuda_runtime.h
(tests/cuda_host/: a warp as 32 threads, a block as 128, K5's block as T),
through tests/cuda_host/scan_host.cpp, which runs the kernels' phases in
order over every warp, lane and team member. Held limb for limb against
Python integers in Fp and Fq:

- K12's partial products and exclusive lane products on the smallest K12
  row (n = 8,193: C = Cp = 65), on rows with padded lanes (n = 8,321: Cp =
  70 > C = 66; n = 65,537: Cp = 528 > C = 513), with a zero at a team
  member's first position, one row and three, for teams of 1, 2, 16 and 32
  threads;
- K9's recurrence s_j = x_j + c s_(j-1) at n = 1, 127, 129, 8,321 and
  65,537 for c = 0, 1, p - 1, a random c and omega^(n - 3), teams of 1, 2,
  16 and 32;
- the team scan and the lane scan alone, on random totals;
- K5's block scan on 2 rows of n = 1, 2, 3, 31, 32, 33, 127, 128, 129,
  2,047, 2,048, 8,191 and 8,192 at the threads kernels.prefix_geometry
  picks, and at every block size from 32 to 512 threads on rows that
  leave a block's last threads or warps past n, with a zero in the row;
- kernels.field_scan_team's rule, and the K9 kernel's constant table
  against pow.

nvcc has the last word: g++ accepts code that nvcc may refuse, and the card
runs the kernels (tests/test_torch_cuda.py)."""

import pathlib
import subprocess

import numpy as np
import pytest

from proof_systems_tpu_torch.fields import Fp, Fq
from proof_systems_tpu_torch.ops import kernels, limb
from torch_host_harness import run_pinned

HERE = pathlib.Path(__file__).resolve().parent
CSRC = HERE.parent / "proof_systems_tpu_torch" / "csrc"
FIELDS = {"Fp": Fp, "Fq": Fq}
LANES = kernels.LANES
UNWRITTEN = 0xFFFFFFFF  # the harness's fill: no canonical limb of p's top word


@pytest.fixture(scope="module")
def exe(tmp_path_factory):
    out = tmp_path_factory.mktemp("scan_host") / "scan_host"
    subprocess.run(["g++", "-std=c++20", "-O1", "-w", "-I", str(HERE / "cuda_host"),
                    "-I", str(CSRC), "-o", str(out), str(HERE / "cuda_host" / "scan_host.cpp"),
                    "-lpthread"], check=True, capture_output=True, timeout=300)
    return out


def _pack(vals) -> np.ndarray:
    """Ints -> (8, len) little-endian uint32 limbs, limb-major."""
    arr = np.array([[(v >> (32 * l)) & 0xFFFFFFFF for l in range(8)] for v in vals],
                   dtype=np.uint64).reshape(-1, 8)
    return arr.T.astype("<u4")


def _unpack(words: np.ndarray, count: int) -> list[int]:
    """(8, count) limb-major words -> ints; None where a limb is unwritten."""
    w = words.reshape(8, count).astype(object)
    out = []
    for i in range(count):
        col = w[:, i]
        out.append(None if UNWRITTEN in col[7:] else sum(int(col[l]) << (32 * l) for l in range(8)))
    return out


def _run(exe, tmp_path, field, words) -> np.ndarray:
    F = limb.device_field(field)
    src, dst = tmp_path / "in.bin", tmp_path / "out.bin"
    head = np.array(list(F.kernel_params.tolist()), dtype="<u4")
    np.concatenate([head, np.asarray(words, dtype="<u4")]).tofile(src)
    res = run_pinned([exe, src, dst])
    assert res.returncode == 0, res.stdout + res.stderr
    return np.fromfile(dst, dtype="<u4")


def _mont(field, vals) -> list[int]:
    r = (1 << 256) % field.p
    return [v * r % field.p for v in vals]


def _random(field, seed: int, count: int) -> list[int]:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % field.p for _ in range(count)]


def _table(field, c: int, n: int, team: int) -> np.ndarray:
    F = limb.device_field(field)
    t = kernels.linear_kernel_table(F, c, n, team, "cpu").numpy().view(np.uint32)
    return np.ascontiguousarray(t)


# ---------------------------------------------------------------------------
# K12
# ---------------------------------------------------------------------------


def _k12_python(field, xs, rows: int, n: int, cp: int):
    """(partial, excl) of the plain contract, standard ints."""
    p = field.p
    parts, excls = [], []
    for r in range(rows):
        row = xs[r * n:(r + 1) * n]
        tots = []
        for lane in range(LANES):
            acc = 1
            for j in range(lane * cp, lane * cp + cp):
                acc = acc * (row[j] if j < n else 1) % p
                parts.append(acc)
            tots.append(acc)
        acc = 1
        for lane in range(LANES):
            excls.append(acc)
            acc = acc * tots[lane] % p
    return parts, excls


# (n, rows): the smallest K12 row, padded lanes (Cp > C) on three rows and
# on one
K12_ROWS = [(8193, 1), (8321, 3), (65537, 1)]
# one thread a lane, and teams
TEAMS = [1, 2, 16, 32]
# Fp at every row and team; Fq on one row, with the shortest and the widest
# team
K12_CASES = [(name, n, rows, team) for name in FIELDS for n, rows in K12_ROWS
             for team in TEAMS if name == "Fp" or (rows == 1 and team in (1, 32))]


@pytest.mark.parametrize("name,n,rows,team", K12_CASES, ids=lambda v: str(v))
def test_k12_device_code_matches_python(exe, tmp_path, name, n, rows, team):
    field = FIELDS[name]
    cp = kernels.scan_geometry(n)[2]
    sc = -(-cp // team)
    xs = _random(field, 10 * n + rows + team, rows * n)
    # zeros at a team member's first position (a sub-chunk boundary) and
    # at a lane's first
    last = rows - 1
    xs[last * n + 5 * cp + min(team - 1, (cp - 1) // sc) * sc] = 0
    xs[last * n + 9 * cp] = 0
    words = [1, rows, n, cp, team.bit_length() - 1] + list(_pack(_mont(field, xs)).ravel())
    out = _run(exe, tmp_path, field, words)
    np_ = rows * LANES * cp
    got_p = _unpack(out[:8 * np_], np_)
    got_e = _unpack(out[8 * np_:], rows * LANES)
    want_p, want_e = _k12_python(field, xs, rows, n, cp)
    assert got_p == _mont(field, want_p)
    assert got_e == _mont(field, want_e)


# ---------------------------------------------------------------------------
# K9
# ---------------------------------------------------------------------------


def _k9_python(field, xs, rows: int, n: int, c: int) -> list[int]:
    p, out = field.p, []
    for r in range(rows):
        s = 0
        for x in xs[r * n:(r + 1) * n]:
            s = (x + c * s) % p
            out.append(s)
    return out


K9_C = ["0", "1", "p-1", "random", "omega^(n-3)"]


def _k9_c(field, name: str, n: int) -> int:
    return {"0": 0, "1": 1, "p-1": field.p - 1, "random": _random(field, n, 1)[0],
            "omega^(n-3)": pow(field.root_of_unity(16), n - 3, field.p)}[name]


def _k9_check(exe, tmp_path, field, n: int, rows: int, c: int, team: int, seed: int):
    cp = kernels.scan_chunk(n)
    tab = _table(field, c, n, team)
    xs = _random(field, seed, rows * n)
    words = ([2, rows, n, cp, team.bit_length() - 1, tab.shape[1]] + list(tab.ravel())
             + list(_pack(_mont(field, xs)).ravel()))
    got = _unpack(_run(exe, tmp_path, field, words), rows * n)
    assert got == _mont(field, _k9_python(field, xs, rows, n, c)), team


@pytest.mark.parametrize("c", K9_C)
@pytest.mark.parametrize("n,rows", [(1, 2), (127, 2), (129, 3), (8321, 1), (65537, 1)],
                         ids=lambda v: str(v))
def test_k9_device_code_matches_python(exe, tmp_path, n, rows, c):
    """Fp, every team of TEAMS (at n = 65,537 with c = 0, 1 or p - 1, the
    shortest and the widest)."""
    for team in TEAMS:
        if n < 65537 or c not in ("0", "1", "p-1") or team in (1, 32):
            _k9_check(exe, tmp_path, Fp, n, rows, _k9_c(Fp, c, n), team, n + team)


@pytest.mark.parametrize("c", ["p-1", "omega^(n-3)"])
@pytest.mark.parametrize("n,rows", [(129, 3), (8321, 1)], ids=lambda v: str(v))
def test_k9_device_code_matches_python_fq(exe, tmp_path, n, rows, c):
    for team in TEAMS:
        _k9_check(exe, tmp_path, Fq, n, rows, _k9_c(Fq, c, n), team, 7 * n + team)


# ---------------------------------------------------------------------------
# The team scan and the lane scan alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["product", "linear"])
@pytest.mark.parametrize("team", [1, 2, 4, 8, 16, 32])
def test_team_scan_matches_python(exe, tmp_path, team, op):
    """Each thread's exclusive combination of its team's earlier totals
    (the product, or K9's map of runs of sc positions)."""
    field = Fp
    p = field.p
    tots = _random(field, 40 + team, 32)
    c, n = _random(field, 41, 1)[0], 128 * 40  # cp = 40
    cp = kernels.scan_chunk(n)
    sc = -(-cp // team)
    tab = _table(field, c, n, team) if op == "linear" else np.zeros((8, 0), np.uint32)
    words = ([3, int(op == "linear"), team.bit_length() - 1, cp, tab.shape[1]] + list(tab.ravel())
             + list(_pack(_mont(field, tots)).ravel()))
    got = _unpack(_run(exe, tmp_path, field, words), 32)
    want = []
    for t in range(32):
        acc = 1 if op == "product" else 0
        for m in range(t - t % team, t):
            acc = acc * tots[m] % p if op == "product" else (tots[m] + pow(c, sc, p) * acc) % p
        want.append(acc)
    assert got == _mont(field, want)


@pytest.mark.parametrize("op", ["product", "linear"])
def test_lane_scan_matches_python(exe, tmp_path, op):
    """The exclusive scan of two rows' 128 lane values: products, or lane
    values of K9 with S_l = V_l + c^cp S_(l-1)."""
    field, rows, n = Fq, 2, 128 * 33 - 5
    p = field.p
    vals = _random(field, 50, rows * LANES)
    c = _random(field, 51, 1)[0]
    cp = kernels.scan_chunk(n)
    tab = _table(field, c, n, 1) if op == "linear" else np.zeros((8, 0), np.uint32)
    words = ([4, int(op == "linear"), cp, tab.shape[1]] + list(tab.ravel()) + [rows]
             + list(_pack(_mont(field, vals)).ravel()))
    got = _unpack(_run(exe, tmp_path, field, words), rows * LANES)
    want = []
    for r in range(rows):
        acc = 1 if op == "product" else 0
        for lane in range(LANES):
            want.append(acc)
            v = vals[r * LANES + lane]
            acc = acc * v % p if op == "product" else (v + pow(c, cp, p) * acc) % p
    assert got == _mont(field, want)


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------


def _k5_check(exe, tmp_path, field, rows: int, n: int, threads=None, zero_at=None):
    t, sc, lanes_log2 = kernels.prefix_geometry(n, threads)
    xs = _random(field, 60 * n + t, rows * n)
    if zero_at is not None:
        xs[zero_at] = 0
    words = ([5, rows, n, sc, t.bit_length() - 6, lanes_log2]
             + list(_pack(_mont(field, xs)).ravel()))
    got = _unpack(_run(exe, tmp_path, field, words), rows * n)
    want = []
    for r in range(rows):
        acc = 1
        for x in xs[r * n:(r + 1) * n]:
            acc = acc * x % field.p
            want.append(acc)
    assert got == _mont(field, want), (n, t)


# the opening's rows (1, 2, 2,048 ... 8,192), around a warp, a block of 128
# and K5's longest row
K5_ROWS = [1, 2, 3, 31, 32, 33, 127, 128, 129, 2047, 2048, 8191, 8192]


@pytest.mark.parametrize("n", K5_ROWS)
def test_k5_device_code_matches_python(exe, tmp_path, n):
    """Two rows at the rule's block (Fp; Fq at the longest rows)."""
    for name in ("Fp", "Fq") if n >= 8191 else ("Fp",):
        _k5_check(exe, tmp_path, FIELDS[name], 2, n, zero_at=n + n // 2)


@pytest.mark.parametrize("threads", [32, 64, 128, 256, 512])
def test_k5_every_block_size(exe, tmp_path, threads):
    """Every block size on rows that a block covers with room to spare: n =
    33 (sc = 1 or 2: most threads past n), 700 and 2,047."""
    for n in (33, 700, 2047):
        _k5_check(exe, tmp_path, Fq, 2, n, threads, zero_at=n - 1)


@pytest.mark.parametrize("n,want", [
    (1, (32, 1, 0)), (2, (32, 1, 1)), (3, (32, 1, 2)), (33, (32, 2, 5)),
    (256, (32, 8, 5)), (257, (64, 5, 5)), (2048, (256, 8, 5)), (4096, (512, 8, 5)),
    (4097, (512, 9, 5)), (8192, (512, 16, 5)),
])
def test_prefix_geometry(n, want):
    assert kernels.prefix_geometry(n) == want


# ---------------------------------------------------------------------------
# The geometry and the table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,cp,sms,want", [
    (1, 512, 132, 32),      # the main path's row of 65,536: sc = 16
    (1, 528, 132, 32),      # 65,537 (Cp = 528): sc = 17
    (1, 65, 132, 32),       # the smallest K12 row: sc = 3
    (1, 7, 132, 2),         # a member keeps 2 positions at least
    (1, 1, 132, 1),         # K9 at n <= 128
    (2, 3, 132, 1),
    (24, 512, 132, 32),     # 98,304 threads: two waves fit 135,168
    (300, 512, 132, 2),
    (600, 512, 132, 1),     # the rows fill the card
    (1, 512, 2, 16),        # a card of two SMs: 2,048 threads
])
def test_field_scan_team(rows, cp, sms, want):
    assert kernels.field_scan_team(rows, cp, sms) == want


@pytest.mark.parametrize("rows", [1, 2, 24, 300])
@pytest.mark.parametrize("cp", [1, 2, 7, 65, 70, 512, 528])
def test_field_scan_team_invariants(rows, cp):
    team = kernels.field_scan_team(rows, cp, 132)
    assert team & (team - 1) == 0 and 1 <= team <= kernels.FIELD_SCAN_TEAM_MAX
    assert team == 1 or -(-cp // team) >= kernels.FIELD_SCAN_MIN_SUB
    assert team == 1 or team * rows * LANES <= 132 * kernels.FIELD_SCAN_SM_THREADS


@pytest.mark.parametrize("n,team", [(1, 1), (300, 2), (8321, 16), (65536, 32)])
@pytest.mark.parametrize("name", FIELDS)
def test_linear_kernel_table_against_pow(name, n, team):
    field = FIELDS[name]
    p = field.p
    F = limb.device_field(field)
    c = _random(field, n + team, 1)[0]
    cp = kernels.scan_chunk(n)
    sc = -(-cp // team)
    tab = kernels.linear_kernel_table(F, c, n, team, "cpu")
    assert tab.shape == (8, cp + 12) and tab.dtype == kernels.torch.int32
    want = ([pow(c, i + 1, p) for i in range(cp)] + [pow(c, cp << k, p) for k in range(7)]
            + [pow(c, sc << k, p) for k in range(5)])
    assert F.unpack_mont(tab) == want
    # the plain version's table is the kernel's first cp + 7 columns
    assert kernels.linear_table(F, c, n, "cpu").equal(tab[:, :cp + 7])
