"""The CUDA source of K10 and K4 run on the CPU: csrc/chain_field.cuh
compiled with the host C++ compiler against the stand-in cuda_runtime.h
(tests/cuda_host/, one warp as 32 threads), through
tests/cuda_host/chain_host.cpp, in Fp and Fq, limb for limb:

- fe_mul_lat, fe_sqr_lat and fe_dot3_lat against Python integers and
  against field.cuh's CIOS fe_mul, on numpy-seeded inputs and the edge
  values 0, 1, R mod p, p - 1 and p - 2;
- the sponge's device function (K10's one-warp body) against the JAX
  package's host sponge, on the transcript of
  tests/test_torch_ipa_kernels.py, with L or R at infinity as (0, 0);
- fe_pow_lat (K4's exponentiation) against pow(a, e, p) for
  e = p - 2, 0, 1, 2, 15, 16 and the permutation's alpha exponents.

nvcc has the last word: g++ accepts code that nvcc may refuse, and the card
runs the kernels (tests/test_torch_cuda.py)."""

import pathlib
import subprocess

import numpy as np
import pytest
import torch

from proof_systems_tpu.curves import Vesta as JVesta
from proof_systems_tpu.poseidon import FqSponge as JFqSponge
from proof_systems_tpu.poseidon import fq_kimchi as jfq_kimchi
from proof_systems_tpu_torch.curves import Vesta
from proof_systems_tpu_torch.fields import Fp, Fq
from proof_systems_tpu_torch.ops import kernels, limb
from proof_systems_tpu_torch.poseidon import fq_kimchi
from proof_systems_tpu_torch.prover_index import build_linearization
from torch_host_harness import run_pinned

torch.set_num_threads(1)

HERE = pathlib.Path(__file__).resolve().parent
CSRC = HERE.parent / "proof_systems_tpu_torch" / "csrc"
FIELDS = {"Fp": Fp, "Fq": Fq}
N = 48  # random products a field, beside the edge values


@pytest.fixture(scope="module")
def exe(tmp_path_factory):
    out = tmp_path_factory.mktemp("chain_host") / "chain_host"
    subprocess.run(["g++", "-std=c++20", "-O1", "-w", "-I", str(HERE / "cuda_host"),
                    "-I", str(CSRC), "-o", str(out), str(HERE / "cuda_host" / "chain_host.cpp"),
                    "-lpthread"], check=True, capture_output=True, timeout=300)
    return out


def _words(x: int) -> list[int]:
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


def _limbs(t: torch.Tensor) -> list[int]:
    """(8, k) int32 limbs -> 8k little-endian words, limb-major."""
    return (t.to(torch.int64) & 0xFFFFFFFF).reshape(-1).tolist()


def _run(exe, tmp_path, field, ops, sponge=None, xs=(), exps=()):
    """Run the harness; returns (its output words, its stdout)."""
    F = limb.device_field(field)
    words = list(F.kernel_params.tolist()) + [len(ops[0])]
    for arr in ops:
        words += [w for x in arr for w in _words(x)]
    if sponge is None:
        words.append(0)
    else:
        nrounds, consts, state, px, py = sponge
        words += [nrounds] + _limbs(consts) + _limbs(state) + _limbs(px) + _limbs(py)
    words += [len(xs)] + [w for x in xs for w in _words(x)]
    words.append(len(exps))
    for e in exps:
        digits = kernels.pow_digits(e)
        words += [len(digits)] + digits
    src, dst = tmp_path / "in.bin", tmp_path / "out.bin"
    np.array(words, dtype="<u4").tofile(src)
    res = run_pinned([exe, src, dst])
    assert res.returncode == 0, res.stdout + res.stderr
    return np.fromfile(dst, dtype="<u4").tolist(), res.stdout


def _ints(words: list[int]) -> list[int]:
    return [sum(w << (32 * i) for i, w in enumerate(words[j:j + 8]))
            for j in range(0, len(words), 8)]


def _operands(field, seed: int) -> list[list[int]]:
    """Six columns of canonical values: the edge values first (0, 1, R mod
    p, p - 1, p - 2, in every pairing with the column before), then random
    ones from a numpy seed."""
    p = field.p
    edge = [0, 1, (1 << 256) % p, p - 1, p - 2]
    rng = np.random.default_rng(seed)
    cols = []
    for c in range(6):
        col = [edge[(i + c) % len(edge)] for i in range(len(edge) * len(edge))]
        col += [int.from_bytes(rng.bytes(32), "little") % p for _ in range(N)]
        cols.append(col)
    return cols


@pytest.mark.parametrize("name", FIELDS)
def test_products_match_python_and_fe_mul(exe, tmp_path, name):
    field = FIELDS[name]
    p, rinv = field.p, pow(1 << 256, -1, field.p)
    ops = _operands(field, 901 if name == "Fp" else 902)
    out, log = _run(exe, tmp_path, field, ops)
    assert log.count("equal") == 3, log
    got = _ints(out)
    n = len(ops[0])
    a, b, c, d, e, f = ops
    assert got[0::3][:n] == [x * y * rinv % p for x, y in zip(a, b)]
    assert got[1::3][:n] == [x * x * rinv % p for x in a]
    assert got[2::3][:n] == [(x0 * y0 + x1 * y1 + x2 * y2) * rinv % p
                             for x0, y0, x1, y1, x2, y2 in zip(a, b, c, d, e, f)]


@pytest.mark.parametrize("case", ["points", "L_at_infinity", "R_at_infinity"])
def test_sponge_matches_host_sponge(exe, tmp_path, case):
    """absorb L, R from a sponge in the squeezed state, as every IPA round
    runs it (tests/test_torch_ipa_kernels.py), against the JAX package's
    host sponge."""
    rng = np.random.default_rng(903)
    sponge = JFqSponge(jfq_kimchi, JVesta)
    sponge.absorb_fq([5, 7, 11])
    sponge.squeeze_field()
    state0 = list(sponge.sponge.state)
    L, R = (Vesta.scalar_mul(int(rng.integers(1, 1 << 62)), Vesta.generator) for _ in range(2))
    if case == "L_at_infinity":
        L = None
    if case == "R_at_infinity":
        R = None
    sponge.absorb_g([L])
    sponge.absorb_g([R])
    sponge.challenge()  # the second permutation runs at the squeeze
    Fqd = limb.device_field(Fq)
    xs = [0 if P is None else P[0] for P in (L, R)]
    ys = [0 if P is None else P[1] for P in (L, R)]
    args = (fq_kimchi.rounds_full, kernels.sponge_consts(fq_kimchi, "cpu"),
            Fqd.pack_mont(state0, device="cpu"), Fqd.pack_mont(xs, device="cpu"),
            Fqd.pack_mont(ys, device="cpu"))
    out, log = _run(exe, tmp_path, Fq, [[]] * 6, sponge=args)
    assert "sponge" in log, log
    st = np.array(out[:24], dtype=np.uint32).reshape(8, 3)
    chal = out[24:32]
    host = [sum(int(st[l, j]) << (32 * l) for l in range(8)) for j in range(3)]
    assert [x * Fqd.r_inv % Fq.p for x in host] == list(sponge.sponge.state)
    assert _ints(chal) == [sponge.sponge.state[0]]


@pytest.mark.parametrize("name", FIELDS)
def test_pow_matches_python(exe, tmp_path, name):
    field = FIELDS[name]
    p = field.p
    r = (1 << 256) % p
    rinv = pow(r, -1, p)
    rng = np.random.default_rng(904 if name == "Fp" else 905)
    xs = [0, 1, r, p - 1, p - 2] + [int.from_bytes(rng.bytes(32), "little") % p
                                    for _ in range(11)]
    alphas, _ = build_linearization(Fp, None, None)
    exps = [p - 2, 0, 1, 2, 15, 16] + alphas.get_exponents("permutation", 3)
    out, log = _run(exe, tmp_path, field, [[]] * 6, xs=xs, exps=exps)
    got = _ints(out)
    want = [pow(x * rinv % p, e, p) * r % p for e in exps for x in xs]
    assert got == want, log


@pytest.mark.parametrize("wrapper", ["mont_pow", "sponge_squeeze2", "endo_inv",
                                     "mont_prefix_scan"])
def test_wrappers_reject_other_fields(wrapper):
    """The wrappers of the kernels on this product raise for a modulus of
    another shape (BN254's scalar field), on the CPU as on the card."""
    from proof_systems_tpu_torch.fields import FieldParams

    bn254_r = FieldParams("bn254_r", 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001,
                          5, 28)
    F = limb.device_field(bn254_r)
    two = F.pack_mont([1, 2], device="cpu")
    calls = {
        "mont_pow": lambda: kernels.mont_pow(F, two, 7),
        "sponge_squeeze2": lambda: kernels.sponge_squeeze2(
            F, fq_kimchi.rounds_full, F.pack_mont([1, 2, 3], device="cpu"), two, two,
            kernels.sponge_consts(fq_kimchi, "cpu")),
        "endo_inv": lambda: kernels.endo_inv(F, 2, torch.zeros(128, dtype=torch.int32)),
        "mont_prefix_scan": lambda: kernels.mont_prefix_scan(F, two[:, None, :].contiguous()),
    }
    with pytest.raises(ValueError, match="Pasta"):
        calls[wrapper]()
