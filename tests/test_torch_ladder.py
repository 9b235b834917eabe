"""The IPA fold step's endo ladder (kernels.endo_ladder) on the CPU.

Its plain version against a loop of the JAX package's DeviceCurve.add and
DeviceCurve.double (the reference's fori_loop, ipa.py:554-574, run through
their XLA formulas as the JAX package's own tests run them on the CPU),
limb for limb, and against the host's [u]P as group elements, with u
ScalarChallenge.to_field of the bits; on Vesta and Pallas, with random,
all-zero and all-one bits, and a point at infinity among the inputs.

The ladder's and K2's CUDA source compiled with g++ against the stand-in
tests/cuda_host/cuda_runtime.h (tests/cuda_host/ladder_host.cpp): the
ladder against the loop of field.cuh's out-of-line ec_double and ec_add,
and against the plain version, limb for limb; the inlined add and doubling
against the out-of-line ones. nvcc has the last word: g++ accepts code that
nvcc may refuse, and the card runs the kernels (tests/test_torch_cuda.py).
All inputs come from numpy seeds."""

import pathlib
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proof_systems_tpu.curves import Pallas as JPallas
from proof_systems_tpu.curves import Vesta as JVesta
from proof_systems_tpu.ops import limb as jlimb
from proof_systems_tpu.ops.curve_ops import JPoint as JJPoint
from proof_systems_tpu.ops.curve_ops import device_curve as jdevice_curve
from proof_systems_tpu_torch import convert
from proof_systems_tpu_torch.curves import Pallas, Vesta
from proof_systems_tpu_torch.ops import kernels
from proof_systems_tpu_torch.ops.curve_ops import JPoint, device_curve
from proof_systems_tpu_torch.poseidon.sponge import ScalarChallenge
from torch_host_harness import run_pinned

torch.set_num_threads(1)

HERE = pathlib.Path(__file__).resolve().parent
CSRC = HERE.parent / "proof_systems_tpu_torch" / "csrc"
CURVES = {"Vesta": (Vesta, JVesta), "Pallas": (Pallas, JPallas)}
N = 5  # points; the second is the point at infinity


def _points(curve, seed: int) -> list:
    rng = np.random.default_rng(seed)
    pts = [curve.scalar_mul(int(rng.integers(1, 1 << 62)), curve.generator) for _ in range(N)]
    pts[1] = None
    return pts


def _bits(pattern: str, seed: int) -> list[int]:
    if pattern == "zeros":
        return [0] * 128
    if pattern == "ones":
        return [1] * 128
    return [int(b) for b in np.random.default_rng(seed).integers(0, 2, 128)]


def _jax_ladder(jdc, jp: JJPoint, bits: list[int]) -> JJPoint:
    """The reference's ladder (ipa.py:554-574) as a Python loop of its
    DeviceCurve.add and double."""
    Fb = jdc.F
    phix = jlimb.mont_mul(Fb, jp.x, Fb.const_mont(jdc.params.endos[0], (1,)))
    negy = jlimb.neg(Fb, jp.y)
    acc = jdc.double(jdc.add(jp, JJPoint(phix, jp.y, jp.z)))
    for j in range(63, -1, -1):
        qx = jlimb.select(jnp.asarray(bits[2 * j + 1] == 1), phix, jp.x)
        qy = jlimb.select(jnp.asarray(bits[2 * j] == 1), jp.y, negy)
        acc = jdc.add(jdc.double(acc), JJPoint(qx, qy, jp.z))
    return acc


@pytest.mark.parametrize("pattern", ["random", "zeros", "ones"])
@pytest.mark.parametrize("name", CURVES)
def test_ladder_matches_jax_loop_and_host(name, pattern):
    curve, jcurve = CURVES[name]
    seed = 700 + len(name) + len(pattern)
    pts, bits = _points(curve, seed), _bits(pattern, seed)
    jdc, dc = jdevice_curve(jcurve), device_curve(curve)
    jp = jdc.to_jacobian(jdc.pack_affine(pts))
    p = JPoint(*(convert.limbs_from_numpy(np.asarray(t), device="cpu") for t in jp))
    got = dc.endo_ladder(p, torch.tensor(bits, dtype=torch.int32))

    want = _jax_ladder(jdc, jp, bits)
    for a, b in zip(got, want):
        assert np.array_equal(convert.limbs_to_numpy(a), np.asarray(b))

    value = sum(b << i for i, b in enumerate(bits))
    u = ScalarChallenge(value).to_field(curve.endos[1], curve.scalar)
    assert dc.unpack_jacobian(got) == [None if q is None else curve.scalar_mul(u, q) for q in pts]


def _words(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32).reshape(-1)


@pytest.mark.parametrize("name", CURVES)
def test_ladder_and_k2_device_code_on_the_host(tmp_path, name):
    curve = CURVES[name][0]
    dc = device_curve(curve)
    F = dc.F
    patterns = [_bits(p, 710 + i) for i, p in enumerate(["random", "zeros", "ones"])]
    pts = _points(curve, 720)
    P = dc.to_jacobian(dc.pack_affine(pts, device="cpu"))
    # K2's operands, doubled (z != R): P + P, P + (-P), infinity on either
    # side and on both, random pairs
    rng = np.random.default_rng(730)
    ps = [curve.scalar_mul(int(rng.integers(1, 1 << 62)), curve.generator) for _ in range(8)]
    qs = [curve.scalar_mul(int(rng.integers(1, 1 << 62)), curve.generator) for _ in range(8)]
    qs[0], qs[1], ps[2], qs[3], ps[4], qs[4] = ps[0], curve.neg(ps[1]), None, None, None, None
    A, B = (dc.double(dc.to_jacobian(dc.pack_affine(v, device="cpu"))) for v in (ps, qs))
    endo_words = F.pack_mont([curve.endos[0]], device="cpu")
    blob = np.concatenate([
        np.array(list(F.kernel_params), dtype=np.uint32), _words(endo_words.contiguous()),
        np.array([len(patterns)], dtype=np.uint32), np.array(sum(patterns, []), dtype=np.uint32),
        np.array([N], dtype=np.uint32), *(_words(t) for t in P),
        np.array([len(ps)], dtype=np.uint32), *(_words(t.contiguous()) for t in (*A, *B)),
    ])
    src, out = tmp_path / "in.bin", tmp_path / "out.bin"
    blob.tofile(src)
    exe = tmp_path / "ladder_host"
    subprocess.run(["g++", "-std=c++20", "-O1", "-w", "-I", str(HERE / "cuda_host"),
                    "-I", str(CSRC), "-o", str(exe), str(HERE / "cuda_host" / "ladder_host.cpp")],
                   check=True, capture_output=True, timeout=300)
    run = run_pinned([exe, src, out])
    assert run.returncode == 0, run.stdout + run.stderr
    assert run.stdout.count("equal") == len(patterns) + 2, run.stdout

    got = np.fromfile(out, dtype=np.uint32).reshape(len(patterns), 3, 8, N)
    for k, bits in enumerate(patterns):
        t = torch.tensor(bits, dtype=torch.int32)
        want = kernels.endo_ladder_plain(F, curve.endos[0], *P, t)
        for c in range(3):
            assert np.array_equal(got[k, c], _words(want[c]).reshape(8, N)), (k, c)
