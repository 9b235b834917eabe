"""K11's CUDA source run on the CPU: csrc/inv_field.cuh compiled with the
host C++ compiler against the stand-in cuda_runtime.h (tests/cuda_host/),
through tests/cuda_host/inv_host.cpp, in Fp and Fq, limb for limb:

- the binary-GCD inverse fe_inv_gcd against pow(x, -1, p), on 0, 1, 2,
  p - 1, p - 2, R mod p, R^2 mod p, 2^255 mod p and numpy-seeded values,
  and its product with R^3 mod p against the Montgomery form of the
  inverse;
- K11's thread (endo_inv_thread: the closed form of ScalarChallenge.to_field,
  then the inverse) against endo_inv_plain, the port's plain version (the
  64-step recurrence and the Fermat chain), and against the JAX package's
  endo_inv_fused run as its own tests run it on the CPU (Pallas interpret
  mode), on all-zero, all-one and seeded challenge bits, over the scalar
  fields of Vesta and Pallas.

nvcc has the last word: g++ accepts code that nvcc may refuse, and the card
runs the kernel (tests/test_torch_cuda.py)."""

import pathlib
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proof_systems_tpu.ops import limb as jlimb
from proof_systems_tpu.ops import pallas_field
from proof_systems_tpu_torch.curves import Pallas, Vesta
from proof_systems_tpu_torch.fields import Fp, Fq
from proof_systems_tpu_torch.ops import kernels, limb
from torch_host_harness import run_pinned

torch.set_num_threads(1)

HERE = pathlib.Path(__file__).resolve().parent
CSRC = HERE.parent / "proof_systems_tpu_torch" / "csrc"
FIELDS = {"Fp": Fp, "Fq": Fq}
CURVES = {"Vesta": Vesta, "Pallas": Pallas}  # scalar fields Fp and Fq


@pytest.fixture(scope="module")
def exe(tmp_path_factory):
    out = tmp_path_factory.mktemp("inv_host") / "inv_host"
    subprocess.run(["g++", "-std=c++20", "-O1", "-w", "-I", str(HERE / "cuda_host"),
                    "-I", str(CSRC), "-o", str(out), str(HERE / "cuda_host" / "inv_host.cpp"),
                    "-lpthread"], check=True, capture_output=True, timeout=300)
    return out


def _words(x: int) -> list[int]:
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(8)]


def _ints(words) -> list[int]:
    return [sum(int(w) << (32 * i) for i, w in enumerate(words[j:j + 8]))
            for j in range(0, len(words), 8)]


def _run(exe, tmp_path, field, xs, endo: int = 0, challenges=()) -> list[int]:
    """The harness's output as integers: inv(x) and inv(x) R^2 for each x,
    then u and u^-1 (Montgomery integers) for each challenge."""
    F = limb.device_field(field)
    consts = list(kernels._endo_consts(F.p, F.r_mod_p, endo))
    words = list(F.kernel_params.tolist()) + [len(xs)]
    words += [w for x in xs for w in _words(x)] + consts + [len(challenges)]
    for bits in challenges:
        words += list(bits)
    src, dst = tmp_path / "in.bin", tmp_path / "out.bin"
    np.array(words, dtype="<u4").tofile(src)
    res = run_pinned([exe, src, dst])
    assert res.returncode == 0, res.stdout + res.stderr
    return _ints(np.fromfile(dst, dtype="<u4").tolist())


def _edge(p: int) -> list[int]:
    r = (1 << 256) % p
    return [0, 1, 2, p - 1, p - 2, r, r * r % p, (1 << 255) % p]


@pytest.mark.parametrize("values", ["edge", "seeded"])
@pytest.mark.parametrize("name", FIELDS)
def test_inverse_matches_pow(exe, tmp_path, name, values):
    """fe_inv_gcd(x) = x^-1 mod p (0 -> 0), and its product with R^3 mod p
    is the Montgomery form of the inverse of the element x R^-1."""
    p = FIELDS[name].p
    if values == "edge":
        xs = _edge(p)
    else:
        rng = np.random.default_rng(1101 if name == "Fp" else 1102)
        xs = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(96)]
    got = _run(exe, tmp_path, FIELDS[name], xs)
    r = (1 << 256) % p
    for i, x in enumerate(xs):
        inv = pow(x, -1, p) if x else 0
        assert got[2 * i] == inv, x
        assert got[2 * i + 1] == inv * r * r % p, x


def _challenges(seed: int):
    rng = np.random.default_rng(seed)
    return {"zeros": [0] * 128, "ones": [1] * 128,
            "seeded_a": rng.integers(0, 2, 128).tolist(),
            "seeded_b": rng.integers(0, 2, 128).tolist()}


@pytest.mark.parametrize("pattern", ["zeros", "ones", "seeded_a", "seeded_b"])
@pytest.mark.parametrize("curve", CURVES)
def test_endo_closed_form_matches_plain_and_jax(exe, tmp_path, curve, pattern):
    """K11's thread (u by the closed form, u^-1 by the binary GCD) equals
    the plain version's recurrence and Fermat inverse, and the JAX
    package's endo_inv_fused, limb for limb."""
    c = CURVES[curve]
    field = c.scalar
    endo = c.endos[1]
    bits = _challenges(1103 if curve == "Vesta" else 1104)[pattern]
    u, u_inv = _run(exe, tmp_path, field, [], endo, [bits])
    F = limb.device_field(field)
    pu, pu_inv = kernels.endo_inv_plain(F, endo, torch.tensor(bits, dtype=torch.int32))
    assert F.unpack(pu) == [u] and F.unpack(pu_inv) == [u_inv]
    JF = jlimb.device_field(field)
    ju, ju_inv = pallas_field.endo_inv_fused(JF, endo, jnp.asarray(bits, dtype=jnp.int32))
    assert JF.unpack_mont(ju) == F.unpack_mont(pu)
    assert JF.unpack_mont(ju_inv) == F.unpack_mont(pu_inv)
    r_inv = pow(1 << 256, -1, field.p)
    assert (u * r_inv) * (u_inv * r_inv) % field.p == 1
