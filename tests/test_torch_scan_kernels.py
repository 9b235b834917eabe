"""K9 (linear_scan) and K12 (mont_prefix_scan_parts) on the CPU, where their
plain versions run, against the JAX package and the host: the boundary
division by X - c against prover._divide_by_linear_dev (its CPU blocked
scan) and the host recurrence; K12's geometry against
pallas_field._scan_geometry and its parts, combined, against limb.prefix_mul;
the port's prefix_mul and batch_inverse against JAX's on both sides of the
dispatch (C = 64 chunks of 128: K5; C = 65: K12 + K1). Every comparison is
exact. The kernels themselves: tests/test_torch_cuda.py, on the card."""

import random

import jax.numpy as jnp
import pytest
import torch

from proof_systems_tpu import prover as jprover
from proof_systems_tpu.fields import Fp as JFp
from proof_systems_tpu.ops import limb as jlimb
from proof_systems_tpu.ops import pallas_field
from proof_systems_tpu.ops import poly as jpoly
from proof_systems_tpu_torch import convert
from proof_systems_tpu_torch.fields import Fp
from proof_systems_tpu_torch.ops import kernels, limb, poly

torch.set_num_threads(1)

F = limb.device_field(Fp)
JF = jlimb.device_field(JFp)
OMEGA_32 = Fp.root_of_unity(5)


def _row(seed: int, rows: int, n: int, zero_at=None) -> list[int]:
    rng = random.Random(seed)
    xs = [rng.randrange(Fp.p) for _ in range(rows * n)]
    if zero_at is not None:
        xs[zero_at] = 0
    return xs


def _to_jax(t: torch.Tensor):
    return jnp.asarray(convert.limbs_to_numpy(t))


def _from_jax(a) -> torch.Tensor:
    return convert.limbs_from_numpy(a, device="cpu")


C_CASES = {"zero": 0, "one": 1, "random": random.Random(91).randrange(Fp.p),
           "omega": pow(OMEGA_32, 32 - 3, Fp.p)}


@pytest.mark.parametrize("c_name", list(C_CASES))
@pytest.mark.parametrize("n", [1, 7, 128, 300])
def test_linear_scan_plain_matches_jax_and_host(n, c_name):
    """Two rows of n coefficients divided by X - c: the port's quotient and
    remainder (K9's plain version over the reversed coefficients) equal the
    JAX package's and the host's synthetic division."""
    c = C_CASES[c_name]
    xs = _row(100 + n, 2, n)
    coeffs = F.pack_mont(xs, shape=(2, n), device="cpu")
    q, rem = poly.divide_by_linear_dev(F, coeffs, c)

    for r in range(2):  # the JAX function takes one row at a time
        jq, jrem = jprover._divide_by_linear_dev(JF, _to_jax(coeffs[:, r]), c)
        assert torch.equal(q[:, r], _from_jax(jq)) and torch.equal(rem[:, r], _from_jax(jrem))
        row = xs[r * n : (r + 1) * n]
        s, scan = 0, []
        for x in reversed(row):  # s_j = f_(n-1-j) + c s_(j-1)
            s = (x + c * s) % Fp.p
            scan.append(s)
        assert F.unpack_mont(q[:, r]) == scan[: n - 1][::-1]
        assert F.unpack_mont(rem[:, r]) == [scan[-1]]


def test_divide_by_vanishing_and_linear_match_jax():
    """f / (x^n - 1) for deg f < 8n (block suffix sums) and f / (x - c) with
    the remainder fetched, against the JAX package's ops/poly."""
    n = 16
    f = F.pack_mont(_row(3, 1, 8 * n - 3), shape=(8 * n - 3,), device="cpu")
    q, rem = poly.divide_by_vanishing(F, f, n)
    jq, jrem = jpoly.divide_by_vanishing(JF, _to_jax(f), n)
    assert torch.equal(q, _from_jax(jq)) and torch.equal(rem, _from_jax(jrem))
    c = C_CASES["random"]
    q, rem = poly.divide_by_linear(F, f, c)
    jq, jrem = jpoly.divide_by_linear(JF, _to_jax(f), c)
    assert torch.equal(q, _from_jax(jq)) and rem == jrem


@pytest.mark.parametrize("n", [1, 300, 8192, 8321, 32768, 1 << 16])
def test_scan_geometry_matches_jax(n):
    assert kernels.scan_geometry(n) == pallas_field._scan_geometry(n)


def test_prefix_scan_parts_plain_matches_jax_prefix_mul():
    """n = 8,321 (C = 66, Cp = 70) with a zero element: partial and excl,
    combined as excl[j // Cp] * partial[j], give JAX's prefix products."""
    n = 8321
    x = F.pack_mont(_row(7, 1, n, zero_at=4000), shape=(n,), device="cpu")
    partial, excl, cp = kernels.mont_prefix_scan_parts_plain(F, x[:, None, :])
    assert cp == pallas_field._scan_geometry(n)[2] == 70
    assert partial.shape == (8, 1, 128 * cp) and excl.shape == (8, 1, 128)
    lanes = torch.arange(n) // cp
    combined = limb.mont_mul(F, partial[:, 0, :n], excl[:, 0, lanes])
    want = _from_jax(jlimb.prefix_mul(JF, _to_jax(x)))
    assert torch.equal(combined, want)
    assert F.unpack_mont(combined[:, 3999:4001])[1] == 0


# both sides of the dispatch and the opening's short rows (1 point; L and
# R, 2); the zero at position 17, or at the last of a shorter row
@pytest.mark.parametrize("n", [8192, 8321, 1, 2],
                         ids=["C=64_K5", "C=66_K12", "n=1_K5", "n=2_K5"])
def test_prefix_mul_and_batch_inverse_match_jax(n):
    zero = min(17, n - 1)
    xs = _row(8 + n, 1, n, zero_at=zero)
    x = F.pack_mont(xs, shape=(n,), device="cpu")
    jx = _to_jax(x)
    assert torch.equal(limb.prefix_mul(F, x), _from_jax(jlimb.prefix_mul(JF, jx)))
    inv = limb.batch_inverse(F, x)
    assert torch.equal(inv, _from_jax(jlimb.batch_inverse(JF, jx)))
    got = F.unpack_mont(inv)
    assert got[zero] == 0 and all(v * g % Fp.p == 1 for v, g in zip(xs, got) if v)
