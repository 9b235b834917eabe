"""The plain versions of the IPA's kernels on the CPU against the JAX
package: K8 combine_windows against msm._combine_windows_body (its XLA
branch on the CPU) and host Horner; K10 sponge_squeeze2, bits128 and K11
endo_inv against the host sponge, ScalarChallenge.to_field and pow(u, -1, p),
the sequence of tests/test_pallas_field.py:81-138 without the Pallas
interpret run. Every comparison is exact."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from proof_systems_tpu.curves import Vesta as JVesta
from proof_systems_tpu.ops import msm as jmsm
from proof_systems_tpu.ops.curve_ops import JPoint as JJPoint
from proof_systems_tpu.ops.curve_ops import device_curve as jdevice_curve
from proof_systems_tpu.poseidon import FqSponge as JFqSponge
from proof_systems_tpu.poseidon import fq_kimchi as jfq_kimchi
from proof_systems_tpu_torch import convert
from proof_systems_tpu_torch.curves import Vesta
from proof_systems_tpu_torch.fields import Fp
from proof_systems_tpu_torch.ops import kernels, limb
from proof_systems_tpu_torch.ops.curve_ops import JPoint, device_curve
from proof_systems_tpu_torch.poseidon import fq_kimchi

torch.set_num_threads(1)


def test_combine_windows_plain_matches_jax_and_host():
    """W = 3, b = 4, c = 2, general Jacobian partials, one at infinity."""
    rng = random.Random(701)
    W, b, c = 3, 4, 2
    dc = device_curve(Vesta)
    g = Vesta.generator
    pts = [Vesta.scalar_mul(rng.randrange(1, Vesta.scalar.p), g) for _ in range(W * b)]
    pts[5] = None  # window 1, column 1
    J = dc.double(dc.to_jacobian(dc.pack_affine(pts, device="cpu")))
    wins = JPoint(*(t.reshape(8, W, b).contiguous() for t in J))
    got = kernels.combine_windows(dc.F, c, *wins)

    jdc = jdevice_curve(JVesta)
    jwins = JJPoint(*(jnp.asarray(convert.limbs_to_numpy(t)) for t in wins))
    want = jmsm._combine_windows_body(jdc, c, jwins)
    for ours, theirs in zip(got, want):
        assert np.array_equal(convert.limbs_to_numpy(ours), np.asarray(theirs))

    doubled = [Vesta.double(p) for p in pts]
    host = []
    for col in range(b):
        acc = None
        for w in range(W - 1, -1, -1):
            for _ in range(c):
                acc = Vesta.double(acc)
            acc = Vesta.add(acc, doubled[w * b + col])
        host.append(acc)
    assert dc.unpack_jacobian(JPoint(*got)) == host


@pytest.mark.parametrize("case", ["points", "L_at_infinity"])
def test_round_transcript_plain_matches_host_sponge(case):
    """absorb L, R -> 128-bit challenge -> endo expansion -> inverse, from
    a sponge in the squeezed state, as every IPA round runs it."""
    rng = random.Random(702)
    curve = Vesta
    sponge = JFqSponge(jfq_kimchi, JVesta)
    sponge.absorb_fq([5, 7, 11])
    sponge.squeeze_field()
    state0 = list(sponge.sponge.state)
    L = curve.scalar_mul(rng.randrange(1, curve.scalar.p), curve.generator)
    R = curve.scalar_mul(rng.randrange(1, curve.scalar.p), curve.generator)
    if case == "L_at_infinity":
        L = None
    sponge.absorb_g([L])
    sponge.absorb_g([R])
    endo_r = curve.endos[1]
    u_host = sponge.challenge().to_field(endo_r, JVesta.scalar)

    Fq = limb.device_field(fq_kimchi.field)
    F = limb.device_field(Fp)
    xs = Fq.pack_mont([0 if L is None else L[0], R[0]], device="cpu")
    ys = Fq.pack_mont([0 if L is None else L[1], R[1]], device="cpu")
    st, chal = kernels.sponge_squeeze2(
        Fq, fq_kimchi.rounds_full, Fq.pack_mont(state0, device="cpu"), xs, ys,
        kernels.sponge_consts(fq_kimchi, "cpu"),
    )
    assert Fq.unpack_mont(st) == list(sponge.sponge.state)
    assert Fq.unpack(chal) == [sponge.sponge.state[0]]
    bits = kernels.bits128(chal)
    assert sum(int(v) << i for i, v in enumerate(bits.tolist())) == Fq.unpack(chal)[0] % (1 << 128)
    u, u_inv = kernels.endo_inv(F, endo_r, bits)
    assert F.unpack_mont(u) == [u_host]
    assert F.unpack_mont(u_inv) == [pow(u_host, -1, Fp.p)]


@pytest.mark.parametrize("bits", ["zeros", "ones"])
def test_endo_inv_plain_edge_bits(bits):
    from proof_systems_tpu.poseidon.sponge import ScalarChallenge

    v = 0 if bits == "zeros" else (1 << 128) - 1
    F = limb.device_field(Fp)
    endo_r = Vesta.endos[1]
    t = torch.tensor([(v >> i) & 1 for i in range(128)], dtype=torch.int32)
    u, u_inv = kernels.endo_inv(F, endo_r, t)
    want = ScalarChallenge(v).to_field(endo_r, JVesta.scalar)
    assert F.unpack_mont(u) == [want]
    assert F.unpack_mont(u_inv) == [pow(want, -1, Fp.p)]
