"""The IPA test case shared by tests/test_torch_ipa.py and
tests/test_torch_ipa_verify.py: two polynomials over a 16-point Vesta SRS,
their hiding commitments and evaluations, built from a seed; and the
JAX package's opening of them."""

import random

import torch

from proof_systems_tpu.curves import Vesta as JVesta
from proof_systems_tpu.ops import limb as jlimb
from proof_systems_tpu.poly_commitment import ipa as jipa
from proof_systems_tpu.poly_commitment import srs as jsrs
from proof_systems_tpu.poseidon import FqSponge as JFqSponge
from proof_systems_tpu.poseidon import fq_kimchi as jfq_kimchi
from proof_systems_tpu.utils import TestRng as JTestRng
from proof_systems_tpu_torch.curves import Vesta
from proof_systems_tpu_torch.ops import limb
from proof_systems_tpu_torch.poly_commitment import ipa
from proof_systems_tpu_torch.poly_commitment.commitment import PolyComm, combined_inner_product
from proof_systems_tpu_torch.poly_commitment.srs import SRS, derive_g, derive_h
from proof_systems_tpu_torch.poseidon import FqSponge, fq_kimchi
from proof_systems_tpu_torch.utils.rng import TestRng

N = 16
f = Vesta.scalar


def host_eval(coeffs, x):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % f.p
    return acc


class Case:
    """Two polynomials over a 16-point SRS, the second of length 21 (two
    chunks), their hiding commitments, evaluation points and scales."""

    def __init__(self):
        rng = random.Random(7)
        g = [derive_g(Vesta, i) for i in range(N)]
        h = derive_h(Vesta)
        self.srs = SRS(Vesta, g, h, torch.device("cpu"))
        self.jsrs = jsrs.SRS(JVesta, g, h)
        self.polys = [[rng.randrange(f.p) for _ in range(L)] for L in (N, N + 5)]
        self.blinders = [[rng.randrange(f.p)], [rng.randrange(f.p), rng.randrange(f.p)]]
        chunks = [[c[i : i + N] for i in range(0, len(c), N)] for c in self.polys]
        self.comms = [
            self.srs.mask(PolyComm([Vesta.msm(ch, g[: len(ch)]) for ch in cs]), w)
            for cs, w in zip(chunks, self.blinders)
        ]
        self.elm = [rng.randrange(f.p), rng.randrange(f.p)]
        self.polyscale = rng.randrange(f.p)
        self.evalscale = rng.randrange(f.p)
        # evals[poly][point][chunk]
        self.evals = [[[host_eval(ch, e) for ch in cs] for e in self.elm] for cs in chunks]
        self.cip = combined_inner_product(f, self.polyscale, self.evalscale, self.evals)
        self._jax_opening = None
        self._openings = {}

    def plnms(self):
        F = limb.device_field(f)
        return [(F.pack_mont(c, device="cpu"), w) for c, w in zip(self.polys, self.blinders)]

    def open(self, tail_target):
        """The port's opening (made once per tail_target)."""
        if tail_target not in self._openings:
            self._openings[tail_target] = ipa.open_proof(
                self.srs, self.plnms(), self.elm, self.polyscale, self.evalscale,
                FqSponge(fq_kimchi, Vesta), TestRng(1), tail_target=tail_target,
            )
        return self._openings[tail_target]

    def jax_opening(self):
        if self._jax_opening is None:
            F = jlimb.device_field(JVesta.scalar)
            plnms = [(F.pack_mont(c, shape=(len(c),)), w) for c, w in zip(self.polys, self.blinders)]
            self._jax_opening = jipa.open_proof(
                self.jsrs, plnms, self.elm, self.polyscale, self.evalscale,
                JFqSponge(jfq_kimchi, JVesta), JTestRng(1),
            )
        return self._jax_opening

    def batch(self, opening, evals=None, cip=None, jax_side=False):
        m = jipa if jax_side else ipa
        sponge = JFqSponge(jfq_kimchi, JVesta) if jax_side else FqSponge(fq_kimchi, Vesta)
        evals = self.evals if evals is None else evals
        return [m.BatchEvaluationProof(
            sponge=sponge,
            evaluations=[m.Evaluation(c, ev) for c, ev in zip(self.comms, evals)],
            evaluation_points=self.elm,
            polyscale=self.polyscale,
            evalscale=self.evalscale,
            opening=m.OpeningProof(**vars(opening)),
            combined_inner_product=self.cip if cip is None else cip,
        )]
