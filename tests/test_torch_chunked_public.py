"""Public inputs on a chunked domain, on the CPU: bench_circuit(40) with 2
public inputs over a 32-point derived SRS (a 64-point domain in 2 chunks),
bench_witness(40). The port's prover gives the JAX package's bytes. The
port's verifier refuses with NotImplementedError: the Lagrange commitments
of a 64-point domain over a 32-point SRS do not exist here, and the JAX
package's verifier fails its MSM's length assert on the same proof
(ROADMAP Queue 3, a fault of the reference that the port does not copy)."""

import pytest

from proof_systems_tpu_torch import verifier
from proof_systems_tpu_torch.utils.rng import TestRng

from test_torch_chunked import SEED, prove_both

PUBLIC = 2


def test_public_inputs_on_a_chunked_domain():
    both = prove_both(PUBLIC)
    assert both["raw"] == both["jraw"]
    with pytest.raises(NotImplementedError, match="Queue 3"):
        verifier.verify(both["index"].verifier_index(), both["proof"], [1] * PUBLIC,
                        TestRng(SEED + 3))
