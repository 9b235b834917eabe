"""The port's NTT (proof_systems_tpu_torch.ops.ntt) against the JAX
package's NttPlan on the CPU: same seeded Montgomery inputs with a batch
axis, outputs compared limb for limb."""

import random

import numpy as np
import pytest
import torch

from proof_systems_tpu.fields import Fp as JFp
from proof_systems_tpu.fields import Fq as JFq
from proof_systems_tpu.ops import ntt as jntt
from proof_systems_tpu_torch import convert
from proof_systems_tpu_torch.fields import Fp, Fq
from proof_systems_tpu_torch.ops import ntt

# One intra-op thread: the suite runs a test process per core, and torch's
# default of one thread per core in each of them oversubscribes the machine.
torch.set_num_threads(1)

FIELDS = {"Fp": (Fp, JFp), "Fq": (Fq, JFq)}


@pytest.mark.parametrize("log_n", [1, 4, 8])
@pytest.mark.parametrize("name", FIELDS)
def test_ntt_intt_match_jax(name, log_n):
    field, jfield = FIELDS[name]
    rng = random.Random(300 + log_n)
    n = 1 << log_n
    jplan = jntt.ntt_plan(jfield, log_n)
    plan = ntt.ntt_plan(field, log_n, device="cpu")
    assert plan.group_gen == jplan.group_gen
    xs = [rng.randrange(field.p) for _ in range(2 * n)]
    jx = jplan.F.pack_mont(xs, shape=(2, n))
    x = convert.limbs_from_numpy(np.asarray(jx), device="cpu")

    fwd = plan.ntt(x)
    assert np.array_equal(convert.limbs_to_numpy(fwd), np.asarray(jplan.ntt(jx)))
    inv = plan.intt_t(x, plan.inv_twiddles)
    assert np.array_equal(
        convert.limbs_to_numpy(inv), np.asarray(jplan.intt_t(jx, jplan.inv_twiddles))
    )
    assert plan.F.unpack_mont(plan.intt(fwd)) == xs


def test_plan_rejects_wrong_length():
    plan = ntt.ntt_plan(Fp, 3, device="cpu")
    x = plan.F.pack_mont(list(range(4)), device="cpu")
    with pytest.raises(ValueError):
        plan.ntt(x)
