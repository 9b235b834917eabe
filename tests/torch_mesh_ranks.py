"""Rank bodies of tests/test_torch_mesh.py (gloo ranks on the CPU).

Spawned ranks re-import the module that defines their function; this one
imports torch and the port only, so no rank loads JAX. Each function runs
on every rank and returns host values (ints, lists, bytes, numpy arrays)
for the test process to hold against the JAX package."""

import random

import numpy as np
import torch

from proof_systems_tpu_torch import convert
from proof_systems_tpu_torch.curves import Vesta
from proof_systems_tpu_torch.fields import Fp
from proof_systems_tpu_torch.ops import limb, msm
from proof_systems_tpu_torch.ops.curve_ops import device_curve
from proof_systems_tpu_torch.parallel.mesh import sharded_msm_check, sharded_ntt_step
from proof_systems_tpu_torch.parallel.ntt import DistNttPlan

N, GATES = 32, 22  # the fixed 2^5 circuit of tests/vectors/proof_2^5.bin
NTT_LOG_N = 7


def random_points(rng, n):
    pts = [Vesta.scalar_mul(rng.randrange(1, Vesta.scalar.p), Vesta.generator) for _ in range(n)]
    pts[3] = None
    return pts


def random_rows(rng, b, n):
    return [[rng.randrange(Vesta.scalar.p) for _ in range(n)] for _ in range(b)]


def msm_cases():
    """(name, n, b, c, scaled, points, scalar rows): tests/test_mesh.py's
    batch-sharded statement (Random(11)) and its point-sharded ones
    (Random(31): n = 64 on a scaled basis, n = 67 unscaled, padded)."""
    rng = random.Random(11)
    pts = random_points(rng, 16)
    cases = [("batch", 16, 8, 6, False, pts, random_rows(rng, 8, 16))]
    rng = random.Random(31)
    for n, scaled in ((64, True), (67, False)):
        pts = random_points(rng, n)
        cases.append((f"point{n}", n, 2, 6, scaled, pts, random_rows(rng, 2, n)))
    return cases


def quotient_inputs(device):
    """tests/test_torch_prover.py's seeded quotient inputs."""
    rng = np.random.default_rng(33)
    F = limb.device_field(Fp)
    w = F.pack_mont([int(v) for v in rng.integers(0, 1 << 62, 15 * N)], shape=(15, N),
                    device=device)
    z = F.pack_mont([int(v) for v in rng.integers(0, 1 << 62, N)], shape=(N,), device=device)
    vals = [int(v) for v in rng.integers(0, 1 << 62, 3)]
    return w, z, vals


def _count(module, name, counts):
    fn = getattr(module, name)

    def counted(*args, **kw):
        counts[name] = counts.get(name, 0) + 1
        return fn(*args, **kw)

    setattr(module, name, counted)


def mesh_checks(mesh):
    from proof_systems_tpu_torch import prover
    from proof_systems_tpu_torch.circuits.builders import bench_circuit, bench_witness
    from proof_systems_tpu_torch.circuits.constraints import ConstraintSystem
    from proof_systems_tpu_torch.poly_commitment.srs import SRS, derive_g, derive_h
    from proof_systems_tpu_torch.prover_index import ProverIndex
    from proof_systems_tpu_torch.serialization import serialize_proof
    from proof_systems_tpu_torch.utils.rng import TestRng
    from proof_systems_tpu_torch.verifier import verify

    dev = mesh.device
    F = limb.device_field(Fp)
    out = dict(rank=mesh.rank, size=mesh.size)

    dp = DistNttPlan(Fp, NTT_LOG_N, mesh)
    rng = random.Random(7)
    x = F.pack_mont([rng.randrange(Fp.p) for _ in range(dp.n)], shape=(dp.n,), device=dev)
    out["ntt"] = F.unpack_mont(dp.to_natural(dp.ntt(dp.shard_input(x))))
    rng = random.Random(8)
    vals = [rng.randrange(Fp.p) for _ in range(dp.n)]
    x = F.pack_mont(vals, shape=(dp.n,), device=dev)
    evals = dp.to_natural(dp.ntt(dp.shard_input(x)))
    out["ntt_back"] = F.unpack_mont(dp.to_natural(dp.intt(dp.shard_input(evals))))

    cols, total = sharded_ntt_step(mesh, mesh.size)
    out["step"] = (F.unpack_mont(cols), F.unpack_mont(total))

    routes = {}
    for name in ("_batch_sharded_msm", "_point_sharded_msm", "_pad_points_for_shard"):
        _count(msm, name, routes)
    _count(prover, "all_gather", routes)
    curve = device_curve(Vesta)
    out["msm"] = {}
    for name, n, b, c, scaled, pts, rows in msm_cases():
        scal = torch.from_numpy(limb.ints_to_limbs([s for r in rows for s in r],
                                                   shape=(b, n))).to(dev)
        apts = curve.pack_affine(pts, device=dev)
        if scaled:
            basis = msm.scale_basis(curve, apts, c, msm.num_windows(c))
            got = msm.msm(Vesta, scal, c=c, scaled=basis, device=dev)
        else:
            got = msm.msm(Vesta, scal, apts, c=c, device=dev)
        out["msm"][name] = got
    out["msm_routes"] = dict(routes)
    out["msm_check"] = sharded_msm_check(mesh, mesh.size, n=32, b=2)

    g = [derive_g(Vesta, i) for i in range(N)]
    cs = ConstraintSystem.create(Fp, bench_circuit(Fp, GATES), public=0, max_poly_size=N,
                                 device=dev)
    index = ProverIndex(cs, Vesta, SRS(Vesta, g, derive_h(Vesta), dev))
    routes.clear()
    proof = prover.create_proof(index, bench_witness(GATES), TestRng(5))
    out["proof"] = serialize_proof(Vesta, proof)
    out["proof_routes"] = dict(routes)
    out["verifies"] = verify(index.verifier_index(), proof, [], TestRng(6))

    w, z, chal_vals = quotient_inputs(dev)
    chal = {k: F.pack_mont([v], shape=(1,), device=dev)
            for k, v in zip(("alpha", "beta", "gamma"), chal_vals)}
    routes.clear()
    q = prover._quotient_fn(index)(w, z, F.zeros((N,), device=dev), chal)
    out["quotient"] = [convert.limbs_to_numpy(t) for i, t in enumerate(q) if i != 2]
    out["quotient_gathers"] = routes.get("all_gather", 0)
    return out


def failing(mesh):
    """A rank body that fails on rank 1 only."""
    if mesh.rank == 1:
        raise ValueError("rank 1 failed")
    return mesh.rank
