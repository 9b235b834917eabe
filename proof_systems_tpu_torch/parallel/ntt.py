"""Row-sharded distributed NTT over the data mesh (four-step algorithm).

Counterpart of proof_systems_tpu/parallel/ntt.py. The transform of
n = n1 * n2 points, with n1 the world size W:

    x[j1*n2 + j2] = A[j1, j2]
    B[k1, j2] = NTT_n1(A[:, j2])              # local, j2 sharded
    C[k1, j2] = B[k1, j2] * w^(j2*k1)          # local twiddle (K1)
    (reshard: one all_to_all, j2-sharded -> k1-sharded)
    D[k1, k2] = NTT_n2(C[k1, :])              # local, k1 sharded
    X[k2*n1 + k1] = D[k1, k2]                  # natural order

Each rank holds n2 / W columns of A (so n >= W^2) and, after the
exchange, one row k1 = rank of D. The local transforms are the port's
ops/ntt plans (K1 under every stage); the inverse is the same
factorisation with w^-1 twiddles, whose two local 1/n1 and 1/n2 scales
compose to 1/n. n1 = 1, a world of one, is the plain transform.
"""

from __future__ import annotations

import functools

import torch

from ..fields import FieldParams
from ..ops import limb, ntt
from ..ops.limb import NLIMBS
from .auto import Mesh, all_gather


class DistNttPlan:
    """Four-step NTT plan for one (field, log_n, mesh).

    Layout on each rank: input (8, n1, n2 / W), the rank's block of j2
    columns; output (8, n1 / W, n2) = (8, 1, n2), its k1 row of D."""

    def __init__(self, field: FieldParams, log_n: int, mesh: Mesh):
        W = mesh.size
        if W & (W - 1):
            raise ValueError("the world size must be a power of two")
        self.field, self.log_n, self.mesh = field, log_n, mesh
        self.n = 1 << log_n
        self.n1 = W
        self.n2 = self.n // W
        if self.n2 % W or self.n2 * W != self.n:
            raise ValueError(f"2^{log_n} points do not split into {W} x {W} blocks")
        self.n2_local = self.n2 // W
        self.F = limb.device_field(field)
        dev = mesh.device
        log_n1 = W.bit_length() - 1
        self.plan1 = ntt.ntt_plan(field, log_n1, device=dev)
        self.plan2 = ntt.ntt_plan(field, log_n - log_n1, device=dev)
        w = field.root_of_unity(log_n)
        self.twiddle = self._twiddles(w)
        self.twiddle_inv = self._twiddles(field.inv(w))

    def _twiddles(self, w: int) -> torch.Tensor:
        """T[k1, j2] = w^(j2*k1) for this rank's j2 columns, Montgomery,
        (8, n2_local, n1) (j2 ahead of k1, as the local transform wants)."""
        p = self.field.p
        lo = self.mesh.rank * self.n2_local
        vals = []
        for j2 in range(lo, lo + self.n2_local):
            step, acc = pow(w, j2, p), 1
            for _ in range(self.n1):
                vals.append(acc)
                acc = acc * step % p
        return self.F.pack_mont(vals, shape=(self.n2_local, self.n1), device=self.mesh.device)

    def _run(self, a: torch.Tensor, inverse: bool) -> torch.Tensor:
        W, n2l = self.n1, self.n2_local
        if tuple(a.shape) != (NLIMBS, W, n2l):
            raise ValueError(f"a rank's block is (8, {W}, {n2l}), got {tuple(a.shape)}")
        x = a.transpose(1, 2)  # (8, n2l, n1): transform along j1
        b = self.plan1.intt(x) if inverse else self.plan1.ntt(x)
        c = limb.mont_mul(self.F, b, self.twiddle_inv if inverse else self.twiddle)
        # reshard: chunk i of the first axis (k1 = i) goes to rank i; the
        # chunks received are the senders' j2 blocks, in rank order
        send = c.permute(2, 0, 1).contiguous()  # (n1, 8, n2l)
        recv = torch.empty_like(send)
        if W > 1:
            import torch.distributed as dist

            dist.all_to_all_single(recv, send, group=self.mesh.group)
        else:
            recv = send
        d = recv.permute(1, 0, 2).reshape(NLIMBS, 1, self.n2)  # (8, k1 = rank, n2)
        return self.plan2.intt(d) if inverse else self.plan2.ntt(d)

    # -- public API -------------------------------------------------------

    def shard_input(self, coeffs: torch.Tensor) -> torch.Tensor:
        """(8, n) or (8, n1, n2), the same on every rank -> this rank's
        (8, n1, n2 / W) block of j2 columns."""
        a = coeffs.reshape(NLIMBS, self.n1, self.n2)
        lo = self.mesh.rank * self.n2_local
        return a[..., lo:lo + self.n2_local].contiguous()

    def ntt(self, a: torch.Tensor) -> torch.Tensor:
        """This rank's block -> its row of D, (8, 1, n2):
        X[k2*n1 + rank] = D[rank, k2]."""
        return self._run(a, inverse=False)

    def intt(self, a: torch.Tensor) -> torch.Tensor:
        return self._run(a, inverse=True)

    def to_natural(self, d: torch.Tensor) -> torch.Tensor:
        """Gather every rank's row of D into the natural-order (8, n),
        on every rank: X[k2*n1 + k1] = D[k1, k2]."""
        rows = all_gather(d[:, 0], self.mesh)  # (n1, 8, n2)
        return rows.permute(1, 2, 0).reshape(NLIMBS, self.n)


@functools.lru_cache(maxsize=None)
def dist_ntt_plan(field: FieldParams, log_n: int, mesh: Mesh) -> DistNttPlan:
    return DistNttPlan(field, log_n, mesh)
