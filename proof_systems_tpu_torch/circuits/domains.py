"""Evaluation domains d1/d2/d4/d8 (kimchi/src/circuits/domains.rs:23-39).

Counterpart of proof_systems_tpu/circuits/domains.py. Each domain is an
NttPlan (ops/ntt.py) on one device, with arkworks' Radix2EvaluationDomain
conventions. d8 hosts the quotient evaluation; d1 hosts witness columns.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields import FieldParams
from ..ops.ntt import NttPlan, ntt_plan


@dataclass
class EvaluationDomains:
    field: FieldParams
    d1: NttPlan
    d2: NttPlan
    d4: NttPlan
    d8: NttPlan

    @classmethod
    def create(cls, field: FieldParams, n: int, device=None) -> "EvaluationDomains":
        """The four plans on `device` (the CUDA card unless device="cpu")."""
        log_n = max((n - 1).bit_length(), 1)
        if (1 << log_n) < n:
            log_n += 1
        return cls(field, *(ntt_plan(field, log_n + k, device) for k in range(4)))


def domain_size(n: int) -> int:
    """Smallest power of two >= n (arkworks compute_size_of_domain)."""
    size = 1
    while size < n:
        size *= 2
    return size
