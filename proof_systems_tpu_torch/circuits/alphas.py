"""Powers-of-alpha registry (kimchi/src/alphas.rs).

Argument kinds register contiguous ranges of alpha exponents; all gate
arguments SHARE one range sized by the largest gate constraint count
(21, VarbaseMul — linearization.rs:54-58), then the permutation (3)
and lookup ranges follow.

Counterpart of proof_systems_tpu/circuits/alphas.py, host code copied as it is.
"""

from __future__ import annotations


class Alphas:
    def __init__(self):
        self._ranges: dict[str, tuple[int, int]] = {}
        self._next = 0
        self._alpha: int | None = None
        self._p: int | None = None

    def register(self, kind: str, count: int) -> None:
        if kind in self._ranges:
            raise ValueError(f"{kind} already registered")
        self._ranges[kind] = (self._next, count)
        self._next += count

    def get_exponents(self, kind: str, count: int) -> list[int]:
        start, avail = self._ranges[kind]
        assert count <= avail, f"not enough alphas for {kind}"
        return list(range(start, start + count))

    def instantiate(self, alpha: int, p: int) -> None:
        self._alpha = alpha
        self._p = p

    def get_alphas(self, kind: str, count: int) -> list[int]:
        assert self._alpha is not None, "alphas not instantiated"
        return [pow(self._alpha, e, self._p) for e in self.get_exponents(kind, count)]

    def copy(self) -> "Alphas":
        out = Alphas()
        out._ranges = dict(self._ranges)
        out._next = self._next
        return out


def default_alphas(lookup_constraints: int = 0) -> Alphas:
    """The berkeley registration order (linearization.rs:50-58,168-170)."""
    a = Alphas()
    a.register("gate", 21)
    a.register("permutation", 3)
    if lookup_constraints:
        a.register("lookup", lookup_constraints)
    return a
