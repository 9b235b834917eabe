"""Symbolic constraint expressions, evaluated on the host or over d8.

Counterpart of proof_systems_tpu/circuits/expr.py (kimchi's expression
framework, kimchi/src/circuits/expr.rs):
  - constraints are a small Python AST (operator-overloaded);
  - the prover evaluates the combined constraint over the d8 domain by
    walking the AST once, each node one batched field op on (8, 8n)
    Montgomery tensors (memoised by node identity, kimchi's `Cache` CSE);
    the walk runs op by op, and a node's value is dropped once its last
    parent has used it, which changes no value;
  - the verifier evaluates the same AST at the single point zeta with exact
    host ints (the berkeley linearization's constant term).

The AST and the host evaluation are the reference's, copied as they are.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Any

import torch

from ..fields import FieldParams
from ..ops import limb
from .gate import GateType

CURR = 0
NEXT = 1


def col_witness(i: int):
    return ("witness", i)


def col_coeff(i: int):
    return ("coefficient", i)


def col_index(g: GateType):
    return ("index", int(g))


COL_Z = ("z",)


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


class Expr:
    def __add__(self, other):
        return Add(self, _wrap(other))

    def __radd__(self, other):
        return Add(_wrap(other), self)

    def __sub__(self, other):
        return Sub(self, _wrap(other))

    def __rsub__(self, other):
        return Sub(_wrap(other), self)

    def __mul__(self, other):
        return Mul(self, _wrap(other))

    def __rmul__(self, other):
        return Mul(_wrap(other), self)

    def __pow__(self, e: int):
        return Pow(self, e)

    def __neg__(self):
        return Sub(Literal(0), self)

    def double(self):
        return Add(self, self)

    def square(self):
        return Mul(self, self)

    def boolean(self):
        return Sub(Mul(self, self), self)


def _wrap(x) -> Expr:
    if isinstance(x, Expr):
        return x
    if isinstance(x, int):
        return Literal(x)
    raise TypeError(f"cannot use {type(x)} in an expression")


@dataclass(frozen=True, eq=False)
class Literal(Expr):
    value: int


@dataclass(frozen=True, eq=False)
class Cell(Expr):
    col: tuple
    row: int  # CURR | NEXT


@dataclass(frozen=True, eq=False)
class Challenge(Expr):
    """alpha | beta | gamma | joint_combiner (BerkeleyChallengeTerm)."""

    name: str


@dataclass(frozen=True, eq=False)
class NamedConstant(Expr):
    """endo_coefficient or mds(row, col) — resolved per curve at eval time."""

    name: str
    args: tuple = ()


@dataclass(frozen=True, eq=False)
class Add(Expr):
    a: Expr
    b: Expr


@dataclass(frozen=True, eq=False)
class Sub(Expr):
    a: Expr
    b: Expr


@dataclass(frozen=True, eq=False)
class Mul(Expr):
    a: Expr
    b: Expr


@dataclass(frozen=True, eq=False)
class Pow(Expr):
    a: Expr
    e: int


@dataclass(frozen=True, eq=False)
class VanishesOnZeroKnowledgeAndPreviousRows(Expr):
    """(x^n - 1) / prod_{i in [n - zk_rows - 1, n)} (x - w^i) complement:
    the polynomial vanishing on the last zk_rows + 1 rows (expr.rs)."""


@dataclass(frozen=True, eq=False)
class UnnormalizedLagrangeBasis(Expr):
    """(x^n - 1) / (x - w^offset); offset counted from the start, or from
    the first zk row when zk_anchored (expr.rs RowOffset)."""

    offset: int
    zk_anchored: bool = False


def alpha_pow(i: int) -> Expr:
    return Pow(Challenge("alpha"), i) if i else Literal(1)


def combine_constraints(alphas, constraints: list[Expr]) -> Expr:
    """Σ alpha^i · c_i (expr.rs:1621). Summed as a balanced tree so the
    recursive evaluators stay within Python's stack on constraint sets
    with thousands of terms (keccak: 10k+)."""
    terms = [
        alpha_pow(a_i) * c for a_i, c in zip(alphas, constraints, strict=True)
    ]
    if not terms:
        return Literal(0)
    while len(terms) > 1:
        nxt = [
            terms[i] + terms[i + 1] if i + 1 < len(terms) else terms[i]
            for i in range(0, len(terms), 2)
        ]
        terms = nxt
    return terms[0]


# ---------------------------------------------------------------------------
# Argument environment (argument.rs ArgumentEnv over symbolic T)
# ---------------------------------------------------------------------------


class ArgumentEnv:
    def witness_curr(self, i: int) -> Expr:
        return Cell(col_witness(i), CURR)

    def witness_next(self, i: int) -> Expr:
        return Cell(col_witness(i), NEXT)

    def coeff(self, i: int) -> Expr:
        return Cell(col_coeff(i), CURR)

    def mds(self, r: int, c: int) -> Expr:
        return NamedConstant("mds", (r, c))

    def endo_coefficient(self) -> Expr:
        return NamedConstant("endo")


# ---------------------------------------------------------------------------
# Host evaluation (exact ints; the verifier's PolishToken interpreter)
# ---------------------------------------------------------------------------


@dataclass
class HostEvalContext:
    f: FieldParams
    # (col, row) -> int; row NEXT means evaluation at ζω
    get_cell: Any
    challenges: dict[str, int]
    endo: int
    mds: list[list[int]]
    point: int  # ζ
    domain_n: int
    omega: int
    zk_rows: int
    # row offset -> value; used when evaluating AT a domain point w^j,
    # where the rational form (x^n-1)/(x-w^i) is 0/0 at j == i
    lagrange_overrides: dict | None = None


def eval_host(expr: Expr, ctx: HostEvalContext, memo: dict | None = None) -> int:
    if memo is None:
        memo = {}
    key = id(expr)
    if key in memo:
        return memo[key]
    p = ctx.f.p
    if isinstance(expr, Literal):
        v = expr.value % p
    elif isinstance(expr, Cell):
        v = ctx.get_cell(expr.col, expr.row) % p
    elif isinstance(expr, Challenge):
        v = ctx.challenges[expr.name] % p
    elif isinstance(expr, NamedConstant):
        v = ctx.endo if expr.name == "endo" else ctx.mds[expr.args[0]][expr.args[1]]
    elif isinstance(expr, Add):
        v = (eval_host(expr.a, ctx, memo) + eval_host(expr.b, ctx, memo)) % p
    elif isinstance(expr, Sub):
        v = (eval_host(expr.a, ctx, memo) - eval_host(expr.b, ctx, memo)) % p
    elif isinstance(expr, Mul):
        v = eval_host(expr.a, ctx, memo) * eval_host(expr.b, ctx, memo) % p
    elif isinstance(expr, Pow):
        v = pow(eval_host(expr.a, ctx, memo), expr.e, p)
    elif isinstance(expr, VanishesOnZeroKnowledgeAndPreviousRows):
        # Π_{i = n - (zk_rows + 1)}^{n-1} (x - w^i)
        # (vanishes_on_last_n_rows(d1, zk_rows + 1), permutation.rs:83)
        x = ctx.point
        v = 1
        w_i = pow(ctx.omega, ctx.domain_n - (ctx.zk_rows + 1), p)
        for _ in range(ctx.zk_rows + 1):
            v = v * (x - w_i) % p
            w_i = w_i * ctx.omega % p
    elif isinstance(expr, UnnormalizedLagrangeBasis):
        x = ctx.point
        i = expr.offset + (ctx.domain_n - ctx.zk_rows if expr.zk_anchored else 0)
        i %= ctx.domain_n
        if ctx.lagrange_overrides is not None:
            v = ctx.lagrange_overrides[i] % p
        else:
            num = (pow(x, ctx.domain_n, p) - 1) % p
            den = (x - pow(ctx.omega, i, p)) % p
            v = num * pow(den, -1, p) % p
    else:
        raise TypeError(f"unknown expr node {type(expr)}")
    memo[key] = v
    return v


# ---------------------------------------------------------------------------
# Device evaluation over d8 (the prover's quotient hot loop)
# ---------------------------------------------------------------------------


@dataclass
class DeviceEvalContext:
    F: limb.DeviceField
    # col -> (8, 8n) Montgomery evaluation tensor over d8
    columns: dict
    # name -> (8, 1) Montgomery tensor, or a host int
    challenges: dict
    endo: int
    mds: list[list[int]]
    domain_n: int  # d1 size
    zk_rows: int
    omega: int
    # d8 evaluations of special polynomials, precomputed by the caller:
    vanishes_on_zk_and_previous: Any = None
    # row index -> (8, 8n) evals of (x^n - 1)/(x - w^row)
    unnormalized_lagrange: dict | None = None

    def shifted(self, arr):
        """Row+1 on d8 = rotate by 8 evaluation positions."""
        return torch.roll(arr, -8, dims=-1)


def _children(expr: Expr) -> tuple:
    if isinstance(expr, (Add, Sub, Mul)):
        return (expr.a, expr.b)
    if isinstance(expr, Pow):
        return (expr.a,)
    return ()


def _parent_counts(expr: Expr) -> Counter:
    """How many parent edges of the DAG reach each node (by identity)."""
    counts: Counter = Counter()
    seen, stack = set(), [expr]
    while stack:
        node = stack.pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        for child in _children(node):
            counts[id(child)] += 1
            stack.append(child)
    return counts


def eval_dev(expr: Expr, ctx: DeviceEvalContext, memo: dict | None = None):
    """Walk the AST emitting batched field ops; returns (8, 8n) Montgomery.
    A node's value stays in `memo` until its last parent has read it."""
    if memo is None:
        memo = {}
    return _eval_dev(expr, ctx, memo, _parent_counts(expr))


def _eval_dev(expr: Expr, ctx: DeviceEvalContext, memo: dict, uses: Counter):
    key = id(expr)
    if key not in memo:
        memo[key] = _eval_node(expr, ctx, memo, uses)
    uses[key] -= 1
    return memo[key] if uses[key] > 0 else memo.pop(key)


def _eval_node(expr: Expr, ctx: DeviceEvalContext, memo: dict, uses: Counter):
    F = ctx.F
    dev = next(iter(ctx.columns.values())).device

    def sub(e):
        return _eval_dev(e, ctx, memo, uses)

    if isinstance(expr, Literal):
        return F.const_mont(expr.value, (1,), device=dev)
    if isinstance(expr, Cell):
        base = ctx.columns[expr.col]
        return base if expr.row == CURR else ctx.shifted(base)
    if isinstance(expr, Challenge):
        v = ctx.challenges[expr.name]
        return v if torch.is_tensor(v) else F.const_mont(v, (1,), device=dev)
    if isinstance(expr, NamedConstant):
        val = ctx.endo if expr.name == "endo" else ctx.mds[expr.args[0]][expr.args[1]]
        return F.const_mont(val, (1,), device=dev)
    if isinstance(expr, Add):
        return limb.add(F, sub(expr.a), sub(expr.b))
    if isinstance(expr, Sub):
        return limb.sub(F, sub(expr.a), sub(expr.b))
    if isinstance(expr, Mul):
        return limb.mont_mul(F, sub(expr.a), sub(expr.b))
    if isinstance(expr, Pow):
        base = sub(expr.a)
        e = expr.e
        # square-and-multiply over the static exponent
        acc = None
        sq = base
        while e:
            if e & 1:
                acc = sq if acc is None else limb.mont_mul(F, acc, sq)
            e >>= 1
            if e:
                sq = limb.mont_sqr(F, sq)
        return acc if acc is not None else F.one_mont((1,), device=dev)
    if isinstance(expr, VanishesOnZeroKnowledgeAndPreviousRows):
        assert ctx.vanishes_on_zk_and_previous is not None
        return ctx.vanishes_on_zk_and_previous
    if isinstance(expr, UnnormalizedLagrangeBasis):
        i = expr.offset + (ctx.domain_n - ctx.zk_rows if expr.zk_anchored else 0)
        i %= ctx.domain_n
        assert ctx.unnormalized_lagrange is not None and i in ctx.unnormalized_lagrange
        return ctx.unnormalized_lagrange[i]
    raise TypeError(f"unknown expr node {type(expr)}")
