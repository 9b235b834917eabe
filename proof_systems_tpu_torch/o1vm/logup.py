"""LogUp: lookups via logarithmic derivatives (msm/src/logup.rs,
o1vm/src/pickles/lookup_{prover,verifier}.rs).

Counterpart of proof_systems_tpu/o1vm/logup.py. The host code is the JAX
package's, copied as it is (the same dict orders and the same Python
inverses); the packed columns go to the device the caller names (the card
unless device="cpu") and prove through o1vm/pickles.prove_columns.

Protocol (eprint 2022/1530, PlonK-quotient variant — logup.rs:14-100):
(a_i) is included in table (b_i) with multiplicities m iff

    sum_j  1/(beta + f_j(w^i))  ==  sum_i  m(w^i)/(beta + t(w^i)).

Per row the "inner sum" h = sum_j 1/(beta+f_j) - m/(beta+t) is folded
into a running accumulator phi with phi(w^{i+1}) = phi(w^i) + h(w^i);
the cyclic telescoping over H forces sum h = 0 without any boundary
constraint. The constraint is degree-cleared (logup.rs eq. (5)):

  (phi_next - phi_curr) * (beta+t) * prod_j (beta+f_j)
    == (beta+t) * sum_j prod_{i!=j} (beta+f_i)  -  m * prod_j (beta+f_j)

beta is squeezed AFTER committing f, t, m (two-phase prove_columns);
phi is the only beta-dependent column.

Multiplicity counting, phi and the h columns are host setup per proof;
limb.batch_inverse and a prefix sum are the path that would move them to
the device. Where the JAX package takes a Python inverse a lookup and walks
each slot's expressions once a row, the port inverts a column's
denominators together (Montgomery's trick: one inverse, three products an
element) and evaluates each expression once over numpy arrays of Python
integers that hold every row: the same integers, mod p.
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from ..circuits import expr as E
from ..runtime import resolve_device
from .pickles import col, pinned_columns_match


def range_table(bits: int, n: int) -> list[int]:
    """[0, 2^bits) range-check table padded with zeros to n rows."""
    assert (1 << bits) <= n
    return list(range(1 << bits)) + [0] * (n - (1 << bits))


def multiplicities(lookups: list[list[int]], table: list[int], p: int) -> list[int]:
    """m[i] = how many times table[i] is looked up. Duplicate table
    entries (zero padding) carry the count on their first occurrence."""
    counts = Counter(v % p for row in lookups for v in row)
    first: dict[int, int] = {}
    for i, t in enumerate(table):
        first.setdefault(t % p, i)
    m = [0] * len(table)
    for v, c in counts.items():
        if v not in first:
            raise ValueError(f"looked-up value {v} not in table")
        m[first[v]] += c
    return m


def inverses(values: list[int], p: int) -> list[int]:
    """[pow(v, -1, p) for v in values], for values reduced mod p, by one
    inverse and three products an element (Montgomery's trick); a zero
    raises as pow does."""
    if 0 in values:
        raise ValueError("base is not invertible for the given modulus")
    prefix = [1] * (len(values) + 1)
    for i, v in enumerate(values):
        prefix[i + 1] = prefix[i] * v % p
    inv = pow(prefix[-1], -1, p)
    out = [0] * len(values)
    for i in range(len(values) - 1, -1, -1):
        out[i] = prefix[i] * inv % p
        inv = inv * values[i] % p
    return out


def phi_column(
    lookups: list[list[int]], table: list[int], m: list[int], beta: int, p: int
) -> list[int]:
    """The running aggregator: phi[0] = 0, phi[i+1] = phi[i] + h[i];
    wraps to zero exactly when the lookup relation holds."""
    n = len(table)
    inv = iter(inverses([(beta + v) % p for i in range(n) for v in [*lookups[i], table[i]]], p))
    phi = [0] * n
    acc = 0
    for i in range(n):
        h = 0
        for _ in lookups[i]:
            h += next(inv)
        h -= m[i] * next(inv)
        phi[i] = acc
        acc = (acc + h) % p
    if acc != 0:
        raise ValueError("logup relation does not hold: phi does not wrap to 0")
    return phi


def logup_constraint(k: int, f_idx: list[int], t_idx: int, m_idx: int, phi_idx: int) -> E.Expr:
    """The cleared-denominator constraint over column indices (logup.rs
    eq. (5)); degree k + 2."""
    beta = E.Challenge("beta")
    f = [beta + E.Cell(col(i), E.CURR) for i in f_idx]
    t = beta + E.Cell(col(t_idx), E.CURR)
    m = E.Cell(col(m_idx), E.CURR)
    phi = E.Cell(col(phi_idx), E.CURR)
    phi_next = E.Cell(col(phi_idx), E.NEXT)

    prod_f: E.Expr = E.Literal(1)
    for fj in f:
        prod_f = prod_f * fj
    sum_partials: E.Expr = E.Literal(0)
    for j in range(k):
        part: E.Expr = E.Literal(1)
        for i in range(k):
            if i != j:
                part = part * f[i]
        sum_partials = sum_partials + part
    return (phi_next - phi) * t * prod_f - (t * sum_partials - m * prod_f)


class LogupInstance:
    """Bundle: lookup columns + table + multiplicities, ready for the
    two-phase column prover. Column order: [f_1..f_k, t, m, | phi]."""

    def __init__(self, f_field, lookups: list[list[int]], table: list[int]):
        self.f = f_field
        p = f_field.p
        self.k = len(lookups[0])
        assert all(len(r) == self.k for r in lookups)
        self.lookups = [[v % p for v in row] for row in lookups]
        self.table = [t % p for t in table]
        self.m = multiplicities(self.lookups, self.table, p)

    def phase1_columns(self) -> list[list[int]]:
        fcols = [[row[j] for row in self.lookups] for j in range(self.k)]
        return fcols + [self.table, self.m]

    def make_beta_columns(self, F, device=None):
        dev = resolve_device(device)

        def build(beta: int):
            phi = phi_column(self.lookups, self.table, self.m, beta, self.f.p)
            return F.pack_mont(phi, shape=(1, len(phi)), device=dev)

        return build

    def constraint(self) -> E.Expr:
        k = self.k
        return logup_constraint(k, list(range(k)), k, k + 1, k + 2)

    def prove(self, domain, srs, curve, rng, device=None):
        """On `device`: the card unless the caller passes device="cpu"."""
        from ..ops import limb
        from .pickles import prove_columns

        F = limb.device_field(curve.scalar)
        dev = resolve_device(device)
        cols = self.phase1_columns()
        n = len(self.table)
        packed = F.pack_mont([v for c in cols for v in c], shape=(len(cols), n), device=dev)
        return prove_columns(
            domain, srs, curve, packed, [self.constraint()], rng,
            make_beta_columns=self.make_beta_columns(F, dev), device=dev,
        )

    def verify(self, domain, srs, curve, proof, rng) -> bool:
        from .pickles import verify_columns

        return verify_columns(
            domain, srs, curve, [self.constraint()], proof, rng, num_beta_columns=1
        )


# ---------------------------------------------------------------------------
# Signed multi-table LogUp (msm/src/logup.rs, o1vm/src/ramlookup.rs).
#
# Generalizes LogupInstance to the full zkVM lookup environment:
#   - many tables (fixed range/byte/bitwise tables AND dynamic RAM
#     tables), identified by a table_id folded into the denominator,
#   - vector-valued lookups combined with a joint combiner j squeezed
#     before beta (logup.rs:646-649): key = table_id + sum_i j^{i+1} v_i,
#   - SIGNED numerators (write +1, read -1 — ramlookup.rs:46-51), which
#     is what makes the offline memory-checking argument work,
#   - per-row slot lists chunked into h partial-sum columns of at most
#     CHUNK slots (logup.rs:462-468 MAX_SUPPORTED_DEGREE - 2) plus one
#     phi aggregation column with phi(wX) - phi(X) = sum_i h_i(X);
#     cyclic telescoping forces the global signed sum to zero.
#
# Column layout appended after the caller's C trace columns:
#   phase 1:  [table components + multiplicity col per fixed table]
#   phase 2:  [h_0 .. h_{H-1}, phi]
# Fixed-table component columns are committed with the trace; the
# VERIFIER independently recommits the known tables and compares
# (verify_tables), pinning them — the reference keeps these commitments
# in its setup for the same reason.
# ---------------------------------------------------------------------------


# Rows of a slot whose looked-up values all fit in int64 are compared as
# int64 arrays; larger field elements (a RAM address near p) stay Python
# ints and take the dict.
_I64 = 1 << 62


def _as_int64(vals: list[np.ndarray]):
    """The (rows, k) int64 matrix of the columns `vals` (int64 or object
    arrays) when every value is in [0, 2^62), else None."""
    out = np.empty((len(vals[0]) if vals else 0, len(vals)), dtype=np.int64)
    for j, v in enumerate(vals):
        if v.dtype != np.int64 and v.size and not bool(np.all((v >= 0) & (v < _I64))):
            return None
        out[:, j] = v
    return out


def _unique_rows(mat: np.ndarray):
    """(distinct rows of the int64 matrix, each row's index into them), by
    one lexicographic sort (np.unique with an axis sorts a byte view, many
    times slower)."""
    if not len(mat) or not mat.shape[1]:  # no rows, or every row the empty tuple
        return mat[:1], np.zeros(len(mat), dtype=np.int64)
    order = np.lexsort(mat.T[::-1])
    ordered = mat[order]
    new = np.ones(len(mat), dtype=bool)
    new[1:] = np.any(ordered[1:] != ordered[:-1], axis=1)
    group = np.cumsum(new) - 1
    inverse = np.empty(len(mat), dtype=np.int64)
    inverse[order] = group
    return ordered[new], inverse


def _distinct(vals: list[np.ndarray]):
    """The distinct value tuples of the columns `vals` (int64 or object
    arrays of equal length): (their int64 matrix or None, else their tuples
    of Python ints, each row's index into them)."""
    mat = _as_int64(vals)
    if mat is not None:
        keys, inverse = _unique_rows(mat)
        return keys, None, inverse
    at: dict[tuple, int] = {}
    inverse = np.empty(len(vals[0]) if vals else 0, dtype=np.int64)
    for i in range(len(inverse)):
        inverse[i] = at.setdefault(tuple(int(v[i]) for v in vals), len(at))
    return None, list(at), inverse


class _TableIndex:
    """Where each tuple of a padded fixed table first occurs (the table's
    dict of tuple -> first row), and a vectorised `find` of many tuples:
    -1 where a tuple is not in the table."""

    def __init__(self, comp: list[list[int]], p: int):
        self.first: dict[tuple, int] = {}
        for i, key in enumerate(zip(*(map(lambda x: x % p, c) for c in comp))):
            self.first.setdefault(key, i)
        keys = list(self.first)
        self.dense = None
        if all(0 <= x < _I64 for key in keys for x in key):
            mat = np.array(keys, dtype=np.int64).reshape(len(keys), len(comp))
            self.radix = mat.max(axis=0) + 1
            size = int(np.prod(self.radix.astype(object)))
            if size <= 1 << 24:
                self.dense = np.full(size, -1, dtype=np.int64)
                self.dense[self._code(mat)] = list(self.first.values())

    def _code(self, mat: np.ndarray) -> np.ndarray:
        code = np.zeros(len(mat), dtype=np.int64)
        for j in range(mat.shape[1]):
            code = code * self.radix[j] + mat[:, j]
        return code

    def find(self, vals: list[np.ndarray]) -> np.ndarray:
        rows = len(vals[0]) if vals else 0
        mat = _as_int64(vals) if self.dense is not None else None
        if mat is None:
            return np.array([self.first.get(tuple(v[i] for v in vals), -1)
                             for i in range(rows)], dtype=np.int64)
        inside = np.all(mat < self.radix, axis=1)
        out = np.full(rows, -1, dtype=np.int64)
        out[inside] = self.dense[self._code(mat[inside])]
        return out


class _Counts:
    """Multiplicities of one table: signed numerators summed by table row
    (int64 while they are small, Python ints beside), read mod p."""

    def __init__(self, n: int, p: int):
        self.p = p
        self.small = np.zeros(n, dtype=np.int64)
        self.big = np.zeros(n, dtype=object)

    def add(self, at: np.ndarray, nums: np.ndarray) -> None:
        if not nums.size:
            return
        if bool(np.all(nums == 1)):
            self.small += np.bincount(at, minlength=len(self.small))
            return
        if nums.dtype == np.int64:  # _fast_rows' values: in [0, 2^62)
            signed = nums
        else:
            signed = np.where(nums > self.p // 2, nums - self.p, nums)
        if bool(np.all((signed > -(1 << 31)) & (signed < 1 << 31))):
            np.add.at(self.small, at, signed.astype(np.int64))
        else:
            np.add.at(self.big, at, nums.astype(object))

    def values(self) -> list[int]:
        return ((self.small.astype(object) + self.big) % self.p).tolist()

CHUNK = 6  # slots per h column (MAX_SUPPORTED_DEGREE - 2, logup.rs:462)


class FixedTable:
    """A fixed lookup table: `columns` is a list of component columns
    (width w), each of length <= n (padded with its last entry's zeros
    implied — entries beyond len are all-zero rows whose multiplicity
    lands on the first all-zero entry if looked up)."""

    def __init__(self, table_id: int, name: str, columns: list[list[int]]):
        assert columns and all(len(c) == len(columns[0]) for c in columns)
        self.table_id = table_id
        self.name = name
        self.columns = columns
        self.width = len(columns)
        self.length = len(columns[0])


def range_table_fixed(table_id: int, bits: int) -> FixedTable:
    return FixedTable(table_id, f"range{bits}", [list(range(1 << bits))])


BITWISE_AND, BITWISE_OR, BITWISE_XOR, BITWISE_NOR = 0, 1, 2, 3


def bitwise_table(table_id: int, bits: int = 4) -> FixedTable:
    """(op, x, y, z) for all `bits`-wide x,y and op in {AND,OR,XOR,NOR}:
    4·4^bits entries (the reference amortizes with ByteLookup + sparse
    tricks; a chunk product table is the flat version).
    bits=4 (1024 entries) for production, bits=2 (64) for small test
    domains."""
    mask = (1 << bits) - 1
    ops, xs, ys, zs = [], [], [], []
    for op, fn in (
        (BITWISE_AND, lambda a, b: a & b),
        (BITWISE_OR, lambda a, b: a | b),
        (BITWISE_XOR, lambda a, b: a ^ b),
        (BITWISE_NOR, lambda a, b: mask - (a | b)),
    ):
        for x in range(1 << bits):
            for y in range(1 << bits):
                ops.append(op)
                xs.append(x)
                ys.append(y)
                zs.append(fn(x, y))
    return FixedTable(table_id, f"bitwise{bits}", [ops, xs, ys, zs])


class LookupSpec:
    """Constraint-side description of one lookup slot: `numerator` is
    the signed magnitude expression (deg <= 2), `values` the vector of
    looked-up component expressions (each deg <= 1 so the denominator
    stays degree 1 — logup.rs:376-379)."""

    def __init__(self, table_id: int, numerator: E.Expr, values: list[E.Expr]):
        self.table_id = table_id
        self.numerator = numerator
        self.values = values


class MultiLogup:
    """Bundle the slot specs + fixed tables into phase-1/phase-2 column
    builders and constraints for the two-phase column prover
    (pickles.prove_columns with with_joint_combiner=True)."""

    def __init__(self, f_field, specs: list[LookupSpec], tables: list[FixedTable], n: int, trace_cols: int):
        self.f = f_field
        self.n = n
        self.C = trace_cols
        self.tables = tables
        for t in tables:
            assert t.length <= n, f"table {t.name} ({t.length}) exceeds domain {n}"
        # phase-1 extra column indices
        idx = trace_cols
        self.table_col: dict[int, list[int]] = {}
        self.m_col: dict[int, int] = {}
        for t in tables:
            self.table_col[t.table_id] = [idx + i for i in range(t.width)]
            idx += t.width
            self.m_col[t.table_id] = idx
            idx += 1
        self.phase1_end = idx
        # full slot list: caller specs then one -m slot per fixed table
        self.specs = list(specs)
        for t in tables:
            self.specs.append(
                LookupSpec(
                    t.table_id,
                    E.Literal(0) - E.Cell(col(self.m_col[t.table_id]), E.CURR),
                    [E.Cell(col(c), E.CURR) for c in self.table_col[t.table_id]],
                )
            )
        self.nchunks = -(-len(self.specs) // CHUNK)
        self.h_cols = [idx + i for i in range(self.nchunks)]
        self.phi_col = idx + self.nchunks
        self.num_phase2 = self.nchunks + 1

    # -- constraint side ----------------------------------------------------

    def _denominator(self, spec: LookupSpec) -> E.Expr:
        j = E.Challenge("joint_combiner")
        combined: E.Expr = E.Literal(0)
        for v in reversed(spec.values):
            combined = combined * j + v
        return E.Challenge("beta") + combined * j + E.Literal(spec.table_id)

    def constraints(self) -> list[E.Expr]:
        out = []
        for ci in range(self.nchunks):
            chunk = self.specs[ci * CHUNK : (ci + 1) * CHUNK]
            dens = [self._denominator(s) for s in chunk]
            lhs: E.Expr = E.Cell(col(self.h_cols[ci]), E.CURR)
            for d in dens:
                lhs = lhs * d
            rhs: E.Expr = E.Literal(0)
            for i, s in enumerate(chunk):
                term: E.Expr = s.numerator
                for k, d in enumerate(dens):
                    if k != i:
                        term = term * d
                rhs = rhs + term
            out.append(lhs - rhs)
        phi = E.Cell(col(self.phi_col), E.CURR)
        phi_next = E.Cell(col(self.phi_col), E.NEXT)
        agg = phi_next - phi
        for hc in self.h_cols:
            agg = agg - E.Cell(col(hc), E.CURR)
        out.append(agg)
        return out

    # -- witness side (host exact ints; traces are short relative to the
    #    kimchi prover's hot loops — device batch-inversion is the
    #    documented scale-up path, ops/limb.batch_inverse) --------------

    def _eval_rows(self, expr: E.Expr, cols: list[list[int]], cache: dict) -> np.ndarray:
        """Evaluate a (deg-bounded) expr at every row; NEXT wraps; the value
        mod p of each row, as eval_host gives it. A literal, a cell or a
        literal times a cell whose values all lie in [0, 2^62) is an int64
        array (_fast_rows); anything else is one eval_host walk over numpy
        object arrays of every row's cells, Python integers all through (the
        lookup expressions have no Pow node, which an array could not take).
        `cache` keeps a column's rows, rotated by a cell's row offset, across
        the calls of one phase."""
        from ..circuits.expr import HostEvalContext, eval_host

        n = self.n
        fast = self._fast_rows(expr, cols, cache)
        if fast is not None:
            return fast

        def get_cell(c, row):
            if ("obj", c[1], row) not in cache:
                colv, r = cols[c[1]], row % n
                cache["obj", c[1], row] = np.array(colv[r:] + colv[:r], dtype=object)
            return cache["obj", c[1], row]

        ctx = HostEvalContext(
            f=self.f,
            get_cell=get_cell,
            challenges={},
            endo=0,
            mds=[],
            point=0,
            domain_n=n,
            omega=0,
            zk_rows=0,
        )
        return np.broadcast_to(np.asarray(eval_host(expr, ctx), dtype=object), (n,))

    def _fast_rows(self, expr: E.Expr, cols: list[list[int]], cache: dict):
        """_eval_rows' int64 path, or None: values in [0, 2^62) are below p
        and equal their residues."""
        if isinstance(expr, E.Literal):
            v = expr.value % self.f.p
            return np.full(self.n, v, dtype=np.int64) if v < _I64 else None
        if isinstance(expr, E.Cell):
            c, row = expr.col[1], expr.row % self.n
            if ("i64", c, row) not in cache:
                base = cache.get(("i64", c, 0))
                if ("i64", c, 0) not in cache:
                    try:
                        base = np.array(cols[c], dtype=np.int64)
                    except OverflowError:
                        base = None
                    if base is not None and base.size and not (base.min() >= 0 and
                                                               base.max() < _I64):
                        base = None
                    cache["i64", c, 0] = base
                cache["i64", c, row] = None if base is None else np.roll(base, -row)
            return cache["i64", c, row]
        if isinstance(expr, E.Mul):
            lit, cell = expr.a, expr.b
            if isinstance(cell, E.Literal):
                lit, cell = cell, lit
            if isinstance(lit, E.Literal) and isinstance(cell, E.Cell):
                k = lit.value % self.f.p
                arr = self._fast_rows(cell, cols, cache)
                if arr is not None and (not arr.size or int(arr.max()) * k < _I64):
                    return arr * k
        return None

    def phase1_columns(self, trace_cols: list[list[int]]) -> list[list[int]]:
        """Given the C trace columns, append padded table components and
        multiplicity columns. Multiplicities are counted from the
        caller-spec lookups (raw tuples, before joint combination): each
        slot's looked-up rows are found in the table by one gather
        (_TableIndex), and the counts are summed by table row, mod p."""
        n = self.n
        p = self.f.p
        assert len(trace_cols) == self.C
        cols = [list(c) for c in trace_cols]
        index: dict[int, _TableIndex] = {}
        for t in self.tables:
            comp = [c + [0] * (n - t.length) for c in t.columns]
            cols.extend(comp)
            index[t.table_id] = _TableIndex(comp, p)
            cols.append([0] * n)  # m, filled below
        counts = {t.table_id: _Counts(n, p) for t in self.tables}
        ncaller = len(self.specs) - len(self.tables)
        cache: dict = {}
        for s in self.specs[:ncaller]:
            if s.table_id not in index:
                continue  # RAM table: balances against its own writes
            nums = self._eval_rows(s.numerator, cols, cache)
            vals = [self._eval_rows(v, cols, cache) for v in s.values]
            live = np.flatnonzero(nums != 0)
            at = index[s.table_id].find([v[live] for v in vals])
            missing = np.flatnonzero(at < 0)
            if missing.size:
                i = int(live[missing[0]])
                key = tuple(int(v[i]) for v in vals)
                raise ValueError(f"lookup {key} not in table {s.table_id} (row {i})")
            counts[s.table_id].add(at, nums[live])
        for t in self.tables:
            cols[self.m_col[t.table_id]] = counts[t.table_id].values()
        self._cols_phase1 = cols
        return cols

    def phase2_host(self, beta: int, joint: int) -> list[list[int]]:
        """h chunk columns + phi given the squeezed challenges (host
        exact). Raises if the global signed sum is nonzero (the lookup
        relation does not hold).

        A slot's term num / (beta + combined * joint + table_id) depends only
        on its numerator and its looked-up tuple: the denominators of the
        distinct (table id, tuple) of all slots are inverted together once
        (`inverses`), each slot's distinct (numerator, denominator) pairs
        give its terms, and an h column, or a row's sum of them, is summed
        once for each distinct pattern of terms, then gathered to the rows."""
        p = self.f.p
        n = self.n
        cols = self._cols_phase1
        cache: dict = {}
        found = []  # (live rows, their numerators, distinct tuples, each row's tuple)
        for s in self.specs:
            nums = self._eval_rows(s.numerator, cols, cache)
            live = np.flatnonzero(nums != 0)
            mat, keys, key_of = _distinct([self._eval_rows(v, cols, cache)[live]
                                           for v in s.values])
            found.append((s.table_id, live, nums[live], mat, keys, key_of))
        # the distinct (table id, tuple) of all slots, one denominator each
        width = max((len(s.values) for s in self.specs), default=1)
        if all(f[3] is not None for f in found):
            tagged = np.zeros((sum(len(f[3]) for f in found), 1 + width), dtype=np.int64)
            off = 0
            for tid, _, _, mat, _, _ in found:
                tagged[off : off + len(mat), 0] = tid
                tagged[off : off + len(mat), 1 : 1 + mat.shape[1]] = mat
                off += len(mat)
            distinct, den_of = _unique_rows(tagged)
            # a narrower tuple's zero padding adds nothing to its combination
            distinct = [(row[0], row[1:]) for row in distinct.tolist()]
        else:
            at: dict[tuple, int] = {}
            den_of = np.array([at.setdefault((f[0], key), len(at))
                               for f in found for key in (f[4] if f[4] is not None else
                                                          [tuple(r) for r in f[3].tolist()])],
                              dtype=np.int64)
            distinct = list(at)
        dens = []
        for tid, key in distinct:
            combined = 0
            for v in reversed(key):
                combined = (combined * joint + v) % p
            dens.append((beta + combined * joint + tid) % p)
        inv = inverses(dens, p)  # a zero raises, as pow does
        slots = []  # (live rows, each live row's term, terms)
        off = 0
        for _, live, nums, mat, keys, key_of in found:
            count = len(mat) if mat is not None else len(keys)
            pos = den_of[off : off + count]
            off += count
            if nums.dtype == np.int64 and bool(np.all(nums == 1)):  # one term a tuple
                slots.append((live, key_of, [inv[b] for b in pos.tolist()]))
                continue
            num_mat, num_keys, num_of = _distinct([nums])
            num_vals = num_mat[:, 0].tolist() if num_mat is not None else [k[0] for k in num_keys]
            pairs, pair_of = _unique_rows(np.stack([num_of, pos[key_of]], 1))
            slots.append((live, pair_of, [num_vals[a] * inv[b] % p for a, b in pairs.tolist()]))
        h_sums, h_of = [], np.zeros((n, self.nchunks), dtype=np.int64)
        for ci in range(self.nchunks):
            chunk = slots[ci * CHUNK : (ci + 1) * CHUNK]
            terms, pattern = [0], np.zeros((n, len(chunk)), dtype=np.int64)
            for c, (live, term_of, slot_terms) in enumerate(chunk):
                pattern[live, c] = len(terms) + term_of
                terms += slot_terms
            rows, h_of[:, ci] = _unique_rows(pattern)
            h_sums.append(np.array([sum(terms[t] for t in row) % p for row in rows.tolist()],
                                   dtype=object))
        # a row's sum of the h columns: the columns of few distinct values by
        # their patterns together, the others row by row
        few = [ci for ci in range(self.nchunks) if 4 * len(h_sums[ci]) <= n]
        rows, total_of = _unique_rows(h_of[:, few])
        totals = np.array([sum(h_sums[ci][t] for ci, t in zip(few, row))
                           for row in rows.tolist()], dtype=object)[total_of]
        for ci in range(self.nchunks):
            if ci not in few:
                totals = totals + h_sums[ci][h_of[:, ci]]
        acc = np.cumsum(totals) % p
        if acc[-1] != 0:
            raise ValueError("logup relation does not hold: phi != 0 wrap")
        phi = np.concatenate([np.zeros(1, dtype=object), acc[:-1]])
        return [h_sums[ci][h_of[:, ci]].tolist() for ci in range(self.nchunks)] + [phi.tolist()]

    def make_phase2(self, F, device=None):
        """-> callable(beta, joint) returning packed (8, H+1, n) on `device`
        (the card unless device="cpu")."""
        dev = resolve_device(device)

        def build(beta: int, joint: int):
            cols2 = self.phase2_host(beta, joint)
            flat = [v for hc in cols2 for v in hc]
            return F.pack_mont(flat, shape=(self.num_phase2, self.n), device=dev)

        return build

    # -- verifier-side table pinning -----------------------------------

    def verify_tables(self, domain, srs, proof) -> bool:
        """Recommit every padded fixed-table component column and check
        the proof's phase-1 commitments at the table offsets match.
        Fixed tables are public — a prover substituting its own 'table'
        must be caught here (the reference pins them via precomputed
        setup commitments). Trace commitments are hiding but table
        commitments are committed with the same +H blinder=1 mask, so we
        reproduce it exactly. The commit runs on the SRS's device."""
        pinned = {}
        for t in self.tables:
            for w, c in enumerate(t.columns):
                pinned[self.table_col[t.table_id][w]] = list(c) + [0] * (self.n - t.length)
        return pinned_columns_match(domain, srs, proof, pinned, srs.device)
