"""Circuit visualization (tools/kimchi-visu capability).

Renders a ConstraintSystem (+ optional witness) as a standalone HTML
page: one row per gate with type, coefficients, permutation wiring
(cells that are wired away from themselves are highlighted and show
their cycle target), and witness values. Also provides a plain-text
dump for terminals.
"""

from __future__ import annotations

import html
from typing import Optional

PERMUTS = 7
COLUMNS = 15

_CSS = """
body { font-family: monospace; background: #fafafa; }
table { border-collapse: collapse; }
td, th { border: 1px solid #ccc; padding: 2px 6px; font-size: 12px; }
th { background: #eee; }
.gate { font-weight: bold; }
.wired { background: #ffe9a8; }
.zero { color: #bbb; }
"""


def _short(v: int, p: int) -> str:
    if v == 0:
        return "0"
    if v < 1 << 32:
        return str(v)
    if p - v < 1 << 32:
        return f"-{p - v}"
    h = f"{v:064x}"
    return f"{h[:6]}..{h[-4:]}"


def visualize(cs, witness: Optional[list[list[int]]] = None) -> str:
    """Return an HTML page for the circuit (kimchi-visu/src/lib.rs:visu)."""
    p = cs.f.p
    rows = []
    header = (
        "<tr><th>row</th><th>gate</th>"
        + "".join(f"<th>w{i}</th>" for i in range(COLUMNS))
        + "<th>coeffs</th></tr>"
    )
    for r, gate in enumerate(cs.gates):
        cells = []
        for c in range(COLUMNS):
            klass = ""
            txt = ""
            if witness is not None and r < len(witness[0]):
                v = witness[c][r]
                txt = _short(v, p)
                if v == 0:
                    klass = "zero"
            if c < PERMUTS:
                w = gate.wires[c]
                if (w.row, w.col) != (r, c):
                    klass = "wired"
                    txt += f" →({w.row},{w.col})"
            cells.append(f'<td class="{klass}">{html.escape(txt)}</td>')
        coeffs = ", ".join(_short(v % p, p) for v in gate.coeffs) or "—"
        rows.append(
            f'<tr><td>{r}</td><td class="gate">{gate.typ.name}</td>'
            + "".join(cells)
            + f"<td>{html.escape(coeffs)}</td></tr>"
        )
    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<style>{_CSS}</style></head><body>"
        f"<h2>circuit: {len(cs.gates)} gates, domain 2^{cs.domain.d1.n.bit_length() - 1}"
        f", zk_rows {cs.zk_rows}, public {cs.public}</h2>"
        f"<table>{header}{''.join(rows)}</table></body></html>"
    )


def witness_text(cs, witness: list[list[int]], max_rows: int = 64) -> str:
    """Terminal-friendly dump (kimchi-visu witness table)."""
    p = cs.f.p
    out = []
    nrows = min(len(cs.gates), max_rows)
    for r in range(nrows):
        vals = " ".join(f"{_short(witness[c][r], p):>10}" for c in range(COLUMNS))
        out.append(f"{r:4} {cs.gates[r].typ.name:<16} {vals}")
    if len(cs.gates) > max_rows:
        out.append(f"... ({len(cs.gates) - max_rows} more rows)")
    return "\n".join(out)
