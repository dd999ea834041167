"""Pretty printers / debug display — the reference's ``src/printing.jl``
(the port's copy of ``qpn_tpu/printing.py``; numpy only).

Aligned sparse-style matrix rendering for Poly / PolyUnion / Quadratic / QP,
plus ``display_debug`` (printing.jl:1-15).  (The reference's LabeledPoly
printer has a latent typo bug at printing.jl:24 — ``spsce`` — not replicated.)
"""

from __future__ import annotations

import io
import numpy as np

from .geometry.poly import Poly, PolyUnion
from .network import QP, Quadratic, QPNet


def _fmt(v, width=9, digits=4):
    if not np.isfinite(v):
        s = "∞" if v > 0 else "-∞"
    elif abs(v) < 1e-12:
        s = "·"
    else:
        s = f"{v:.{digits}g}"
    return s.rjust(width)


def format_poly(p: Poly, max_rows: int = 40) -> str:
    """Aligned ``l ⋈ a'x ⋈ u`` rows (printing.jl:114-146)."""
    out = io.StringIO()
    out.write(f"Poly in R^{p.dim} with {p.m} slices:\n")
    for i in range(min(p.m, max_rows)):
        lo = "<" if p.strict_l[i] else "≤"
        hi = "<" if p.strict_u[i] else "≤"
        row = " ".join(_fmt(a) for a in p.A[i])
        out.write(f"  {_fmt(p.l[i])} {lo} [{row}] {hi} {_fmt(p.u[i])}\n")
    if p.m > max_rows:
        out.write(f"  ... ({p.m - max_rows} more rows)\n")
    return out.getvalue()


def format_poly_union(pu: PolyUnion, max_polys: int = 10) -> str:
    out = io.StringIO()
    out.write(f"PolyUnion with {len(pu)} pieces:\n")
    for i, p in enumerate(pu):
        if i >= max_polys:
            out.write(f"... ({len(pu) - max_polys} more pieces)\n")
            break
        out.write(format_poly(p))
    return out.getvalue()


def format_labeled_poly(p: Poly, labels=None, max_rows: int = 500,
                        indent: int = 0) -> str:
    """Aligned H-rep rendering with variable-name column headers — the
    reference's LabeledPoly printer (printing.jl:17-112): names truncated to
    4 chars over their columns, rows in lexicographic order with equalities
    first, ``⋅`` for structural zeros, strictness markers on each bound.

    ``labels`` maps name -> variable index (the GAVI label dict layout,
    avi.jl:216-249 / create_labeled_gavi_from_qp)."""
    from .geometry.poly import get_lexico_ordering

    sp = " " * indent
    out = io.StringIO()
    out.write(f"{sp}Polyhedron in R^{p.dim} with {p.m} constraints.\n")
    if p.m > max_rows or p.dim > max_rows:
        return out.getvalue()
    order = np.asarray(get_lexico_ordering(p.A), dtype=int)
    eq = np.isclose(p.l[order], p.u[order], atol=1e-6)
    order = np.concatenate([order[eq], order[~eq]])
    if labels:
        rev = {ind: name for name, ind in labels.items() if ind < p.dim}
        hdr = "".join(f"{rev.get(j, '')[:4]:^10}" for j in range(p.dim))
        out.write(f"{sp}{'':14}{hdr}\n")
    half = (len(order) + 1) // 2
    for e, i in enumerate(order):
        lo = "<" if p.strict_l[i] else "≤"
        hi = "<" if p.strict_u[i] else "≤"
        row = "".join("    ·     " if abs(a) < 1e-12 else f"{a:^10.2f}"
                      for a in p.A[i])
        mid = "| x" if e + 1 == half else "|  "
        out.write(f"{sp}{_fmt(p.l[i])} {lo} |{row}{mid} {hi} "
                  f"{_fmt(p.u[i])}\n")
    return out.getvalue()


def format_intersection_tree(pus, red_lengths=None, indent: int = 0) -> str:
    """The reference's IntersectionRoot/IntersectionNode tree printer
    (printing.jl:148-169): root line with the potential leaf count, then the
    per-depth contributing polys nested two spaces per level.  Our lazy tree
    is the level-synchronous generator ``intersection_iter``; its factor
    unions ARE the children lists the reference's nodes hold."""
    sp = " " * indent
    out = io.StringIO()
    potential = 1
    for pu in pus:
        potential *= max(len(pu), 1)
    out.write(f"{sp}Intersection root with {potential} potential polys\n")
    for depth, pu in enumerate(pus):
        pad = indent + 2 * (depth + 1)
        red = (f" ({red_lengths[depth]} complement)"
               if red_lengths is not None else "")
        out.write(f"{' ' * pad}depth {depth}: {len(pu)} contributing "
                  f"polys{red}\n")
        for p in pu:
            body = format_poly(p, max_rows=6).rstrip("\n")
            for line in body.split("\n"):
                out.write(f"{' ' * (pad + 2)}{line}\n")
    return out.getvalue()


def format_quadratic(f: Quadratic, names=None) -> str:
    """½x'Qx + q'x + k rendering (printing.jl:179-217)."""
    n = f.Q.shape[0]
    names = names or [f"x{i}" for i in range(n)]
    terms = []
    for i in range(n):
        for j in range(i, n):
            # f(x) = ½x'Qx: the x_i·x_j (i≠j) coefficient is
            # ½(Q_ij + Q_ji), NOT their raw sum — the printed polynomial
            # must evaluate to f
            c = f.Q[i, j] if i == j else f.Q[i, j] + f.Q[j, i]
            coef = 0.5 * c
            if abs(coef) > 1e-12:
                var = f"{names[i]}²" if i == j else f"{names[i]}·{names[j]}"
                terms.append(f"{coef:+.4g} {var}")
    for i in range(n):
        if abs(f.q[i]) > 1e-12:
            terms.append(f"{f.q[i]:+.4g} {names[i]}")
    if abs(f.k) > 1e-12:
        terms.append(f"{f.k:+.4g}")
    return " ".join(terms) if terms else "0"


def format_qp(qp: QP, names=None) -> str:
    out = io.StringIO()
    out.write("QP:\n")
    out.write(f"  cost: {format_quadratic(qp.f, names)}\n")
    out.write(f"  constraint ids: {qp.constraint_indices}\n")
    out.write(f"  private vars: {qp.var_indices}\n")
    return out.getvalue()


def display_debug(qpn: QPNet, level: int, iters: int, pieces=None) -> None:
    """printing.jl:1-15: one-line progress banner per iteration."""
    msg = f"[qpn] level {level} iteration {iters}"
    if pieces is not None:
        msg += f" — {pieces} solution-graph pieces"
    print(msg)


# register as __str__ helpers (non-invasive)
def install_reprs() -> None:
    Poly.__str__ = lambda self: format_poly(self)          # type: ignore
    PolyUnion.__str__ = lambda self: format_poly_union(self)  # type: ignore
    Quadratic.__str__ = lambda self: format_quadratic(self)  # type: ignore
    QP.__str__ = lambda self: format_qp(self)              # type: ignore
