"""Matplotlib visualization hooks — the Makie closures of the reference
examples (examples/simple_bilevel.jl:38-54, robust_avoid_simple.jl:119-165),
plus the TikZ DAG emitter (four_player_matrix_game.jl:487-595).

matplotlib is optional; importing this module without it raises only when a
plot function is called."""

from __future__ import annotations

import time
from typing import Optional

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def poly_vertices_2d(A, b, x):
    """Vertices of {z : A(z−x)+b ≥ 0} by edge-pair intersection, sorted by
    angle (robust_avoid_simple.jl:95-117)."""
    V = []
    m = len(b)
    for i in range(m):
        for j in range(i + 1, m):
            Mm = A[[i, j], :]
            mm = b[[i, j]] - Mm @ x
            try:
                v = -np.linalg.solve(Mm, mm)
            except np.linalg.LinAlgError:
                continue
            if np.all(A @ (v - x) + b >= -1e-4):
                V.append(v)
    if not V:
        return []
    c = np.mean(V, axis=0)
    ang = [np.arctan2(v[1] - c[1], v[0] - c[0]) for v in V]
    order = np.argsort(ang)[::-1]
    return [V[i] for i in order]


def visualize_simple_bilevel(theta, save_path: Optional[str] = None):
    """examples/simple_bilevel.jl:38-54: leader target w (green), follower
    point (x, y) (blue), the feasible kink set as black lines."""
    plt = _plt()
    f, ax = plt.subplots(figsize=(6, 6))
    ax.set_xlim(-4, 4)
    ax.set_ylim(-3, 5)
    w = theta[:2]
    x, y = theta[2], theta[3]
    ax.plot([-5, 0.0], [0.0, 0.0], color="black", lw=4)
    ax.plot([0.0, 5.0], [0.0, 5.0], color="black", lw=4)
    ax.scatter([w[0]], [w[1]], color="green", s=150)
    ax.scatter([x], [y], color="blue", s=150)
    path = save_path or f"{int(time.time()*1e3) % 100000}.png"
    f.savefig(path)
    plt.close(f)
    return path


def visualize_robust_avoid_simple(Ae, be, Aos, bos, theta,
                                  save_path: Optional[str] = None):
    """robust_avoid_simple.jl:119-165: ego polytope (blue, thin=initial,
    thick=moved), obstacles (colored), ϵ-inflated outlines (dashed)."""
    plt = _plt()
    f, ax = plt.subplots(figsize=(8, 6))
    ax.set_xlim(-7, 15)
    ax.set_ylim(-4, 18)
    num_obj = len(Aos)
    Xe = theta[0:2]
    Xo = [theta[2 + 2 * i: 4 + 2 * i] for i in range(num_obj)]
    Ue = theta[(1 + num_obj) * 2: (1 + num_obj) * 2 + 2]
    Uo = [theta[(2 + num_obj) * 2 + 2 * i: (2 + num_obj) * 2 + 2 * (i + 1)]
          for i in range(num_obj)]
    eps = theta[len(theta) - num_obj:]

    def draw(A, b, x, **kw):
        V = poly_vertices_2d(A, b, np.asarray(x))
        if V:
            V = V + [V[0]]
            ax.plot([v[0] for v in V], [v[1] for v in V], **kw)

    draw(Ae, be, Xe, color="blue")
    draw(Ae, be, Xe + Ue, color="blue", lw=3)
    colors = ["red", "orange", "purple", "yellow"]
    for i in range(num_obj):
        c = colors[i % len(colors)]
        draw(Aos[i], bos[i], Xo[i], color=c)
        draw(Aos[i], bos[i], Xo[i] + Uo[i], color=c, lw=3)
        draw(Ae, be + eps[i], Xe + Ue, color=c, ls="--", lw=2)
        draw(Aos[i], bos[i] + eps[i], Xo[i] + Uo[i], color=c, ls="--", lw=2)
    path = save_path or f"{int(time.time()*1e3) % 100000}.png"
    f.savefig(path)
    plt.close(f)
    return path


def tikz_graph(qpn, idx: int = 0) -> str:
    """TikZ DAG figure source for a QPNet (four_player_matrix_game.jl:487-595's
    emitter, generalized to any node count)."""
    D = qpn.num_levels()
    locs = {}
    for k in range(1, D + 1):
        nodes = sorted(qpn.network_depth_map[k])
        shift = -(len(nodes) - 1) / 2.0
        for i, v in enumerate(nodes):
            locs[v] = (shift + i, -(k - 1))
    lines = [f"\\expandafter\\newcommand\\csname graph{idx}\\endcsname{{%",
             "\\begin{tikzpicture}[scale=0.5,"
             "baseline=(current bounding box.center)]"]
    for v, (xx, yy) in sorted(locs.items()):
        style = "circle,draw,fill=yellow!70" if v == 1 else "circle, draw"
        lines.append(f"\\node[{style}] ({v}) at ({xx},{yy}) {{}};")
    edges = " ".join(f"({a}) -> ({b});"
                     for a in sorted(qpn.network_edges)
                     for b in sorted(qpn.network_edges[a]))
    lines.append(f"\\graph {{{edges}}};")
    lines.append("\\end{tikzpicture}")
    lines.append("}")
    return "\n".join(lines)


def visualize_four_player_constellations(constellations, x_overlay=None,
                                         save_path: Optional[str] = None,
                                         seed: int = 0):
    """four_player_matrix_game.jl:33-95: each node i's target constellation —
    its own anchor point plus, for every other node j, the point it wants j
    offset to (anchor + constellations[i][j]), joined by a thin line.
    ``x_overlay`` = iterable of (edge_list, x) pairs: each solved 8-vector is
    scattered as 4 points (one marker per node) in a fresh random color."""
    plt = _plt()
    f, ax = plt.subplots(figsize=(7, 6))
    ax.set_xlim(-2.1, 2.1)
    ax.set_ylim(-1.1, 3.1)
    ax.set_aspect("equal")
    ax.grid(False)
    colors = ["blue", "red", "green", "orange"]
    markers = ["^", ">", "v", "<"]
    for i in range(1, 5):
        anchor = np.asarray(constellations[i][i], dtype=float)
        ax.scatter(*anchor, color=colors[i - 1], marker=markers[i - 1], s=90)
        for j in range(1, 5):
            if j == i:
                continue
            off = np.asarray(constellations[i][j], dtype=float)
            stop = anchor + off
            ax.scatter(*stop, color=colors[i - 1], marker=markers[j - 1],
                       s=90)
            # trim 0.2 from each end of the connector (jl:52-57)
            ln = float(np.linalg.norm(off))
            frac = min(0.2 / max(ln, 1e-9), 0.5)
            a = (1 - frac) * anchor + frac * stop
            b = frac * anchor + (1 - frac) * stop
            ax.plot([a[0], b[0]], [a[1], b[1]], color=colors[i - 1], lw=1)
    if x_overlay is not None:
        rng = np.random.default_rng(seed)
        for edge_list, x in x_overlay:
            if x is None:
                continue
            c = rng.random(3)
            x = np.asarray(x, dtype=float)
            for k in range(4):
                ax.scatter(x[2 * k], x[2 * k + 1], color=c,
                           marker=markers[k], s=90)
    for i in range(4):
        ax.plot([], [], color=colors[i], lw=1,
                label=f"Target constellation for node {i + 1}")
        ax.scatter([], [], color="black", marker=markers[i],
                   label=f"Decision variables indexed by $J^{i + 1}$")
    ax.legend(loc="upper left", fontsize=7)
    if save_path:
        f.savefig(save_path, dpi=120, bbox_inches="tight")
    plt.close(f)
    return f
