"""Four-player constellation game (examples/four_player_matrix_game.jl).

Each player i controls xᵢ ∈ ℝ² in a box and minimizes distances to a private
"constellation" layout over all players; 48 canonical DAGs over the 4 nodes
turn the same costs into Nash / bilevel / trilevel structures.  Includes the
equilibrium cross-check research harness (search_for_game /
analyze_equilibria) from examples/four_player_matrix_game.jl:179-385.

RNG note: constellations are seeded with numpy Generator streams, so numeric
values differ from Julia's MersenneTwister for the same seed (the harness
logic — not golden values — is the parity target here).
"""

from __future__ import annotations

import itertools
import logging
from typing import List, Tuple

import numpy as np

from ..frontend import QPNetBuilder, variables, _lift
from . import register

logger = logging.getLogger("qpn_tpu_torch")


@register("four_player_matrix_game")
def setup(edge_list=(), seed: int = 2, **kwargs):
    rng = np.random.default_rng(seed)
    xs = {i: variables(f"x{i}", 2) for i in range(1, 5)}
    b = QPNetBuilder(xs[1], xs[2], xs[3], xs[4])

    constellations = {i: {j: rng.standard_normal(2) for j in range(1, 5)}
                      for i in range(1, 5)}

    for i in range(1, 5):
        cid = b.add_constraint([xs[i][0], xs[i][1]],
                               5 * np.array([-1.0, -1.0]),
                               5 * np.array([1.0, 1.0]))
        cost = _lift(0.0)
        for j in range(1, 5):
            if j == i:
                d = [xs[i][k] - constellations[i][j][k] for k in range(2)]
            else:
                d = [xs[j][k] - xs[i][k] - constellations[i][j][k]
                     for k in range(2)]
            for k in range(2):
                cost = cost + d[k] * d[k]
        b.add_qp(cost, [cid], xs[i])

    b.add_edges(list(edge_list))
    b.assign_constraint_groups()
    b.set_options(**kwargs)
    b.net.default_initialization = np.zeros(8)
    b.net.problem_data["constellations"] = constellations
    return b.net


# --------------------------------------------------------------------------
#  research harnesses (examples/four_player_matrix_game.jl:179-484)
# --------------------------------------------------------------------------

_PERMS = [  # the label symmetries fixing node 1 (jl:388-393)
    {1: 1, 2: 3, 3: 4, 4: 2},
    {1: 1, 2: 2, 3: 4, 4: 3},
    {1: 1, 2: 3, 3: 2, 4: 4},
    {1: 1, 2: 4, 3: 3, 4: 2},
    {1: 1, 2: 4, 3: 2, 4: 3},
    {1: 1, 2: 2, 3: 3, 4: 4},
]


def graph_is_redundant(edge_list, existing) -> bool:
    for perm in _PERMS:
        el = frozenset((perm[a], perm[b]) for (a, b) in edge_list)
        if el in existing:
            return True
    return False


def compute_unique_edge_lists(max_edges: int = None
                              ) -> List[List[Tuple[int, int]]]:
    """Enumerate canonical DAG edge lists over 4 nodes up to the node-label
    symmetries (the computational path of jl:403-484; the reference
    short-circuits to a precomputed table of 48).  ``max_edges`` bounds the
    powerset rank for cheap smoke runs."""
    all_edges = [(1, 2), (1, 3), (1, 4), (2, 3), (2, 4), (2, 1), (3, 1),
                 (3, 2), (3, 4), (4, 1), (4, 2), (4, 3)]
    unique: List[frozenset] = []
    out: List[List[Tuple[int, int]]] = []
    top = len(all_edges) if max_edges is None else max_edges
    # only the adjacency reduction is needed per subset — building a full
    # QPNet (8 JAX jacobian/hessian extractions) for each of the 4096
    # combos would be thousands of times slower
    from ..network import create_minimal_adj_matrix
    for r in range(top + 1):
        for combo in itertools.combinations(all_edges, r):
            try:
                A, _ = create_minimal_adj_matrix(4, list(combo))
            except ValueError:
                continue            # cyclic subset
            small = frozenset((i + 1, j + 1) for i in range(4)
                              for j in range(4) if A[i, j])
            if graph_is_redundant(small, unique):
                continue
            unique.append(small)
            out.append(sorted(small))
    return out


def search_for_game(seed_range, solve_fn=None, max_edges=None):
    """Cross-validate equilibria across DAGs (jl:179-248): for each seed,
    solve every unique DAG and count the DAGs that admit NO foreign
    equilibrium (len(equilibria[i]) == 1 — the reference's row-wise
    criterion, jl:61-65)."""
    from ..algorithm import solve as _solve
    solve_fn = solve_fn or _solve
    edge_lists = compute_unique_edge_lists(max_edges)
    best = (None, -1)
    for seed in seed_range:
        x_opts = []
        for el in edge_lists:
            net = setup(edge_list=el, seed=seed)
            ret = solve_fn(net, np.zeros(8))
            x_opts.append(np.asarray(ret.x_opt) if ret.solved else None)
        if any(x is None for x in x_opts):
            logger.info("%s => failed", seed)
            continue
        equilibria = {i: [i] for i in range(len(x_opts))}
        for i, el in enumerate(edge_lists):
            net = setup(edge_list=el, seed=seed)
            for j, xj in enumerate(x_opts):
                if i == j:
                    continue
                ret = solve_fn(net, xj)
                if ret.solved and np.allclose(ret.x_opt, xj, atol=1e-6):
                    equilibria[i].append(j)
        n_unique = sum(len(v) == 1 for v in equilibria.values())
        logger.info("%s => %s", seed, [len(equilibria[i])
                                       for i in range(len(x_opts))])
        if n_unique > best[1]:
            best = (seed, n_unique)
    return best


def analyze_equilibria(seed_range, solve_fn=None, max_edges=None):
    """Monte-Carlo running mean/variance of player costs per DAG
    (jl:270-385), relative to the Nash (empty-DAG) equilibrium."""
    from ..algorithm import solve as _solve
    solve_fn = solve_fn or _solve
    edge_lists = compute_unique_edge_lists(max_edges)
    E = len(edge_lists)
    num_success = 0
    avg = np.zeros((4, E))
    m2 = np.zeros((4, E))
    # materialize once: a generator would be exhausted by the loop and the
    # pct denominator below would silently become 0
    seed_range = list(seed_range)
    for seed in seed_range:
        x_opts = []
        for el in edge_lists:
            net = setup(edge_list=el, seed=seed)
            ret = solve_fn(net, np.zeros(8))
            x_opts.append(np.asarray(ret.x_opt) if ret.solved else None)
        if any(x is None for x in x_opts):
            logger.info("Bad seed: %s", seed)
            continue
        num_success += 1
        net = setup(seed=seed)
        x_nash = x_opts[0]
        for e, (x, el) in enumerate(zip(x_opts, edge_lists)):
            for i in range(1, 5):
                f = net.qps[i].f(x)
                if el:
                    f -= net.qps[i].f(x_nash)
                delta = f - avg[i - 1, e]
                avg[i - 1, e] += delta / num_success
                m2[i - 1, e] += delta * (f - avg[i - 1, e])
    return dict(edge_lists=edge_lists, avg_costs=avg, m2_costs=m2,
                num_success=num_success,
                pct=100.0 * num_success / max(len(seed_range), 1))


def vis_equilibria(seed: int = 495, solve_fn=None, max_edges=None,
                   save_path=None):
    """Solve every unique DAG at one seed and plot the equilibria over the
    target constellations (jl:250-267 — the reference stops at the
    constellation figure; the overlay line is commented out there, enabled
    here)."""
    from ..algorithm import solve as _solve
    from .viz import visualize_four_player_constellations
    solve_fn = solve_fn or _solve
    edge_lists = compute_unique_edge_lists(max_edges)
    overlay = []
    for el in edge_lists:
        net = setup(edge_list=el, seed=seed)
        try:
            ret = solve_fn(net, np.zeros(8))
            overlay.append((el, np.asarray(ret.x_opt) if ret.solved
                            else None))
        except (RuntimeError, ValueError):
            overlay.append((el, None))
    net = setup(seed=seed)
    fig = visualize_four_player_constellations(
        net.problem_data["constellations"], x_overlay=overlay,
        save_path=save_path, seed=seed)
    return dict(edge_lists=edge_lists, overlay=overlay, figure=fig)
