"""QP-Network model: players, shared constraints, DAG structure.

Re-implements the reference's network layer (src/programs.jl) — ``QP`` /
``Constraint`` / ``QEP`` / ``QPNet`` containers, transitive-reduction DAG
processing with cycle detection (programs.jl:214-242), the depth map
(programs.jl:249-269), constraint dual-sharing groups (programs.jl:293-310)
and the index helpers (programs.jl:330-363) — on dense numpy data.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Set

import numpy as np

from .geometry.poly import Poly
from .options import QPNetOptions, set_options


class Linear:
    """Callable linear functional — the request currency (programs.jl:1-14)."""

    __slots__ = ("a",)

    def __init__(self, a):
        self.a = np.asarray(a, dtype=np.float64)

    def __call__(self, x):
        return float(self.a @ np.asarray(x))

    def __eq__(self, other):
        return isinstance(other, Linear) and np.array_equal(self.a, other.a)

    def __hash__(self):
        return hash(("Linear", self.a.tobytes()))


class Quadratic:
    """f(x) = ½ x'Qx + q'x + k (programs.jl:16-28)."""

    __slots__ = ("Q", "q", "k")

    def __init__(self, Q, q, k=0.0):
        self.Q = np.asarray(Q, dtype=np.float64)
        self.q = np.asarray(q, dtype=np.float64)
        self.k = float(k)

    def __call__(self, x):
        x = np.asarray(x, dtype=np.float64)
        return float(0.5 * x @ (self.Q @ x) + x @ self.q + self.k)

    def __add__(self, other):
        return Quadratic(self.Q + other.Q, self.q + other.q, self.k + other.k)

    @staticmethod
    def sum(fs: Sequence["Quadratic"]) -> "Quadratic":
        out = fs[0]
        for f in fs[1:]:
            out = out + f
        return out


@dataclasses.dataclass
class QP:  # programs.jl:30-34
    f: Quadratic
    constraint_indices: List[int]
    var_indices: List[int]


@dataclasses.dataclass
class Constraint:  # programs.jl:43-46
    poly: Poly
    group_mapping: Dict[int, int]


@dataclasses.dataclass
class QEP:  # programs.jl:48-51
    qps: Dict[int, QP]
    constraints: Dict[int, Constraint]


class QPNet:
    """The network (programs.jl:79-116).  Construct via the frontend
    (``qpn_tpu_torch.frontend.QPNetBuilder`` / ``variables``) or directly."""

    def __init__(self, num_vars: int, variable_names: Optional[List[str]] = None):
        self.qps: Dict[int, QP] = {}
        self.constraints: Dict[int, Constraint] = {}
        self.network_edges: Dict[int, Set[int]] = {}
        self.reachable_nodes: Dict[int, Set[int]] = {}
        self.network_depth_map: Dict[int, Set[int]] = {}
        self.options = QPNetOptions()
        self.num_vars = num_vars
        self.variable_names = variable_names or [f"x_{i}" for i in range(num_vars)]
        self.problem_data: Dict = {}
        self.iterate_cache: Dict[int, List[np.ndarray]] = {}
        self.visualization_function: Callable = lambda x: None
        self.default_initialization = np.zeros(num_vars)
        self.metrics = None  # attached by algorithm.solve

    # -- construction ------------------------------------------------------
    def add_constraint(self, A, lb, ub) -> int:
        """Add a shared polyhedral constraint from numeric data
        (the symbolic extraction lives in frontend.py; programs.jl:147-170)."""
        A = np.asarray(A, dtype=np.float64)
        if A.ndim == 1:
            A = A[None, :]
        if A.shape[1] != self.num_vars:
            raise ValueError(
                f"constraint matrix has {A.shape[1]} columns but the "
                f"network has {self.num_vars} variables")
        poly = Poly(A, np.asarray(lb, dtype=np.float64),
                    np.asarray(ub, dtype=np.float64))
        cid = max(self.constraints.keys(), default=0) + 1
        self.constraints[cid] = Constraint(poly, {})
        return cid

    def add_qp(self, f: Quadratic, con_inds: Sequence[int],
               var_indices: Sequence[int]) -> int:
        """Register a player with cost f, shared-constraint ids, and private
        variable indices (programs.jl:172-201)."""
        pid = max(self.qps.keys(), default=0) + 1
        self.qps[pid] = QP(f, list(con_inds), list(var_indices))
        return pid

    def add_edges(self, edge_list) -> None:  # programs.jl:274-285
        N = len(self.qps)
        A, R = create_minimal_adj_matrix(N, edge_list)
        depth_map = create_depth_map(R)
        self.network_depth_map = {d: set(nodes) for d, nodes in depth_map.items()}
        for i in range(1, N + 1):
            self.network_edges[i] = {j + 1 for j in range(N) if A[i - 1, j]}
            self.reachable_nodes[i] = {j + 1 for j in range(N) if R[i - 1, j]}

    def assign_constraint_groups(self, group_map=None) -> None:
        """Dual-sharing groups (programs.jl:293-310)."""
        group_map = group_map or {}
        for con_id, constraint in self.constraints.items():
            for player_id, qp in self.qps.items():
                if con_id in qp.constraint_indices:
                    if con_id in group_map:
                        if player_id not in group_map[con_id]:
                            raise ValueError(
                                f"group map for constraint {con_id} missing "
                                f"player {player_id}")
                        gid = group_map[con_id][player_id]
                    else:
                        gid = player_id
                    constraint.group_mapping[player_id] = gid

    def set_options(self, **kwargs) -> None:
        set_options(self.options, **kwargs)

    # -- pickling ----------------------------------------------------------
    def __getstate__(self):
        """Pickle support for process-parallel ensembles
        (parallel/procpool.py): model setups commonly attach setup-local
        lambdas as ``visualization_function`` (the reference does the same,
        e.g. examples/simple_bilevel.jl's visualize closure) — presentation
        hooks, not solve inputs, so an unpicklable one is dropped rather
        than poisoning the whole network."""
        import pickle
        state = dict(self.__dict__)
        for key in ("visualization_function",):
            try:
                pickle.dumps(state[key])
            except Exception:
                state[key] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        if self.visualization_function is None:
            self.visualization_function = lambda x: None

    # -- structure queries -------------------------------------------------
    def num_levels(self) -> int:  # programs.jl:330-332
        return len(self.network_depth_map)

    def gather(self, level: int) -> QEP:  # programs.jl:334-338
        qps = {i: self.qps[i] for i in self.network_depth_map[level]}
        constraints = {cid: self.constraints[cid]
                       for qp in qps.values() for cid in qp.constraint_indices}
        return QEP(qps, constraints)

    def decision_inds(self, pid: int) -> List[int]:  # programs.jl:340-346
        inds = set(self.qps[pid].var_indices)
        for i in self.reachable_nodes[pid]:
            inds.update(self.qps[i].var_indices)
        return sorted(inds)

    def fair_obj(self, level: int) -> Quadratic:  # programs.jl:352-354
        return Quadratic.sum([self.qps[i].f
                              for i in self.network_depth_map[level]])

    def level_indices(self, level: int) -> List[int]:  # programs.jl:356-358
        return [v for i in self.network_depth_map[level]
                for v in self.qps[i].var_indices]

    def sub_indices(self, level: int) -> List[int]:  # programs.jl:360-363
        L = self.num_levels()
        return [v for lv in range(level + 1, L + 1)
                for i in self.network_depth_map[lv]
                for v in self.qps[i].var_indices]

    # -- warm start --------------------------------------------------------
    def flatten(self) -> "QPNet":  # programs.jl:118-125
        qpnf = copy.deepcopy(self)
        qpnf.network_edges.clear()
        qpnf.reachable_nodes.clear()
        qpnf.network_depth_map.clear()
        qpnf.add_edges([])
        return qpnf

    def get_flat_initialization(self, x0=None):  # programs.jl:127-132
        from .algorithm import solve
        qpn_flat = self.flatten()
        qpn_flat.options.gen_solution_map = False
        if x0 is None:
            x0 = np.zeros(self.num_vars)
        ret = solve(qpn_flat, x0)
        return ret.x_opt

    def display_solution(self, x) -> None:  # programs.jl:322-328
        for i, name in enumerate(self.variable_names):
            print(f"({i}) {name} => {x[i]}")


# --------------------------------------------------------------------------
#  DAG processing (programs.jl:214-269).  1-based node ids like the reference.
# --------------------------------------------------------------------------

def create_minimal_adj_matrix(N: int, edge_list):
    """Transitive reduction via boolean matrix powers; errors on self-edges
    and cycles (programs.jl:214-242)."""
    A = np.zeros((N, N), dtype=bool)
    for (i, j) in edge_list:
        if i == j:
            raise ValueError(f"Cannot have self edges. (node {i} -> {i})")
        # node ids are 1-based (matching the reference); a 0 or negative id
        # would silently wrap through Python negative indexing and corrupt
        # the DAG
        if not (1 <= i <= N and 1 <= j <= N):
            raise ValueError(
                f"Edge ({i}, {j}) references a node outside 1..{N} "
                "(node ids are 1-based)")
        A[i - 1, j - 1] = True
    R = np.zeros((N, N), dtype=bool)
    An = A.copy()
    for n in range(2, N + 1):
        R |= An
        An = (An.astype(int) @ A.astype(int)) > 0
        for i in range(N):
            if An[i, i]:
                raise ValueError(
                    f"Cycle detected (node {i + 1} -> {i + 1} after {n} "
                    "transitions)")
            for j in range(N):
                if A[i, j] and An[i, j]:
                    A[i, j] = False
    return A, R


def create_depth_map(R: np.ndarray) -> Dict[int, Set[int]]:
    """Peel nodes with no incoming reachability (programs.jl:249-269)."""
    depth_map: Dict[int, Set[int]] = {}
    N = R.shape[0]
    deleted: Set[int] = set()
    d = 0
    Rd = R.copy()
    while len(deleted) < N:
        nodes = {i + 1 for i in range(N) if not Rd[:, i].any()} - deleted
        if not nodes:
            raise RuntimeError(
                "Something appears wrong with the graph structure.")
        d += 1
        depth_map[d] = nodes
        deleted |= nodes
        remaining = [i for i in range(N) if (i + 1) not in deleted]
        Rd = R[remaining, :] if remaining else np.zeros((0, N), dtype=bool)
    if N and depth_map[1]:
        covered = np.zeros(N, dtype=bool)
        for i in depth_map[1]:
            covered |= R[i - 1, :]
        assert covered.sum() == N - len(depth_map[1])
    return depth_map
