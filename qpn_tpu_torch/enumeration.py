"""Solution-map enumeration: complementarity recipes → polyhedral pieces
(copy of ``qpn_tpu/enumeration.py``; numpy host code over the port's
geometry layer).

Re-implements ``src/avi_solutions.jl``: at a GAVI solution (z, w), classify
every complementarity row into its admissible piece labels (``comp_indices``,
avi_solutions.jl:498-612), expand the cartesian product of labels into
``PolyRecipe`` assignments (``all_Ks``, avi_solutions.jl:200-215), materialize
each recipe as one polyhedral piece of the solution map (``local_piece``,
avi_solutions.jl:390-496), and explore outward through piece vertices
(``LocalGAVISolutions``, avi_solutions.jl:92-382).

Design decisions (the JAX package's):

* A recipe is a flat ``tuple[int]`` label assignment (one label 1–8 per row)
  instead of a Dict{Int,Set{Int}} — hashable, and trivially batchable as an
  int tensor.
* ``expand`` over a whole frontier of recipes materializes pieces on host and
  batches ALL their emptiness LPs into one batched call
  (the reference expands pieces one OSQP/cdd call at a time).
* Projection to x-space goes through equality elimination + Fourier–Motzkin
  (geometry/project.py) — no cdd.
* Vertex exploration samples vertices by batched random-objective LPs
  (geometry/vertices.py) under the same ``max_vertices`` budget.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from .geometry import setops, vertices
from .geometry import project as _gproject_mod  # noqa: F401
from .geometry.project import project as project_poly, permute_columns
from .geometry.poly import Poly
from .network import Linear
from .ops.avi import GAVI
from .utils.metrics import METRICS

Recipe = Tuple[int, ...]          # label per complementarity row (1..8)

_QDIGITS = 5                      # QuantizedVector digits (avi_solutions.jl:23)
_MAX_RECIPES_PER_POINT = 1024     # guard on 2^#weak-rows blowup


def quantize(v) -> Tuple[float, ...]:
    return tuple(np.round(np.asarray(v, dtype=np.float64), _QDIGITS) + 0.0)


# --------------------------------------------------------------------------
#  comp_indices — avi_solutions.jl:498-612
# --------------------------------------------------------------------------

def _block_labels(r, z, l, u, tol):
    """Label options for one complementarity block (labels 1..4):
    1: z=l, r≥0 | 2: l≤z≤u, r=0 | 3: z=u, r≤0 | 4: l=z=u (doubly bound)."""
    n = len(z)
    lc = np.where(np.isfinite(l), l, -np.inf)
    uc = np.where(np.isfinite(u), u, np.inf)
    equal_bounds = np.isclose(lc, uc, atol=tol)
    riszero = np.isclose(r, 0.0, atol=tol)
    J: List[Set[int]] = []
    for i in range(n):
        Ji: Set[int] = set()
        if np.isfinite(l[i]) and np.isclose(z[i], l[i], atol=tol) \
                and r[i] >= -tol and not equal_bounds[i]:
            Ji.add(1)
        if (l[i] - tol <= z[i] <= u[i] + tol) and riszero[i] \
                and not equal_bounds[i]:
            Ji.add(2)
        if np.isfinite(u[i]) and np.isclose(z[i], u[i], atol=tol) \
                and r[i] <= tol and not equal_bounds[i]:
            Ji.add(3)
        if not Ji:
            assert equal_bounds[i], (
                f"comp_indices: row {i} matches no label "
                f"(z={z[i]}, r={r[i]}, l={l[i]}, u={u[i]})")
            Ji.add(4)
        J.append(Ji)
    return J


def _grant_requests(J, rows_zdir, rows_rdir, l, u, permuted_request, tol=1e-6):
    """Request-granted extra labels (avi_solutions.jl:522-541): if a request
    direction matches ±(z-increase) or ±(r-increase) row direction, the
    corresponding boundary label becomes admissible.

    Faithfulness notes: the reference maps (a1, a2, −a2, −a1) to labels
    (2, 1, 3, 2) — BOTH z-directions grant the interior label 2, which is
    intentional there, not a duplicate; and its lexico normalization of the
    directions is a no-op (``a1 ./ n`` is computed but never assigned,
    avi_solutions.jl:524-531), so directions compare unnormalized here too.
    """
    if not permuted_request:
        return J
    reqs = [np.asarray(req.a, dtype=np.float64) for req in permuted_request]
    for i in range(len(J)):
        a1 = -rows_zdir[i]          # direction that increases z_i
        a2 = -rows_rdir[i]          # direction that increases r_i
        for a, j, b in ((a1, 2, 0.0), (a2, 1, l[i]), (-a2, 3, u[i]),
                        (-a1, 2, 0.0)):
            if np.isfinite(b) and any(
                    np.allclose(a, r, atol=tol) for r in reqs):
                J[i].add(j)
    return J


def comp_indices(gavi: GAVI, z, w, permuted_request=(), tol: float = 1e-2):
    """Admissible labels per row of the GAVI at (z, w)
    (avi_solutions.jl:568-612).  Block-1 rows get labels ⊆ {1..4}; block-2
    rows labels ⊆ {5..8}.  Returns a list of label sets, one per row."""
    z = np.asarray(z, dtype=np.float64)
    w = np.asarray(w, dtype=np.float64)
    d1, d2 = gavi.d1, gavi.d2
    assert len(z) == d1 + d2
    r1 = gavi.M @ z + gavi.N @ w + gavi.o
    z1 = z[:d1]
    J1 = _block_labels(r1, z1, gavi.l1, gavi.u1, tol)
    if permuted_request:
        # direction matrices over [z; w] must match the rows of
        # local_piece — the coordinates propagate_request reads its
        # directions from: ∇z1 = [I 0 0], ∇r1 = [M N] (NOT [M 0]: requests
        # built from constraint/objective rows that couple to parameters
        # would silently never match)
        I1 = np.hstack([np.eye(d1), np.zeros((d1, d2 + len(w)))])
        MB1 = np.hstack([gavi.M, gavi.N])
        J1 = _grant_requests(J1, I1, MB1, gavi.l1, gavi.u1, permuted_request)

    r2 = z[d1:]
    s2 = gavi.A @ z + gavi.B @ w
    J2 = _block_labels(r2, s2, gavi.l2, gavi.u2, tol)
    if permuted_request:
        # ∇s2 = [A B], ∇r2 = ∇z2 = [0 I 0] (NOT [0 I B])
        AB = np.hstack([gavi.A, gavi.B])
        M2B = np.hstack([np.zeros((d2, d1)), np.eye(d2),
                         np.zeros((d2, len(w)))])
        J2 = _grant_requests(J2, AB, M2B, gavi.l2, gavi.u2, permuted_request)
    return J1 + [set(x + 4 for x in Ji) for Ji in J2]


def all_Ks(J) -> Set[Recipe]:
    """Cartesian product of label choices (avi_solutions.jl:200-215).

    The expansion runs in the native C++ host kernel
    (utils/native.recipe_product)."""
    count = 1
    for Ji in J:
        count *= len(Ji)
        if count > _MAX_RECIPES_PER_POINT:
            # no silent caps: dropped tail recipes mean the local solution
            # map under-covers — say so, don't just bump a counter
            METRICS.bump("recipes_capped")
            import logging
            logging.getLogger(__name__).warning(
                "all_Ks: %d label combinations exceed the %d-recipe cap; "
                "tail recipes dropped — the local solution map may "
                "under-cover (raise qpn_tpu_torch.enumeration."
                "_MAX_RECIPES_PER_POINT to lift)", count,
                _MAX_RECIPES_PER_POINT)
            break
    from .utils import native
    arr = native.recipe_product(J, _MAX_RECIPES_PER_POINT)
    return set(map(tuple, arr.tolist()))


def max_freedom_K(J) -> Recipe:
    """Pick the single recipe granting the most freedom per row.

    NOTE: the reference calls ``max_freedom_K`` (avi_solutions.jl:151) but
    never defines it — the high-dimension flow is dead code upstream.  We
    define it as: prefer the weak/equality labels (2, 6) that leave z in the
    interior, then 1/5, 3/7, then the doubly-bound 4/8."""
    pref = [2, 6, 1, 5, 3, 7, 4, 8]
    out = []
    for Ji in J:
        for p in pref:
            if p in Ji:
                out.append(p)
                break
        else:
            out.append(sorted(Ji)[0])
    return tuple(out)


# --------------------------------------------------------------------------
#  local_piece — avi_solutions.jl:390-496
# --------------------------------------------------------------------------

def local_piece(gavi: GAVI, n: int, m: int, K: Recipe,
                reducible_inds: Sequence[int] = ()) -> Tuple[Poly, List[int]]:
    """Materialize one recipe as a Poly over (z, w).

    Row layout (avi_solutions.jl:400-408)::

        [ M  N ]   d1 rows   — r1 value
        [ I2 0 ]   d2 rows   — r2 = z2 value
        [ I1 0 ]   d1 rows   — z1 value
        [ A  B ]   d2 rows   — s2 value

    with bounds per label from the table at avi_solutions.jl:390-399.
    ``reducible_inds`` (non-decision z coords) triggers the iterative
    singleton-equality substitution of avi_solutions.jl:441-491 (used by the
    high-dimension flow; the main enumeration passes none)."""
    d1, d2 = gavi.d1, gavi.d2
    assert n == d1 + d2
    I1 = np.hstack([np.eye(d1), np.zeros((d1, d2))])
    I2 = np.hstack([np.zeros((d2, d1)), np.eye(d2)])
    A_big = np.vstack([
        np.hstack([gavi.M, gavi.N]),
        np.hstack([I2, np.zeros((d2, m))]),
        np.hstack([I1, np.zeros((d1, m))]),
        np.hstack([gavi.A, gavi.B]),
    ])
    inf = np.inf
    bounds = np.zeros((n, 4))
    for i in range(n):
        k = K[i]
        if k == 1:
            row = (-gavi.o[i], inf, gavi.l1[i], gavi.l1[i])
        elif k == 2:
            row = (-gavi.o[i], -gavi.o[i], gavi.l1[i], gavi.u1[i])
        elif k == 3:
            row = (-inf, -gavi.o[i], gavi.u1[i], gavi.u1[i])
        elif k == 4:
            row = (-inf, inf, gavi.l1[i], gavi.u1[i])
        elif k == 5:
            row = (0.0, inf, gavi.l2[i - d1], gavi.l2[i - d1])
        elif k == 6:
            row = (0.0, 0.0, gavi.l2[i - d1], gavi.u2[i - d1])
        elif k == 7:
            row = (-inf, 0.0, gavi.u2[i - d1], gavi.u2[i - d1])
        elif k == 8:
            row = (-inf, inf, gavi.l2[i - d1], gavi.u2[i - d1])
        else:  # pragma: no cover
            raise ValueError(f"bad label {k}")
        bounds[i] = row
    l = np.concatenate([bounds[:, 0], bounds[:, 2]])
    u = np.concatenate([bounds[:, 1], bounds[:, 3]])
    noisy = l > u
    l[noisy] = u[noisy]
    A_big[np.abs(A_big) < 1e-8] = 0.0

    reduced_inds: List[int] = []
    if len(reducible_inds):
        A_big, l, u, reduced_inds = _reduce_variables(
            A_big, l, u, list(reducible_inds))

    meaningful = _find_non_trivial(A_big, l, u)
    piece = Poly(A_big[meaningful], l[meaningful], u[meaningful]).simplify()
    return piece, reduced_inds


def _find_non_trivial(A, l, u):
    """Rows with a finite bound and at least one nonzero coefficient
    (avi_solutions.jl:384-388)."""
    nonzero = np.any(np.abs(A) > 0, axis=1)
    finite = np.isfinite(l) | np.isfinite(u)
    return nonzero & finite


def _reduce_variables(A, l, u, reducible_inds):
    """Iterative substitution of reducible vars pinned by singleton equality
    rows, then pruning of dangling reducibles (avi_solutions.jl:441-491)."""
    reduced_vals: Dict[int, float] = {}
    while True:
        further = False
        for i in range(A.shape[0]):
            Jrow = set(np.nonzero(np.abs(A[i]) > 1e-12)[0].tolist())
            already = Jrow & reduced_vals.keys()
            notyet = Jrow - reduced_vals.keys()
            J_red = notyet & set(reducible_inds)
            if (np.isfinite(l[i]) and np.isfinite(u[i])
                    and abs(l[i] - u[i]) < 1e-6 and len(J_red) == 1
                    and notyet == J_red):
                j = next(iter(J_red))
                reduced_vals[j] = (u[i] - sum(A[i, k] * reduced_vals[k]
                                              for k in already)) / A[i, j]
                further = True
        if not further:
            break
    reduced = sorted(reduced_vals.keys())
    notreduced = [j for j in range(A.shape[1]) if j not in reduced_vals]
    remaining_reducible = set(notreduced) & set(reducible_inds)
    while True:
        changed = False
        for j in list(remaining_reducible):
            con_list = np.nonzero(np.abs(A[:, j]) > 1e-12)[0]
            ok = all(
                set(np.nonzero(np.abs(A[i]) > 1e-12)[0].tolist())
                <= remaining_reducible for i in con_list)
            if not ok:
                remaining_reducible.discard(j)
                changed = True
        if not remaining_reducible or not changed:
            break
    if reduced:
        shift = A[:, reduced] @ np.array([reduced_vals[j] for j in reduced])
        l = l - shift
        u = u - shift
    drop = set(reduced) | remaining_reducible
    keep_cols = [j for j in range(A.shape[1]) if j not in drop]
    return A[:, keep_cols], l, u, sorted(drop)


# --------------------------------------------------------------------------
#  projection to x-space — avi_solutions.jl:79-90
# --------------------------------------------------------------------------

def project_and_permute(S: Poly, var_inds, param_inds) -> Poly:
    """Project a (z, w)-space piece onto (z1=decisions, w=params) and scatter
    the columns into the full x layout."""
    d = S.dim
    dv, dp = len(var_inds), len(param_inds)
    projection_inds = list(range(dv)) + list(range(d - dp, d))
    piece = project_poly(S, projection_inds)
    positions = list(var_inds) + list(param_inds)
    out = permute_columns(piece, positions, dv + dp)
    out.parent = S
    out.row_parents = [S] * out.m
    return out.simplify()


# --------------------------------------------------------------------------
#  LocalGAVISolutions — avi_solutions.jl:92-382
# --------------------------------------------------------------------------

class LocalGAVISolutions:
    """Lazy enumerator of solution-map pieces around a GAVI solution.

    Frontier state mirrors the reference exactly; the expansion of a frontier
    is batched (one emptiness-LP kernel call per generation)."""

    def __init__(self, gavi: GAVI, z, w, level: int, subpiece_index: int,
                 decision_inds, param_inds, request=frozenset(),
                 max_vertices: int = 2 ** 62,
                 rng: Optional[np.random.Generator] = None,
                 frontier_store=None, request_is_permuted: bool = False):
        self.gavi = gavi
        self.z = np.asarray(z, dtype=np.float64)
        self.w = np.asarray(w, dtype=np.float64)
        self.level = level
        self.subpiece_index = subpiece_index
        self.decision_inds = list(decision_inds)
        self.param_inds = list(param_inds)
        self.max_vertices = max_vertices
        self.rng = rng or np.random.default_rng(0)
        n, m = len(self.z), len(self.w)
        if request_is_permuted:
            # directions already in this GAVI's [z | w] layout — the live
            # request flow's propagate_request emits parent-poly rows, which
            # ARE (z, w) coordinates; running them through unpermute (which
            # assumes x layout, avi_solutions.jl:58-77) would scramble z/λ/w
            # columns.  The reference's dormant chain carries that latent
            # misalignment; repaired here behind an explicit flag.
            self.permuted_request = frozenset(
                req for req in request
                if np.asarray(req.a).shape[0] == n + m)
        else:
            self.permuted_request = unpermute(request, n + m,
                                              self.decision_inds,
                                              self.param_inds)
        J = comp_indices(gavi, self.z, self.w, self.permuted_request)
        self.unexplored_Ks: Set[Recipe] = all_Ks(J)
        self.explored_Ks: Set[Recipe] = set()
        self.unexplored_vertices: Set[Tuple[float, ...]] = set()
        self.explored_vertices: Set[Tuple[float, ...]] = {
            quantize(np.concatenate([self.z, self.w]))}
        self.polys: Set[Poly] = set()
        # mid-enumeration checkpointing (SURVEY §5): a killed enumeration
        # resumes its piece discovery instead of restarting from scratch
        self.frontier_store = frontier_store
        self._fkey = None
        if frontier_store is not None:
            self._fkey = self._frontier_key()
            state = frontier_store.load(self._fkey)
            if state is not None:
                self._restore_frontier(state)

    # -- frontier checkpoint/resume ---------------------------------------
    def _frontier_key(self) -> str:
        import hashlib
        h = hashlib.sha1()
        for a in (self.gavi.M, self.gavi.N, self.gavi.o, self.gavi.l1,
                  self.gavi.u1, self.gavi.A, self.gavi.B, self.gavi.l2,
                  self.gavi.u2):
            h.update(np.round(np.asarray(a, dtype=np.float64), 9).tobytes())
        h.update(np.asarray(quantize(self.z)).tobytes())
        h.update(np.asarray(quantize(self.w)).tobytes())
        h.update(bytes([self.level & 0xFF, self.subpiece_index & 0xFF]))
        # exploration settings shape the frontier: a stored frontier computed
        # under a different vertex budget or request set must not be resumed
        h.update(int(self.max_vertices).to_bytes(8, "little", signed=False))
        for req in sorted(self.permuted_request,
                          key=lambda r: tuple(np.asarray(r.a).flatten())):
            h.update(np.round(np.asarray(req.a, dtype=np.float64),
                              9).tobytes())
        return h.hexdigest()[:16]

    def frontier_state(self) -> dict:
        """Serializable snapshot of the enumeration frontier.

        Projected pieces are stored as dense H-reps; provenance parents are
        dropped (they matter only to the dormant requests flow)."""
        L = self.gavi.d1 + self.gavi.d2
        nm = len(self.z) + len(self.w)

        def karr(ks):
            return (np.array(sorted(ks), dtype=np.int32).reshape(-1, L)
                    if ks else np.zeros((0, L), dtype=np.int32))

        def varr(vs):
            return (np.array(sorted(vs), dtype=np.float64).reshape(-1, nm)
                    if vs else np.zeros((0, nm)))

        polys = []
        for p in self.polys:
            polys.append(dict(A=p.A, l=p.l, u=p.u, sl=p.strict_l,
                              su=p.strict_u))
        return dict(unexplored_Ks=karr(self.unexplored_Ks),
                    explored_Ks=karr(self.explored_Ks),
                    unexplored_vertices=varr(self.unexplored_vertices),
                    explored_vertices=varr(self.explored_vertices),
                    polys=polys)

    def _restore_frontier(self, state: dict):
        self.unexplored_Ks = {tuple(int(v) for v in row)
                              for row in state["unexplored_Ks"]}
        self.explored_Ks = {tuple(int(v) for v in row)
                            for row in state["explored_Ks"]}
        self.unexplored_vertices = {tuple(row)
                                    for row in state["unexplored_vertices"]}
        self.explored_vertices = {tuple(row)
                                  for row in state["explored_vertices"]}
        self.polys = {Poly(d["A"], d["l"], d["u"], d["sl"], d["su"],
                           normalize=False)
                      for d in state["polys"]}

    def _checkpoint(self):
        if self.frontier_store is not None:
            self.frontier_store.save(self._fkey, self.frontier_state())

    # -- expansion ---------------------------------------------------------
    def _expand_batch(self, Ks: Sequence[Recipe]):
        """Materialize+filter a batch of recipes (avi_solutions.jl:241-261),
        with the emptiness checks batched into one kernel call."""
        n, m = len(self.z), len(self.w)
        zw = np.concatenate([self.z, self.w])
        pieces = []
        for K in Ks:
            piece, _ = local_piece(self.gavi, n, m, K)
            pieces.append(piece)
        METRICS.bump("pieces_materialized", len(pieces))
        empty = setops.is_empty_batch(pieces, tol=1e-4, x=zw)
        nv = len(self.decision_inds)
        slice_spec = np.concatenate([
            self.z[:nv], np.full(n - nv, np.nan), self.w])
        survivors = []
        sliced_list = []
        for K, piece, emp in zip(Ks, pieces, empty):
            if emp:
                METRICS.bump("pieces_empty")
                continue
            wants_verts = (self.max_vertices > len(self.explored_vertices)
                           and piece.contains(zw, tol=1e-6))
            survivors.append((K, piece, wants_verts))
            if wants_verts:
                sliced_list.append(piece.poly_slice(slice_spec).simplify())
        # vertex sampling for ALL pieces in one fused batch of kernels
        vert_results = vertices.get_verts_batch(sliced_list, rng=self.rng) \
            if sliced_list else []
        out = []
        vi = 0
        for K, piece, wants_verts in survivors:
            verts = []
            if wants_verts:
                res = vert_results[vi]
                vi += 1
                if res != "empty":
                    V = res[0]
                    verts = [np.concatenate([self.z[:nv], v, self.w])
                             for v in V]
            projected = project_and_permute(piece, self.decision_inds,
                                            self.param_inds)
            METRICS.bump("pieces_projected")
            out.append((K, projected, verts))
        return out

    def _absorb(self, expansion):
        for K, piece, verts in expansion:
            self.polys.add(piece)
            for v in verts:
                vq = quantize(v)
                if vq not in self.explored_vertices:
                    self.unexplored_vertices.add(vq)

    def _pull_vertices(self):
        while self.unexplored_vertices and \
                len(self.explored_vertices) < self.max_vertices:
            v = self.unexplored_vertices.pop()
            self.explored_vertices.add(v)
            va = np.asarray(v)
            J = comp_indices(self.gavi, va[:len(self.z)], va[len(self.z):],
                             self.permuted_request)
            Ks = all_Ks(J) - self.explored_Ks
            self.unexplored_Ks |= Ks
            METRICS.bump("vertices_explored")

    def collect(self) -> List[Poly]:
        """Batch enumeration (avi_solutions.jl:277-293).  With a frontier
        store attached, every generation persists the frontier so a killed
        run resumes where it stopped."""
        while True:
            if not self.unexplored_Ks:
                # the generation checkpoint lands BETWEEN expansion and the
                # vertex pull, so a restored frontier may hold only pending
                # VERTICES with an empty recipe set — pull them first or a
                # resumed run silently truncates the solution map
                if (not self.unexplored_vertices
                        or len(self.explored_vertices) >= self.max_vertices):
                    break
                self._pull_vertices()
                if not self.unexplored_Ks:
                    break
            Ks = list(self.unexplored_Ks)
            self.explored_Ks |= self.unexplored_Ks
            self.unexplored_Ks = set()
            self._absorb(self._expand_batch(Ks))
            self._checkpoint()
        return list(self.polys)

    def __iter__(self):
        """Incremental iteration (avi_solutions.jl:323-382)."""
        yielded = set()
        for p in list(self.polys):
            yielded.add(p)
            yield p
        while True:
            if self.unexplored_Ks:
                K = self.unexplored_Ks.pop()
                self.explored_Ks.add(K)
                expansion = self._expand_batch([K])
                self._absorb(expansion)
                for _, piece, _ in expansion:
                    if piece not in yielded:
                        yielded.add(piece)
                        yield piece
            elif self.unexplored_vertices and \
                    len(self.explored_vertices) < self.max_vertices:
                self._pull_vertices()
            else:
                return


# --------------------------------------------------------------------------
#  permutation helpers — avi_solutions.jl:43-77
# --------------------------------------------------------------------------

def unpermute(request, dim: int, var_inds, param_inds):
    """Re-express request directions from x layout into [z1 | extra | w]
    layout (avi_solutions.jl:58-77).

    Reference parity note: callers pass ``dim = n + m`` (z+w dims, incl.
    dual coordinates — avi_solutions.jl:118), so requests whose length is
    the plain x dimension are silently skipped and a length-``dim`` input
    has its tail read through ``extra`` slots.  The reference's dormant
    request flow carries the identical quirk; the live flow only produces
    length-``dim`` directions (tests/test_requests_e2e.py)."""
    if not request:
        return frozenset()
    dv, dp = len(var_inds), len(param_inds)
    extra = [i for i in range(dim) if i not in set(var_inds) | set(param_inds)]
    out = set()
    for req in request:
        a = np.asarray(req.a, dtype=np.float64)
        if a.shape[0] != dim:
            continue
        a_orig = np.zeros(dim)
        a_orig[:dv] = a[list(var_inds)]
        a_orig[dv:dim - dp] = a[extra]
        a_orig[dim - dp:] = a[list(param_inds)]
        out.add(Linear(a_orig))
    return frozenset(out)


# --------------------------------------------------------------------------
#  process_solution_graph — avi.jl:447-477
# --------------------------------------------------------------------------

def process_solution_graph(qp, constraints: Sequence[Poly], dec_inds, x, lam,
                           exploration_vertices: int = 0,
                           rng: Optional[np.random.Generator] = None,
                           frontier_store=None,
                           request=frozenset()) -> LocalGAVISolutions:
    """Build the single-node parametric KKT GAVI in z=[x_dec; λ], w=x_param::

        Q_dd x_d + Q_dp w + q_d − A_d' λ ⟂ −∞ ≤ x_d ≤ ∞
        λ                               ⟂ l ≤ A_d x_d + A_p w ≤ u

    and return its piece enumerator seeded at the current solution."""
    x = np.asarray(x, dtype=np.float64)
    n = len(qp.f.q)
    dec_inds = list(dec_inds)
    param_inds = [i for i in range(n) if i not in set(dec_inds)]
    nd, npar = len(dec_inds), len(param_inds)
    lam = np.asarray(lam, dtype=np.float64)
    z = np.concatenate([x[dec_inds], lam])
    w = x[param_inds]

    if constraints:
        AA = np.vstack([c.A for c in constraints])
        l2 = np.concatenate([c.l for c in constraints])
        u2 = np.concatenate([c.u for c in constraints])
    else:
        AA = np.zeros((0, n))
        l2 = np.zeros(0)
        u2 = np.zeros(0)
    m = len(l2)
    Q = qp.f.Q
    M = np.hstack([Q[np.ix_(dec_inds, dec_inds)], -AA[:, dec_inds].T])
    N = Q[np.ix_(dec_inds, param_inds)]
    o = qp.f.q[dec_inds]
    gavi = GAVI(
        M=M, N=N, o=o,
        l1=np.full(nd, -np.inf), u1=np.full(nd, np.inf),
        A=np.hstack([AA[:, dec_inds], np.zeros((m, m))]),
        B=AA[:, param_inds],
        l2=l2, u2=u2)
    return LocalGAVISolutions(gavi, z, w, 0, 0, dec_inds, param_inds,
                              frozenset(request),
                              max_vertices=exploration_vertices,
                              rng=rng, frontier_store=frontier_store,
                              request_is_permuted=True)


def get_single_solution(gavi: GAVI, z, w, level, subpiece_index,
                        decision_inds, param_inds, rng,
                        extra_rounds: int = 0, permute: bool = True,
                        max_walk: float = 1000.0):
    """High-dimension flow: one maximal-freedom piece around (z, w)
    (avi_solutions.jl:139-194), optionally walked to a less restricted
    active set by random-objective LPs over the piece."""
    from .ops import batch_qp
    z = np.asarray(z, dtype=np.float64).copy()
    w = np.asarray(w, dtype=np.float64)
    n, m = len(z), len(w)
    J = comp_indices(gavi, z, w)
    K = max_freedom_K(J)
    for rnd in range(extra_rounds):
        q = rng.standard_normal(n)
        piece, _ = local_piece(gavi, n, m, K)
        A, l, u, _, _ = piece.vectorize()
        Aw = A[:, n:] @ w
        An = np.vstack([A[:, :n], q[None, :]])
        ll = np.concatenate([l - Aw, [-max_walk]])
        uu = np.concatenate([u - Aw, [max_walk]])
        sol = batch_qp.solve_qp_np(np.zeros((n, n)), q, An, ll, uu)
        if (sol.status in (batch_qp.SOLVED, batch_qp.SOLVED_INACCURATE)
                and not np.allclose(z, sol.x, atol=1e-4)):
            z = np.asarray(sol.x)
            J = comp_indices(gavi, z, w)
            K = max_freedom_K(J)
            break
    nv = len(decision_inds)
    if permute:
        # [x_dec | x_param] layout like the enumerator's pieces: project
        # the UNREDUCED piece (project_and_permute expects full (z, w)
        # columns); reduced_inds is empty in this layout
        full_piece, _ = local_piece(gavi, n, m, K)
        piece = project_and_permute(full_piece, decision_inds, param_inds)
        reduced_inds = []
    else:
        reducible = list(range(nv, n))
        piece, reduced_inds = local_piece(gavi, n, m, K,
                                          reducible_inds=reducible)
    x = np.zeros(len(decision_inds) + len(param_inds))
    x[list(decision_inds)] = z[:len(decision_inds)]
    x[list(param_inds)] = w
    return piece, x, reduced_inds, z
