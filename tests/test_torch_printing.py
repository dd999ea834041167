"""The port's printers (``qpn_tpu_torch/printing.py``) against the JAX
package's (``qpn_tpu/printing.py``): the same objects, built from the same
seeded numpy data in each package, must print to equal strings.  The cases
of ``tests/test_aux.py``'s printing tests, each against the reference."""

import numpy as np
import pytest

import qpn_tpu as ref_qt
from qpn_tpu import printing as ref_printing
from qpn_tpu.geometry import poly as ref_poly
from qpn_tpu import network as ref_network

import qpn_tpu_torch as qt
from qpn_tpu_torch import printing
from qpn_tpu_torch.geometry import poly
from qpn_tpu_torch import network


def _polys(mod, seed):
    """A box with an infinite bound, a seeded random polyhedron with one
    strict row, and one with an equality row, built by ``mod``."""
    rng = np.random.default_rng(seed)
    A = np.round(rng.standard_normal((4, 3)), 3)
    A[1, 2] = 0.0
    l = np.round(-rng.random(4), 3)
    u = np.round(rng.random(4), 3)
    l[3] = u[3]
    box = mod.from_box([0.0, -np.inf], [1.0, 2.0])
    strict = mod.Poly(A, l, u, strict_l=np.array([True, False, False, False]))
    return [box, strict, mod.Poly(A[:3], l[:3], u[:3])]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("which", [0, 1, 2])
def test_format_poly_equals_reference(seed, which):
    got = printing.format_poly(_polys(poly, seed)[which])
    want = ref_printing.format_poly(_polys(ref_poly, seed)[which])
    assert got == want
    assert "Poly in R^" in got


@pytest.mark.parametrize("max_rows", [1, 40])
def test_format_poly_row_limit_equals_reference(max_rows):
    got = printing.format_poly(_polys(poly, 3)[1], max_rows=max_rows)
    want = ref_printing.format_poly(_polys(ref_poly, 3)[1], max_rows=max_rows)
    assert got == want


@pytest.mark.parametrize("max_polys", [2, 10])
def test_format_poly_union_equals_reference(max_polys):
    got = printing.format_poly_union(poly.PolyUnion(_polys(poly, 4)),
                                     max_polys=max_polys)
    want = ref_printing.format_poly_union(
        ref_poly.PolyUnion(_polys(ref_poly, 4)), max_polys=max_polys)
    assert got == want


@pytest.mark.parametrize("labels", [None, {"x": 0, "yvar": 1, "zed": 2}])
@pytest.mark.parametrize("indent", [0, 4])
def test_format_labeled_poly_equals_reference(labels, indent):
    got = printing.format_labeled_poly(_polys(poly, 5)[1], labels=labels,
                                       indent=indent)
    want = ref_printing.format_labeled_poly(_polys(ref_poly, 5)[1],
                                            labels=labels, indent=indent)
    assert got == want


def test_format_labeled_poly_golden():
    """The golden checks of ``tests/test_aux.py`` on the port's printer."""
    A = np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    p = poly.Poly(A, np.array([0.0, -1.0, 2.0]), np.array([1.0, 1.0, 2.0]))
    s = printing.format_labeled_poly(p, labels={"x": 0, "yvar": 1})
    lines = s.rstrip("\n").split("\n")
    assert lines[0] == "Polyhedron in R^2 with 3 constraints."
    assert "x" in lines[1] and "yvar" in lines[1]
    assert lines[2].lstrip().startswith("2 ≤")
    assert sum("| x" in ln for ln in lines) == 1
    assert "·" in s


@pytest.mark.parametrize("red", [None, [1, 0]])
def test_format_intersection_tree_equals_reference(red):
    def pus(mod):
        b = mod.from_box([0.0], [1.0])
        return [mod.PolyUnion([b]), mod.PolyUnion([b, b])]
    got = printing.format_intersection_tree(pus(poly), red_lengths=red)
    want = ref_printing.format_intersection_tree(pus(ref_poly),
                                                 red_lengths=red)
    assert got == want
    assert got.split("\n")[0] == "Intersection root with 2 potential polys"


@pytest.mark.parametrize("names", [None, ["a", "b"]])
def test_format_quadratic_equals_reference(names):
    Q, q = np.array([[2.0, 1.0], [1.0, 0.0]]), np.array([0.0, -3.0])
    got = printing.format_quadratic(network.Quadratic(Q, q, 1.0), names)
    want = ref_printing.format_quadratic(ref_network.Quadratic(Q, q, 1.0),
                                         names)
    assert got == want
    if names:
        assert "+1 a·b" in got and "+1 a²" in got


@pytest.mark.parametrize("model", ["simple_bilevel", "trilevel_escape"])
def test_format_qp_equals_reference(model):
    port, ref = qt.setup(model), ref_qt.setup(model)
    for pid in sorted(port.qps):
        assert printing.format_qp(port.qps[pid]) == \
            ref_printing.format_qp(ref.qps[pid])


def test_display_debug_equals_reference(capsys):
    printing.display_debug(None, 2, 7, pieces=5)
    got = capsys.readouterr().out
    ref_printing.display_debug(None, 2, 7, pieces=5)
    assert got == capsys.readouterr().out == \
        "[qpn] level 2 iteration 7 — 5 solution-graph pieces\n"


def test_install_reprs_at_import():
    """``import qpn_tpu_torch`` installs the printers as ``__str__``, as
    ``import qpn_tpu`` does for Poly and PolyUnion; the port adds Quadratic
    and QP."""
    p = _polys(poly, 6)[1]
    assert str(p) == str(_polys(ref_poly, 6)[1])
    assert str(poly.PolyUnion([p])) == printing.format_poly_union(
        poly.PolyUnion([p]))
    f = network.Quadratic(np.eye(2), np.ones(2), 0.0)
    assert str(f) == printing.format_quadratic(f)
    qp = qt.setup("simple_bilevel").qps[1]
    assert str(qp) == printing.format_qp(qp)
