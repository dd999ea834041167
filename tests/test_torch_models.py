"""The port's model building (qpn_tpu_torch/models, frontend, network,
algorithm) against the JAX package's: the same numpy code with the same
seeds must give the same networks and bit-identical scenario ensembles."""

import numpy as np
import pytest

import qpn_tpu.models as ref_models
from qpn_tpu.models.robust_avoid import scenario_batch_gavis as ref_batch
from qpn_tpu.utils import native as ref_native

import qpn_tpu_torch.models as port_models
from qpn_tpu_torch.models.robust_avoid import scenario_batch_gavis
from qpn_tpu_torch.utils import native


@pytest.mark.parametrize("S,seed", [(8, 0), (5, 3)])
def test_scenario_batch_equals_reference(S, seed):
    port = scenario_batch_gavis(num_scenarios=S, T=2, num_obj=1,
                                num_poly_faces=4, seed=seed)
    ref = ref_batch(num_scenarios=S, T=2, num_obj=1, num_poly_faces=4,
                    seed=seed)
    assert set(port) == set(ref)
    for k in ("M", "q", "l", "u", "z0", "mask"):
        assert port[k].dtype == ref[k].dtype
        assert np.array_equal(port[k], ref[k]), k
    assert port["structure"] == ref["structure"] == {"nd": 6, "m": 16,
                                                     "shared_M": True}


@pytest.mark.parametrize("name,kw", [
    ("robust_avoid", dict(T=2, num_obj=1, seed=0)),
    ("robust_avoid_simple", dict(num_obj=2, seed=1)),
])
def test_setup_builds_the_reference_network(name, kw):
    port = port_models.setup(name, **kw)
    ref = ref_models.setup(name, **kw)
    assert port.num_vars == ref.num_vars
    assert port.variable_names == ref.variable_names
    assert port.network_edges == ref.network_edges
    assert port.network_depth_map == ref.network_depth_map
    assert sorted(port.qps) == sorted(ref.qps)
    for pid, qp in port.qps.items():
        rq = ref.qps[pid]
        assert qp.constraint_indices == rq.constraint_indices
        assert qp.var_indices == rq.var_indices
        assert np.array_equal(qp.f.Q, rq.f.Q)
        assert np.array_equal(qp.f.q, rq.f.q)
    for cid, con in port.constraints.items():
        rc = ref.constraints[cid]
        for attr in ("A", "l", "u"):
            assert np.array_equal(getattr(con.poly, attr),
                                  getattr(rc.poly, attr))
        assert con.group_mapping == rc.group_mapping
    assert np.array_equal(port.default_initialization,
                          ref.default_initialization)


def test_setup_rejects_models_of_later_slices():
    with pytest.raises(KeyError, match="robust_avoid"):
        port_models.setup("simple_bilevel")


def test_native_dedupe_matches_reference():
    """The port builds the JAX package's qpn_host.cpp by path; its row
    dedup (used while models build their polyhedra) agrees."""
    rng = np.random.default_rng(0)
    rows = np.round(rng.standard_normal((40, 5)), 3)
    rows[7] = rows[3]
    rows[20] = rows[3] + 1e-9          # equal after 5-digit quantization
    rows[31] = -0.0 * rows[31]
    assert native.native_available()       # the g++ build of qpn_host.cpp
    got = native.dedupe_rows_mask(rows)
    np.testing.assert_array_equal(got, ref_native.dedupe_rows_mask(rows))
    assert not got[7] and not got[20]
