"""The port's shared-matrix scenario-ensemble route
(``qpn_tpu_torch/ops/shared_kkt.py``) against the JAX package's
(``qpn_tpu/ops/shared_kkt.py``, JAX on the CPU) on the same numpy inputs made
from a seed: the counterparts of ``tests/test_shared_kkt.py`` and, function
by function, the device functions on identical inputs.

Tolerances.  The extragradient pre-pass runs thousands of f32 steps whose
GEMMs sum in another order in the two packages, so the pre-pass iterates
differ in their last bits (1e-5 relative after 50 steps) and a label within
the band of a bound may flip; what is defined is compared: every lane
certified with a natural residual at most ``tol`` re-audited in numpy, z
equal to the JAX route's to 1e-8 where the solution is unique (T=2), and at
T=8 (M rank-deficient) residuals, counters and rung populations.  From given
masks the basis solves are f32 LU plus f64 refinement against the same f64
data in both packages: z to 1e-9.  The label hashes are integers: bit-equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from qpn_tpu.models.robust_avoid import scenario_batch_gavis
from qpn_tpu.ops import shared_kkt as ref_sk
from qpn_tpu.utils.metrics import METRICS as REF_METRICS

from qpn_tpu_torch.config import CONFIG
from qpn_tpu_torch.models import robust_avoid
from qpn_tpu_torch.ops import avi
from qpn_tpu_torch.ops import shared_kkt as sk
from qpn_tpu_torch.utils.metrics import METRICS

# many small batched operations: intra-op threads make them no faster and
# contend with the other test workers
torch.set_num_threads(1)

TOL = 1e-8
RUNGS = ("shared_kkt_chip_admm_rung", "shared_kkt_admm_escalation",
         "shared_kkt_generic_escalation")
LEDGER = ("eg_iters", "lu_factored", "refine_gemms", "host_solves",
          "device_flops", "device_bytes")


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    """These tests run on the CPU: they ask the port for it (its default
    device is the card)."""
    monkeypatch.setattr(CONFIG, "device", "cpu")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="module")
def small_batch():
    return scenario_batch_gavis(num_scenarios=24, T=2, num_obj=1,
                                num_poly_faces=4, seed=0)


def _args(b):
    return b["M"], b["q"], b["l"], b["u"], b["mask"]


def _audit(b, z):
    """Natural residual per lane in numpy f64."""
    F = np.einsum("ij,bj->bi", b["M"][0], z) + b["q"]
    return np.abs(z - np.clip(z - F, b["l"], b["u"])).max(axis=1)


def _counted(metrics, fn):
    """fn()'s result and what it added to the rung counters."""
    c0 = {k: metrics.counters.get(k, 0) for k in RUNGS}
    out = fn()
    return out, {k: metrics.counters.get(k, 0) - v for k, v in c0.items()}


def _monotone(rng, n, S, shift, free=0.25):
    """A random strongly monotone shared ensemble (PSD + skew + shift·I:
    one solution), some bounds infinite."""
    A = rng.standard_normal((n, n))
    K = rng.standard_normal((n, n))
    M0 = A @ A.T / n + (K - K.T) / np.sqrt(n) + shift * np.eye(n)
    q = rng.standard_normal((S, n))
    l = np.where(rng.random((S, n)) < free, -np.inf,
                 -1.0 - rng.random((S, n)))
    u = np.where(rng.random((S, n)) < free, np.inf,
                 1.0 + rng.random((S, n)))
    return M0, q, l, u


class TestSharedRoute:
    def test_matches_jax_route_and_lemke_route(self, small_batch):
        b = small_batch
        stats, ref_stats = {}, {}
        res = sk.solve_kkt_avi_shared(*_args(b), tol=TOL, stats=stats)
        ref = ref_sk.solve_kkt_avi_shared(*_args(b), tol=TOL,
                                          stats=ref_stats)
        assert res.z.dtype == torch.float64 and res.z.shape == (24, 38)
        assert bool(res.converged.all())
        assert bool(np.asarray(ref.converged).all())
        z = res.z.numpy()
        assert _audit(b, z).max() <= TOL
        # one solution (T=2): the JAX route's z to 1e-8, its own tolerance
        np.testing.assert_allclose(z, np.asarray(ref.z), rtol=0, atol=1e-8)
        # and the port's pivot route's
        t = avi.batch_from_numpy(b)
        piv = avi.solve_kkt_avi_batch(
            t["M"], t["q"], t["l"], t["u"], t["mask"],
            {k: v for k, v in t["structure"].items() if k != "shared_M"},
            tol=TOL)
        assert bool(piv.converged.all())
        np.testing.assert_allclose(z, piv.z.numpy(), rtol=0, atol=1e-8)
        # the same work: pre-pass chunks, factorizations, host solves
        for key in ("eg_iters", "lu_factored", "refine_gemms",
                    "host_solves"):
            assert stats[key] == ref_stats[key], key
        np.testing.assert_array_equal(res.iters.numpy(),
                                      np.asarray(ref.iters))

    def test_accepts_2d_and_3d_matrix_and_tensors(self, small_batch):
        b = small_batch
        r3 = sk.solve_kkt_avi_shared(*_args(b), tol=TOL)
        r2 = sk.solve_kkt_avi_shared(b["M"][0], b["q"], b["l"], b["u"],
                                     b["mask"], tol=TOL)
        assert torch.equal(r3.z, r2.z)
        t = avi.batch_from_numpy(b)
        rt = sk.solve_kkt_avi_shared(t["M"], t["q"], t["l"], t["u"],
                                     t["mask"], tol=TOL)
        assert torch.equal(r3.z, rt.z)

    def test_rejects_padded_masks(self, small_batch):
        b = small_batch
        mask = np.asarray(b["mask"]).copy()
        mask[0, -1] = False
        with pytest.raises(ValueError, match="unpadded"):
            sk.solve_kkt_avi_shared(b["M"], b["q"], b["l"], b["u"], mask)

    def test_stats_ledger(self, small_batch):
        b = small_batch
        stats, ref_stats = {}, {}
        sk.solve_kkt_avi_shared(*_args(b), tol=TOL, stats=stats)
        ref_sk.solve_kkt_avi_shared(*_args(b), tol=TOL, stats=ref_stats)
        for key in LEDGER:
            assert key in stats
            assert stats[key] == ref_stats[key], key
        assert stats["device_flops"] > 0
        # the fused round 0 always factorizes every lane on the device (the
        # host tail of at most 24 lanes applies to later rounds only)
        assert stats["lu_factored"] >= 24
        assert set(stats["phase_t"]) == set(ref_stats["phase_t"])
        assert stats["chip_admm_t"] == {}       # no lane reached the rung

    def test_rejects_unknown_precision(self, small_batch):
        with pytest.raises(ValueError, match="eg_prec"):
            sk.solve_kkt_avi_shared(*_args(small_batch), eg_prec="bf16")
        before = torch.backends.cuda.matmul.allow_tf32
        res = sk.solve_kkt_avi_shared(*_args(small_batch), tol=TOL,
                                      eg_prec="tf32")
        assert bool(res.converged.all())
        assert torch.backends.cuda.matmul.allow_tf32 == before

    def test_degenerate_lanes_escalate_to_conv(self):
        """T=8, num_obj=4 ensembles hold lanes whose extragradient
        classification is singular; the ladder must still certify every lane
        at 1e-8, with the JAX route's rung populations."""
        b = scenario_batch_gavis(num_scenarios=16, T=8, num_obj=4,
                                 num_poly_faces=4, seed=0)
        res, d = _counted(METRICS, lambda: sk.solve_kkt_avi_shared(
            *_args(b), tol=TOL, eg_budget=30000))
        ref, dr = _counted(REF_METRICS, lambda: ref_sk.solve_kkt_avi_shared(
            *_args(b), tol=TOL, eg_budget=30000))
        assert bool(res.converged.all())
        assert _audit(b, res.z.numpy()).max() <= TOL
        assert bool(np.asarray(ref.converged).all())
        assert d == dr


class TestProductionRouting:
    def test_structured_solve_routes_shared_at_scale(self):
        """solve_kkt_avi_batch sends shared_M ensembles at or above
        CONFIG.shared_kkt_min_n to the shared route (counted per lane) and
        keeps small ensembles on the pivot route."""
        small = avi.batch_from_numpy(scenario_batch_gavis(
            num_scenarios=8, T=2, num_obj=1, num_poly_faces=4, seed=0))
        assert small["M"].shape[1] < CONFIG.shared_kkt_min_n
        c0 = METRICS.counters.get("kkt_shared_route", 0)
        res = avi.solve_kkt_avi_batch(
            small["M"], small["q"], small["l"], small["u"], small["mask"],
            small["structure"], tol=TOL)
        assert METRICS.counters.get("kkt_shared_route", 0) == c0
        assert bool(res.converged.all())

        b = scenario_batch_gavis(num_scenarios=6, T=8, num_obj=4,
                                 num_poly_faces=4, seed=1)
        big = avi.batch_from_numpy(b)
        assert big["M"].shape[1] >= CONFIG.shared_kkt_min_n
        assert big["structure"]["shared_M"]
        res = avi.solve_kkt_avi_batch(
            big["M"], big["q"], big["l"], big["u"], big["mask"],
            big["structure"], tol=TOL)
        assert METRICS.counters.get("kkt_shared_route", 0) == c0 + 6
        assert bool(res.converged.all())
        assert _audit(b, res.z.numpy()).max() <= TOL

    def test_hard_chunk_job_runs(self):
        """The process-pool work unit of the hard class: every lane
        certified, the checksum that of a direct solve."""
        conv, resid, checksum = robust_avoid.hard_chunk_job(6, 2, 1, 4, 2)
        assert conv == 1.0 and resid <= TOL
        b = scenario_batch_gavis(num_scenarios=6, T=2, num_obj=1,
                                 num_poly_faces=4, seed=2)
        r = sk.solve_kkt_avi_shared(b["M"][0], b["q"], b["l"], b["u"], None,
                                    tol=TOL, structure=b["structure"])
        assert checksum == float(np.abs(r.z.numpy()).sum())


class TestDeterminism:
    def test_straggler_population_identical_across_repeats(self):
        """At a fixed seed the route's rung populations, per-lane iteration
        counts and solutions are identical across repeated solves, bit for
        bit, and the populations are the JAX route's."""
        b = scenario_batch_gavis(num_scenarios=24, T=8, num_obj=4,
                                 num_poly_faces=4, seed=2)
        runs = []
        for _ in range(3):
            stats = {}
            res, deltas = _counted(METRICS, lambda: sk.solve_kkt_avi_shared(
                *_args(b), tol=TOL, stats=stats, structure=b["structure"]))
            runs.append((res.z.numpy().copy(), res.iters.numpy().copy(),
                         stats["host_solves"], deltas))
            assert bool(res.converged.all())
        z0, it0, hs0, d0 = runs[0]
        for z, it, hs, d in runs[1:]:
            assert (it == it0).all()          # same per-lane work
            assert hs == hs0                  # same host-solve population
            assert d == d0                    # same rung populations
            assert (z == z0).all()            # bit-identical solutions
        assert _audit(b, z0).max() <= TOL
        ref, dr = _counted(REF_METRICS, lambda: ref_sk.solve_kkt_avi_shared(
            *_args(b), tol=TOL, structure=b["structure"]))
        assert bool(np.asarray(ref.converged).all())
        assert d0 == dr
        assert d0["shared_kkt_chip_admm_rung"] > 0
        assert d0["shared_kkt_admm_escalation"] == 0
        assert d0["shared_kkt_generic_escalation"] == 0


class TestDesignScale:
    def test_trajectory_scale_regression_T8_n608(self):
        """The full trajectory dimension at a small S: every lane certifies
        at 1e-8, the generic escalation stays cold, per-lane iterations count
        the pre-pass plus the basis rounds; residuals and counters against
        the JAX route (M is rank-deficient at T=8: z is not compared)."""
        b = scenario_batch_gavis(num_scenarios=8, T=8, num_obj=4,
                                 num_poly_faces=4, seed=3)
        assert b["M"].shape[1] == 608
        stats = {}
        res, d = _counted(METRICS, lambda: sk.solve_kkt_avi_shared(
            *_args(b), tol=TOL, eg_budget=30000, stats=stats,
            structure=b["structure"]))
        ref, dr = _counted(REF_METRICS, lambda: ref_sk.solve_kkt_avi_shared(
            *_args(b), tol=TOL, eg_budget=30000, structure=b["structure"]))
        assert bool(res.converged.all())
        assert _audit(b, res.z.numpy()).max() <= TOL
        assert bool(np.asarray(ref.converged).all())
        assert d == dr and d["shared_kkt_generic_escalation"] == 0
        it = res.iters.numpy()
        assert (it >= stats["eg_iters"]).all()
        assert (it > stats["eg_iters"]).any()   # basis rounds counted

    def test_escalation_rung_runs_and_certifies(self, monkeypatch):
        """The generic escalation solves lanes the cheap rungs were denied:
        with every classification poisoned and no policy rounds, escalation
        alone certifies the batch and bumps its counter."""
        b = scenario_batch_gavis(num_scenarios=6, T=2, num_obj=1,
                                 num_poly_faces=4, seed=5)

        def _poisoned(Zc, Fc, l, u, band):   # every classification garbage
            at_l = np.zeros_like(Zc, dtype=bool)
            return at_l, at_l
        monkeypatch.setattr(sk, "_classify", _poisoned)
        c0 = METRICS.counters.get("shared_kkt_generic_escalation", 0)
        res = sk.solve_kkt_avi_shared(*_args(b), tol=TOL, eg_budget=2000,
                                      newton_rounds=1)
        assert METRICS.counters.get("shared_kkt_generic_escalation", 0) > c0
        assert bool(res.converged.all())
        assert _audit(b, res.z.numpy()).max() <= TOL

    def test_property_n128_matches_generic_and_jax(self, rng):
        """Random monotone shared ensembles at n=128: the shared route
        certifies and agrees with the port's generic solver (1e-6, the JAX
        test's bound) and with the JAX shared route (1e-8: one solution)."""
        n, S = 128, 12
        M0, q, l, u = _monotone(rng, n, S, 0.05)
        res = sk.solve_kkt_avi_shared(M0, q, l, u, None, tol=TOL)
        assert bool(res.converged.all())
        t = [torch.as_tensor(a) for a in
             (np.repeat(M0[None], S, axis=0), q, l, u, np.zeros((S, n)))]
        gen = avi.solve_avi_batch_adaptive(
            *t, torch.ones(S, n, dtype=torch.bool), tol=TOL)
        assert bool(gen.converged.all())
        np.testing.assert_allclose(res.z.numpy(), gen.z.numpy(), rtol=0,
                                   atol=1e-6)
        ref = ref_sk.solve_kkt_avi_shared(M0, q, l, u, None, tol=TOL)
        np.testing.assert_allclose(res.z.numpy(), np.asarray(ref.z), rtol=0,
                                   atol=1e-8)

    def test_random_strongly_monotone_matches_generic(self, rng):
        n, S = 24, 16
        M0, q, l, u = _monotone(rng, n, S, 0.1, free=0.3)
        res = sk.solve_kkt_avi_shared(M0, q, l, u, None, tol=TOL)
        assert bool(res.converged.all())
        t = [torch.as_tensor(a) for a in
             (np.repeat(M0[None], S, axis=0), q, l, u, np.zeros((S, n)))]
        gen = avi.solve_avi_batch_adaptive(
            *t, torch.ones(S, n, dtype=torch.bool), tol=TOL)
        assert bool(gen.converged.all())
        np.testing.assert_allclose(res.z.numpy(), gen.z.numpy(), rtol=0,
                                   atol=1e-6)


class TestProxEGRung:
    def test_rung_certifies_strongly_monotone_ensemble(self, rng):
        """The opt-in proximal-point rung (f64 outer refinement over f32
        inner GEMMs) certifies a strongly monotone shared ensemble at 1e-8
        from a cold start, in the JAX rung's number of outer rounds, at its
        z within 1e-8."""
        n, S = 32, 16
        M0, q, _, _ = _monotone(rng, n, S, 0.3)
        l, u = -np.ones((S, n)), np.ones((S, n))
        v = np.ones(n) / np.sqrt(n)
        for _ in range(30):
            w = M0.T @ (M0 @ v)
            v = w / np.linalg.norm(w)
        Lip = float(np.sqrt(np.linalg.norm(M0.T @ (M0 @ v))))
        delta = np.float32(0.05 * Lip)
        tau = np.float32(0.9 / (Lip + 0.05 * Lip))
        M64 = torch.as_tensor(M0)
        z, rn, k = sk._prox_eg_rung(
            M64.float(), M64, torch.as_tensor(q), torch.as_tensor(l),
            torch.as_tensor(u), torch.zeros(S, n, dtype=torch.float64),
            delta, tau, 1e-8, 1000, 40)
        assert float(rn.max()) <= 1e-8
        rh, _ = sk._nat_resid_shared(M0, q, l, u, z.numpy())
        assert rh.max() <= 1e-8
        zr, rnr, kr = ref_sk._prox_eg_rung(
            jnp.asarray(M0, jnp.float32), jnp.asarray(M0), jnp.asarray(q),
            jnp.asarray(l), jnp.asarray(u), jnp.asarray(np.zeros_like(q)),
            delta, tau, 1e-8, 1000, 40)
        assert k == int(kr)
        np.testing.assert_allclose(z.numpy(), np.asarray(zr), rtol=0,
                                   atol=1e-8)

    def test_flag_plumbing(self, small_batch):
        res = sk.solve_kkt_avi_shared(*_args(small_batch), tol=TOL,
                                      enable_prox_eg=True)
        assert bool(res.converged.all())

    def test_popov_method_plumbing(self, small_batch):
        res = sk.solve_kkt_avi_shared(*_args(small_batch), tol=TOL,
                                      eg_method="popov")
        assert bool(res.converged.all())


class TestLabelHashParity:
    def test_device_host_and_jax_fingerprints_agree(self, rng):
        """The cycling detector mixes fingerprints of the device round-0
        hash and the host policy-loop hash: one function bit for bit, and
        the JAX package's."""
        n, C = 131, 24
        at_l = rng.random((C, n)) < 0.3
        at_u = (rng.random((C, n)) < 0.3) & ~at_l
        host = sk._label_hash(at_l, at_u, sk._hash_weights(n))
        dev = sk._label_hash_dev(torch.as_tensor(at_l),
                                 torch.as_tensor(at_u))
        assert dev.dtype == torch.int32
        np.testing.assert_array_equal(host, dev.numpy())
        np.testing.assert_array_equal(
            host, np.asarray(ref_sk._label_hash_dev(at_l, at_u)))
        np.testing.assert_array_equal(sk._hash_weights(n),
                                      ref_sk._hash_weights(n))
        np.testing.assert_array_equal(
            sk._wrap32(np.array([2**31, -2**31 - 1, 5])),
            ref_sk._wrap32(np.array([2**31, -2**31 - 1, 5])))


# --------------------------------------------------------------------------
#  The device functions one by one, on identical inputs
# --------------------------------------------------------------------------

def _pre_pass_inputs(b):
    """f32 inputs of the pre-pass as ``solve_kkt_avi_shared`` builds them."""
    M0, q = b["M"][0], b["q"]
    f32 = np.float32
    scale = 1.0 + float(np.abs(q).max())
    Lip = np.linalg.norm(M0, 2)
    L, U = b["l"].astype(f32), b["u"].astype(f32)
    Z = np.clip(np.zeros_like(q, dtype=f32), L, U)
    return (M0.T.astype(f32).copy(), q.astype(f32), L, U, Z,
            f32(0.9 / Lip), f32(1e-4 * scale))


@pytest.mark.parametrize("method", ["eg", "popov"])
def test_eg_steps_match_reference(small_batch, method):
    """50 pre-pass steps from the same f32 inputs: Z and r to 1e-5 relative
    (f32 GEMMs summed in another order), labels equal except within that
    distance of the band."""
    Mt, Q, L, U, Z, tau, band = _pre_pass_inputs(small_batch)
    if method == "popov":
        tau = np.float32(tau / 2)
    got = sk._eg_steps(*(torch.as_tensor(a) for a in (Mt, Q, L, U, Z)),
                       tau, 50, float(band), method)
    want = ref_sk._eg_steps(*(jnp.asarray(a) for a in (Mt, Q, L, U, Z)),
                            tau, 50, band, ref_sk._PREC, method)
    zg, zw = got[0].numpy(), np.asarray(want[0])
    scale = 1.0 + np.abs(zw).max()
    assert np.abs(zg - zw).max() <= 1e-5 * scale
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-5 * scale)
    s = zw - (zw @ Mt + Q)
    near = ((np.abs(s - L - band) <= 1e-4 * scale)
            | (np.abs(s - U + band) <= 1e-4 * scale))
    for g, w in zip(got[2:], want[2:]):
        assert not ((g.numpy() != np.asarray(w)) & ~near).any()


def test_eg_run_stopping_rules(small_batch):
    """The host loop applies the three stopping rules of the JAX package's
    device loop: the same number of chunks on the same inputs, for a
    residual target that is met, for stable labels, and for a budget that
    runs out."""
    Mt, Q, L, U, Z, tau, band = _pre_pass_inputs(small_batch)
    t = [torch.as_tensor(a) for a in (Mt, Q, L, U, Z)]
    j = [jnp.asarray(a) for a in (Mt, Q, L, U, Z)]
    for steps, chunks, switch, stable in ((500, 40, 1e-3, -1),
                                          (500, 40, 1e-9, 0),
                                          (100, 3, 1e-9, -1)):
        got = sk._eg_run(*t, tau, steps, chunks, float(band), switch, stable)
        want = ref_sk._eg_run(*j, tau, steps, chunks, band,
                              np.float32(switch), np.int32(stable))
        assert got[4] == int(want[4]), (steps, chunks, switch, stable)
        assert 1 <= got[4] <= chunks


def _basis_inputs(b, seed=3):
    """Masks and bound values of a plausible complementary basis: the
    classification of the solution itself, a few labels flipped."""
    rng = np.random.default_rng(seed)
    M0, q, l, u = b["M"][0], b["q"], b["l"], b["u"]
    sol = ref_sk.solve_kkt_avi_shared(*_args(b), tol=TOL)
    z = np.asarray(sol.z)
    F = z @ M0.T + q
    at_l, at_u = sk._classify(z, F, l, u, 1e-9)
    flip = rng.random(at_l.shape) < 0.02
    at_l = at_l & ~flip
    return M0, q, l, u, at_l, at_u, z


def test_round0_solve_matches_reference(small_batch):
    """The fused first policy round from given labels: z to 1e-9 (f32 LU and
    one f64 refinement pass against the same f64 data), rn to 1e-9, the
    hashes bit-equal, the same lanes non-finite."""
    M0, q, l, u, at_l, at_u, _ = _basis_inputs(small_batch)
    tt = torch.as_tensor
    got = sk._round0_solve(tt(M0).float(), tt(M0), tt(at_l), tt(at_u), tt(q),
                           tt(l), tt(u), 1)
    want = ref_sk._round0_solve(jnp.asarray(M0, jnp.float32),
                                jnp.asarray(M0), jnp.asarray(at_l),
                                jnp.asarray(at_u), jnp.asarray(q),
                                jnp.asarray(l), jnp.asarray(u), 1)
    rn_g, rn_w = got[1].numpy(), np.asarray(want[1])
    fin = np.isfinite(rn_w)
    np.testing.assert_array_equal(np.isfinite(rn_g), fin)
    assert fin.sum() >= 20
    np.testing.assert_allclose(got[0].numpy()[fin], np.asarray(want[0])[fin],
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(rn_g[fin], rn_w[fin], rtol=0, atol=1e-9)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_basis_solve_refine_matches_reference_and_host(small_batch):
    """The proximal basis solve from given masks, δ = 0 and δ > 0 lanes:
    z, F, rn and rp to 1e-9 of the JAX function and of the host LAPACK
    version."""
    M0, q, l, u, at_l, at_u, z = _basis_inputs(small_batch, seed=4)
    rng = np.random.default_rng(9)
    S = q.shape[0]
    free = ~(at_l | at_u)
    bval = np.where(at_l, np.where(np.isfinite(l), l, 0.0),
                    np.where(np.isfinite(u), u, 0.0))
    delta = np.where(np.arange(S) % 2 == 0, 0.0, 1e-3)
    zref = z + 1e-3 * rng.standard_normal(z.shape)
    tt = torch.as_tensor
    got = sk._basis_solve_refine(tt(M0).float(), tt(M0), tt(free), tt(bval),
                                 tt(q), tt(l), tt(u), tt(delta), tt(zref), 1)
    want = ref_sk._basis_solve_refine(
        jnp.asarray(M0, jnp.float32), jnp.asarray(M0), jnp.asarray(free),
        jnp.asarray(bval), jnp.asarray(q), jnp.asarray(l), jnp.asarray(u),
        jnp.asarray(delta), jnp.asarray(zref), 1)
    host = sk._host_basis_solve(M0, free, bval, q, l, u, delta, zref)
    fin = np.isfinite(np.asarray(want[2]))
    assert fin.sum() >= 20
    for g, w, h, name in zip(got, want, host, ("z", "F", "rn", "rp")):
        np.testing.assert_allclose(g.numpy()[fin], np.asarray(w)[fin],
                                   rtol=0, atol=1e-9, err_msg=name)
        np.testing.assert_allclose(g.numpy()[fin], h[fin], rtol=0,
                                   atol=1e-9, err_msg=name)


def test_singular_basis_lane_is_reported_non_finite():
    """A lane whose basis matrix is exactly singular (two free variables
    with identical rows) comes back with rn = +inf and touches no other
    lane: the refinement's ``good`` mask reads exactly that."""
    rng = np.random.default_rng(2)
    n, S = 12, 4
    A = rng.standard_normal((n, n))
    M0 = A @ A.T / n + 0.5 * np.eye(n)
    M0[3] = M0[2]                       # rows 2 and 3 identical
    q = rng.standard_normal((S, n))
    l, u = -np.ones((S, n)), np.ones((S, n))
    at_l = np.zeros((S, n), dtype=bool)
    at_u = np.zeros((S, n), dtype=bool)
    at_l[[0, 2, 3], 3] = True           # lanes 0, 2, 3 bind variable 3
    tt = torch.as_tensor
    z, rn, _ = sk._round0_solve(tt(M0).float(), tt(M0), tt(at_l), tt(at_u),
                                tt(q), tt(l), tt(u), 1)
    assert torch.isinf(rn[1]) and bool(torch.isfinite(rn[[0, 2, 3]]).all())
    free = ~(at_l | at_u)
    bval = np.where(at_l, l, u)
    zero = np.zeros(S)
    out = sk._basis_solve_refine(tt(M0).float(), tt(M0), tt(free), tt(bval),
                                 tt(q), tt(l), tt(u), tt(zero),
                                 tt(np.zeros((S, n))), 1)
    assert torch.isinf(out[2][1]) and torch.isinf(out[3][1])
    np.testing.assert_allclose(out[0].numpy()[[0, 2, 3]],
                               z.numpy()[[0, 2, 3]], rtol=0, atol=1e-12)
    host = sk._host_basis_solve(M0, free, bval, q, l, u, zero,
                                np.zeros((S, n)))
    # (f64 LAPACK meets a pivot of rounding size, not zero: a huge residual
    # where the f32 factorization says singular; neither certifies)
    assert host[2][1] > 1.0 and np.isfinite(host[2][[0, 2, 3]]).all()
    # with a proximal δ the same basis is nonsingular
    out = sk._basis_solve_refine(tt(M0).float(), tt(M0), tt(free), tt(bval),
                                 tt(q), tt(l), tt(u), tt(zero + 1e-2),
                                 tt(np.zeros((S, n))), 1)
    assert bool(torch.isfinite(out[2]).all())


def test_structured_polish_and_host_helpers_match_reference():
    """The numpy host functions are copies: equal outputs on the same
    inputs (the active-set polish from an x perturbed off the solution)."""
    b = scenario_batch_gavis(num_scenarios=6, T=2, num_obj=1,
                             num_poly_faces=4, seed=2)
    M0, q, l, u = b["M"][0], b["q"], b["l"], b["u"]
    nd, m = b["structure"]["nd"], b["structure"]["m"]
    sol = ref_sk.solve_kkt_avi_shared(*_args(b), tol=TOL)
    rng = np.random.default_rng(1)
    x0 = np.asarray(sol.z)[:, :nd] + 1e-6 * rng.standard_normal((6, nd))
    scale = 1.0 + float(np.abs(q).max())
    got = sk._structured_polish(M0, nd, m, q, l, u, x0, TOL, scale)
    want = ref_sk._structured_polish(M0, nd, m, q, l, u, x0, TOL, scale)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[1] <= TOL).all()
    z = np.asarray(sol.z)
    for g, w in zip(sk._nat_resid_shared(M0, q, l, u, z),
                    ref_sk._nat_resid_shared(M0, q, l, u, z)):
        np.testing.assert_array_equal(g, w)
    F = z @ M0.T + q
    for g, w in zip(sk._classify(z, F, l, u, 1e-4),
                    ref_sk._classify(z, F, l, u, 1e-4)):
        np.testing.assert_array_equal(g, w)


def test_admm_rung_in_one_call_moves_no_lane():
    """The ADMM rung takes all pending lanes in one call where the JAX
    package pads them to a lane bucket with copies of lane 0: a lane's
    iterates do not depend on its neighbours, so a lane solved alone, with
    one neighbour or with the whole batch ends at the same bits, and the
    rung certifies the hard seed's lanes as the JAX rung does."""
    b = scenario_batch_gavis(num_scenarios=5, T=2, num_obj=1,
                             num_poly_faces=4, seed=2)
    M0, q, l, u = b["M"][0], b["q"], b["l"], b["u"]
    nd, m = b["structure"]["nd"], b["structure"]["m"]
    tt = torch.as_tensor
    off = q[:, nd:nd + m]
    lo, hi = l[:, nd + m:] - off, u[:, nd + m:] - off

    def call(idx):
        k = len(idx)
        return sk._admm_shared_call(
            tt(M0[:nd, :nd]), tt(M0[nd:nd + m, :nd]), tt(q[idx, :nd]),
            tt(lo[idx]), tt(hi[idx]), torch.zeros(k, nd, dtype=torch.float64),
            torch.zeros(k, m, dtype=torch.float64), 1e-4, 4000)

    whole = call([0, 1, 2, 3, 4])
    alone = call([3])
    padded = call([3, 0, 0])
    for other in (alone, padded):
        assert torch.equal(other.x[0], whole.x[3])
        assert int(other.iters[0]) == int(whole.iters[3])
    scale = 1.0 + float(np.abs(q).max())
    todo = np.arange(5)
    its, ref_its = np.zeros(5, dtype=np.int64), np.zeros(5, dtype=np.int64)
    secs = {}
    z, ok, fl = sk._chip_admm_rung(M0, q, l, u, todo, b["structure"], TOL,
                                   scale, its, torch.device("cpu"), secs)
    assert set(secs) == {"admm", "polish"} and min(secs.values()) > 0
    zr, okr, _ = ref_sk._chip_admm_rung(M0, q, l, u, todo, b["structure"],
                                        TOL, scale, ref_its)
    assert ok.all() and okr.all() and fl > 0
    np.testing.assert_allclose(z, zr, rtol=0, atol=1e-8)
    # the JAX rung runs its mixed-precision ADMM: the same lanes within one
    # 25-iteration block
    assert (np.abs(its - ref_its) <= 25).all()


def test_admm_rung_on_the_hard_seeds_escalated_lanes():
    """At S=512 of the hard seed both packages on the CPU send the same 509
    lanes to the ADMM rung; the JAX package's rung fails lanes 62 and 181
    (both go on to shared_kkt_admm_escalation), the port's fails lane 62
    only.  The rung alone on those two lanes, at the whole batch's scale,
    shows it: the port's rung iterates in f64, the JAX package's in
    split-f32 products (its ``mixed`` mode, a TPU workaround the port
    drops), which leaves lane 181 above the tolerance."""
    b = scenario_batch_gavis(num_scenarios=512, T=8, num_obj=4,
                             num_poly_faces=4, seed=2)
    M0, q, l, u = b["M"][0], b["q"], b["l"], b["u"]
    scale = 1.0 + float(np.abs(q).max())
    todo = np.array([62, 181])
    its, ref_its = np.zeros(512, dtype=np.int64), np.zeros(512, np.int64)
    z, ok, _ = sk._chip_admm_rung(M0, q, l, u, todo, b["structure"], TOL,
                                  scale, its, torch.device("cpu"), {})
    _, okr, _ = ref_sk._chip_admm_rung(M0, q, l, u, todo, b["structure"],
                                       TOL, scale, ref_its)
    assert ok.tolist() == [False, True]
    assert okr.tolist() == [False, False]
    # lane 181, certified in f64: its natural residual re-audited in numpy
    F = M0 @ z[1] + q[181]
    assert np.abs(z[1] - np.clip(z[1] - F, l[181], u[181])).max() <= TOL


LU_PROBE = """
import torch
torch.set_num_threads(4)
from qpn_tpu_torch.config import CONFIG
from qpn_tpu_torch.models.robust_avoid import scenario_batch_gavis
from qpn_tpu_torch.ops import shared_kkt
CONFIG.device = "cpu"
b = scenario_batch_gavis(num_scenarios=4, T=8, num_obj=4, num_poly_faces=4,
                         seed=0)
r = shared_kkt.solve_kkt_avi_shared(b["M"][0], b["q"], b["l"], b["u"], None,
                                    tol=1e-8, structure=b["structure"])
print(float(r.converged.double().mean()), torch.get_num_threads())
"""


def test_lu_returns_with_several_cpu_threads():
    """The shared route's batched LU at n=608 on the CPU returns when the
    caller has set several intra-op threads (4 here; with an explicitly set
    count above one, PyTorch's CPU LAPACK did not return from this
    factorization in minutes), and the caller's count is restored.  Run in
    a fresh interpreter under a time limit: an alarm signal cannot
    interrupt a call stuck inside LAPACK."""
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", LU_PROBE], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == ["1.0", "4"]
