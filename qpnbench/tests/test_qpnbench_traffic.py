"""The traffic generator reproduces its pool from the mix's pool seed, its
order and its check ensembles from the run's seed, and at pool seed 0 its
first ensemble is the program's own seed-0 ensemble."""

import numpy as np

from qpnbench import traffic

MIX = {"lanes": 8, "pool": 3, "pool_seed": 3001234567, "check_ensembles": 2,
       "position_sigma": 1.0, "bound_jitter": 0.05}


def pool(seed, **kw):
    return traffic.draw_pool(dict(MIX, pool_seed=seed, **kw), 4, 38)


def test_same_seed_same_draw():
    a = pool(3001234567)
    b = pool(3001234567)
    assert np.array_equal(a.shift, b.shift)
    assert np.array_equal(a.jitter, b.jitter)
    assert a.shift.shape == (3, 8, 4) and a.jitter.shape == (3, 8, 38)


def test_other_seed_other_draw():
    a = pool(2 ** 31 + 5)
    b = pool(2 ** 31 + 6)
    assert not np.array_equal(a.shift, b.shift)
    assert not np.array_equal(a.jitter, b.jitter)


def test_ensembles_of_a_pool_differ():
    a = pool(7)
    assert not np.array_equal(a.shift[0], a.shift[1])


def test_check_ensembles_come_from_the_run_seed():
    a = traffic.draw_check(MIX, 4, 38, 2 ** 33 + 1)
    b = traffic.draw_check(MIX, 4, 38, 2 ** 33 + 1)
    other = traffic.draw_check(MIX, 4, 38, 2 ** 33 + 2)
    assert a.shift.shape == (2, 8, 4) and a.jitter.shape == (2, 8, 38)
    assert np.array_equal(a.shift, b.shift)
    assert np.array_equal(a.jitter, b.jitter)
    assert not np.array_equal(a.shift, other.shift)
    # a stream apart from the pool's, even where the pool's seed is the
    # run's
    same = pool(2 ** 33 + 1)
    assert not np.isin(a.shift, same.shift).any()


def test_order_is_passes_of_permutations_from_the_seed():
    a, b = traffic.Order(2 ** 31 + 9, 16), traffic.Order(2 ** 31 + 9, 16)
    seq = [a(c) for c in range(48)]
    assert seq == [b(c) for c in range(48)]
    for k in range(3):
        assert sorted(seq[16 * k:16 * (k + 1)]) == list(range(16))
    assert seq[:16] != seq[16:32]
    other = traffic.Order(2 ** 31 + 10, 16)
    assert [other(c) for c in range(48)] != seq
    assert traffic.Order(-5, 4)(0) in range(4)


def test_scales():
    big = pool(11, lanes=512)
    assert abs(big.shift.std() - 1.0) < 0.05
    assert abs(big.jitter.std() - 0.05) < 0.0025


def test_seed_zero_is_the_programs_ensemble():
    """The first ensemble at seed 0 and the model's seed 0 equals
    ``scenario_batch_gavis(seed=0)``: the draw is a copy of its draw."""
    from qpn_tpu_torch.models.robust_avoid import scenario_batch_gavis
    from qpnbench.models import robust_avoid as model
    for T, K in ((2, 1), (5, 2)):
        config = dict(T=T, num_obj=K, num_poly_faces=4, model_seed=0)
        sys_ = model.assemble(config)
        draws = traffic.draw_pool(dict(MIX, pool_seed=0), sys_.shifted,
                                  sys_.M.shape[0])
        q, l, u = model.lanes(sys_, draws.shift, draws.jitter)
        b = scenario_batch_gavis(num_scenarios=8, T=T, num_obj=K,
                                 num_poly_faces=4, seed=0)
        assert np.array_equal(b["M"][0], sys_.M)
        assert np.array_equal(b["q"], q[0])
        assert np.array_equal(b["l"], l[0])
        assert np.array_equal(b["u"], u[0])
        assert b["structure"] == sys_.structure
