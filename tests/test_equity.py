"""Equity API statistical conformance (BASELINE config 3 territory).

The reference has no equity machinery at all; these tests pin the new API
against known analytic/textbook values within Monte Carlo standard error
(adjusted for the engine's faithful no-wheel-straight quirk, which shifts
values only slightly)."""

import jax
import jax.numpy as jnp
import numpy as np

from montecarlo_tpu.cards import make_card
from montecarlo_tpu.rollout.equity import (
    canonical_hands,
    complement,
    equity_vs_hand,
    equity_vs_random,
    sample_distinct,
)

H, D, S, C = 0, 1, 2, 3


def test_sample_distinct_is_distinct_and_in_range():
    slots = np.asarray(sample_distinct(jax.random.key(0), 48, 5, 4096))
    assert slots.shape == (4096, 5)
    assert slots.min() >= 0 and slots.max() < 48
    for row in slots:
        assert len(set(row.tolist())) == 5


def test_sample_distinct_uniform_marginals():
    B = 40_000
    slots = np.asarray(sample_distinct(jax.random.key(1), 48, 5, B))
    counts = np.bincount(slots.reshape(-1), minlength=48)
    expected = B * 5 / 48
    # ~4167 per slot; allow 6 sigma of binomial noise.
    sigma = np.sqrt(B * 5 * (1 / 48) * (47 / 48))
    assert np.all(np.abs(counts - expected) < 6 * sigma), counts


def test_complement():
    dead = jnp.array([0, 13, 51, 7], jnp.int32)
    live = np.asarray(complement(dead))
    assert live.shape == (48,)
    assert set(live.tolist()) == set(range(52)) - {0, 13, 51, 7}
    assert sorted(live.tolist()) == live.tolist()


def test_aks_vs_qq_textbook_equity():
    hero = [make_card(H, 14), make_card(H, 13)]       # AKs
    villain = [make_card(D, 12), make_card(S, 12)]     # QQ
    res = equity_vs_hand(jax.random.key(2), hero, villain, 400_000,
                         batch_size=1 << 17)
    # Textbook ~0.4605; no-wheel shifts slightly. 400k rollouts: se ~ 8e-4.
    assert abs(res.equity - 0.460) < 0.006, res.equity
    lo, hi = res.ci95
    assert lo < res.equity < hi
    assert res.wins + res.ties + res.losses == res.n


def test_aa_dominates_kk():
    aa = [make_card(H, 14), make_card(D, 14)]
    kk = [make_card(H, 13), make_card(D, 13)]
    res = equity_vs_hand(jax.random.key(3), aa, kk, 100_000)
    assert 0.78 < res.equity < 0.86, res.equity  # textbook ~0.82


def test_equity_symmetry():
    hero = [make_card(H, 14), make_card(H, 13)]
    villain = [make_card(D, 12), make_card(S, 12)]
    a = equity_vs_hand(jax.random.key(4), hero, villain, 120_000)
    b = equity_vs_hand(jax.random.key(5), villain, hero, 120_000)
    assert abs(a.equity + b.equity - 1.0) < 0.01


def test_equity_vs_random_orders_hands():
    aa = [make_card(H, 14), make_card(D, 14)]
    seven_two = [make_card(H, 7), make_card(D, 2)]
    r_aa = equity_vs_random(jax.random.key(6), aa, 60_000)
    r_72 = equity_vs_random(jax.random.key(7), seven_two, 60_000)
    assert r_aa.equity > 0.80          # textbook ~0.85
    assert 0.28 < r_72.equity < 0.44   # textbook ~0.35
    assert r_aa.equity > r_72.equity + 0.3


def test_canonical_hands_shape():
    hands = canonical_hands()
    assert len(hands) == 169
    labels = [l for l, _ in hands]
    assert len(set(labels)) == 169
    assert labels[0] == "AA"
    assert "AKs" in labels and "AKo" in labels and "72o" in labels
    for _, (c1, c2) in hands:
        assert 0 <= c1 < 52 and 0 <= c2 < 52 and c1 != c2


def test_equity_exact_agrees_with_mc():
    from montecarlo_tpu.rollout.equity import equity_exact

    hero = [make_card(H, 14), make_card(H, 13)]       # AKs
    villain = [make_card(D, 12), make_card(S, 12)]     # QQ
    exact = equity_exact(hero, villain)
    assert exact.n == 1_712_304  # C(48, 5)
    assert exact.wins + exact.ties + exact.losses == exact.n
    assert abs(exact.equity - 0.460) < 0.01
    mc = equity_vs_hand(jax.random.key(9), hero, villain, 300_000)
    lo, hi = mc.ci95
    assert lo - 0.002 < exact.equity < hi + 0.002


def test_equity_exact_symmetric_matchup():
    from montecarlo_tpu.rollout.equity import equity_exact

    # AhKh vs AdKd: by suit symmetry equities are equal -> each 0.5.
    a = [make_card(H, 14), make_card(H, 13)]
    b = [make_card(D, 14), make_card(D, 13)]
    r = equity_exact(a, b)
    assert abs(r.equity - 0.5) < 1e-12


def test_expand_range():
    from montecarlo_tpu.rollout.equity import expand_range

    assert expand_range(["AA"]).shape == (6, 2)
    assert expand_range(["AKs"]).shape == (4, 2)
    assert expand_range(["AKo"]).shape == (12, 2)
    combos = expand_range(["QQ", "AKs"])
    assert combos.shape == (10, 2)


def test_equity_vs_range():
    from montecarlo_tpu.rollout.equity import equity_vs_range, expand_range

    hero = [make_card(H, 14), make_card(D, 14)]  # AA
    rng = expand_range(["QQ", "KK"])
    res = equity_vs_range(jax.random.key(11), hero, rng, 120_000)
    assert 0.77 < res.equity < 0.87, res.equity  # ~0.82 vs either pair

    # Degenerate one-combo range must match equity_vs_hand closely.
    villain = [[make_card(S, 12), make_card(C, 12)]]
    a = equity_vs_range(jax.random.key(12), hero, villain, 150_000)
    b = equity_vs_hand(jax.random.key(13), hero, villain[0], 150_000)
    assert abs(a.equity - b.equity) < 0.01

    # Hero-colliding combos are dropped (AA range vs AA hero leaves the
    # spade/club combo only).
    res2 = equity_vs_range(jax.random.key(14), hero, expand_range(["AA"]),
                           60_000)
    assert res2.n > 0


def test_partial_board_equity():
    from montecarlo_tpu.rollout.equity import equity_exact

    hero = [make_card(H, 14), make_card(H, 13)]       # AhKh
    villain = [make_card(D, 12), make_card(S, 12)]     # QQ
    flop = [make_card(H, 12), make_card(H, 7), make_card(H, 2)]  # hero flush!
    exact = equity_exact(hero, villain, board=flop)
    assert exact.n == 990  # C(45, 2)
    # Hero flopped the nut flush but villain flopped top set — a ~35%
    # boat/quads redraw (7 turn outs + ~10 river outs): hero ~0.65.
    assert 0.60 < exact.equity < 0.70, exact.equity
    mc = equity_vs_hand(jax.random.key(21), hero, villain, 120_000,
                        board=flop)
    assert abs(mc.equity - exact.equity) < 0.01

    turn = flop + [make_card(C, 12)]  # villain makes quads... sets up 44 rivers
    exact_t = equity_exact(hero, villain, board=turn)
    assert exact_t.n == 44
    # Villain has quad queens: hero is drawing dead.
    assert exact_t.equity == 0.0


def test_equity_multiway():
    from montecarlo_tpu.rollout.equity import equity_multiway

    hands = [
        [make_card(H, 14), make_card(D, 14)],   # AA
        [make_card(S, 13), make_card(C, 13)],   # KK
        [make_card(H, 7), make_card(D, 6)],     # 76o
    ]
    eq, n = equity_multiway(jax.random.key(31), hands, 150_000)
    assert abs(float(eq.sum()) - 1.0) < 1e-6  # equities partition the pot
    assert eq[0] > eq[1] > 0.15               # AA > KK
    assert eq[2] < 0.30                       # junk worst... but live cards
    # Textbook 3-way AA/KK/76o roughly 0.58/0.24/0.18.
    assert 0.5 < eq[0] < 0.68, eq

    # Two-hand multiway must agree with equity_vs_hand.
    two = equity_multiway(jax.random.key(32), hands[:2], 150_000)[0]
    pair = equity_vs_hand(jax.random.key(33), hands[0], hands[1], 150_000)
    assert abs(float(two[0]) - pair.equity) < 0.01


def test_overlapping_cards_rejected():
    import pytest as _pytest

    from montecarlo_tpu.rollout.equity import equity_exact, equity_multiway

    ah = make_card(H, 14)
    with _pytest.raises(ValueError):
        equity_vs_hand(jax.random.key(0), [ah, make_card(H, 13)],
                       [ah, make_card(D, 12)], 1000)
    with _pytest.raises(ValueError):
        equity_exact([ah, make_card(H, 13)], [make_card(D, 12), ah])
    with _pytest.raises(ValueError):
        equity_multiway(jax.random.key(0),
                        [[ah, make_card(H, 13)], [ah, make_card(D, 2)]], 1000)
    with _pytest.raises(ValueError):
        equity_vs_hand(jax.random.key(0), [ah, 99], [1, 2], 1000)


def test_exact_range_vs_range_matches_per_pair_loop():
    """Flop case small enough to cross-check every combo pair against the
    single-pair exact enumerator."""
    from montecarlo_tpu.rollout.equity import (
        equity_exact, equity_exact_range_vs_range, expand_range,
    )

    hero_r = expand_range(["QQ"])[:4]
    vill_r = expand_range(["AKs"])
    board = [make_card(0, 12), make_card(1, 7), make_card(2, 2)]  # Qh 7d 2s
    res = equity_exact_range_vs_range(hero_r, vill_r, board=board)

    weights = []
    eqs = []
    for i, h in enumerate(hero_r.tolist()):
        for j, v in enumerate(vill_r.tolist()):
            if set(h) & set(v) or set(h) & set(map(int, board)) \
                    or set(v) & set(map(int, board)):
                assert res.pair_weight[i, j] == 0
                continue
            e = equity_exact(h, v, board=board)
            assert res.pair_weight[i, j] == 1
            np.testing.assert_allclose(res.pair_equity[i, j], e.equity,
                                       atol=1e-12)
            weights.append(1.0)
            eqs.append(e.equity)
    np.testing.assert_allclose(res.equity, np.average(eqs, weights=weights),
                               atol=1e-12)


def test_exact_range_vs_range_symmetry():
    """eq(A vs B) + eq(B vs A) == 1 exactly (ties split half-half)."""
    from montecarlo_tpu.rollout.equity import (
        equity_exact_range_vs_range, expand_range,
    )

    a = expand_range(["TT", "A9s"])
    b = expand_range(["KQs", "66"])
    board = [make_card(0, 11), make_card(1, 8), make_card(2, 3),
             make_card(3, 13)]  # turn: fewer completions, exact both ways
    r1 = equity_exact_range_vs_range(a, b, board=board)
    r2 = equity_exact_range_vs_range(b, a, board=board)
    np.testing.assert_allclose(r1.equity + r2.equity, 1.0, atol=1e-12)
    np.testing.assert_array_equal(r1.pair_weight, r2.pair_weight.T)


def test_exact_range_vs_range_weighted():
    """Combo weights tilt the aggregate toward the weighted combos."""
    from montecarlo_tpu.rollout.equity import (
        equity_exact_range_vs_range, expand_range,
    )

    hero = expand_range(["AA"])
    vill = expand_range(["KK", "22"])
    board = [make_card(2, 9), make_card(3, 6), make_card(1, 4),
             make_card(0, 10)]
    w_kk = np.array([1.0] * 6 + [0.0] * 6)
    w_22 = np.array([0.0] * 6 + [1.0] * 6)
    r_kk = equity_exact_range_vs_range(hero, vill, None, w_kk, board=board)
    r_22 = equity_exact_range_vs_range(hero, vill, None, w_22, board=board)
    r_mix = equity_exact_range_vs_range(hero, vill, None, 0.5 * (w_kk + w_22),
                                        board=board)
    assert abs(r_mix.equity - 0.5 * (r_kk.equity + r_22.equity)) < 1e-9


def test_exact_vs_range_agrees_with_mc_preflop():
    """Preflop exact hand-vs-range agrees with the MC estimator within CI
    (the MC path samples combos card-removal-correctly by construction)."""
    from montecarlo_tpu.rollout.equity import (
        equity_exact_vs_range, equity_vs_range, expand_range,
    )

    hero = [make_card(0, 14), make_card(0, 13)]  # AhKh
    vill = expand_range(["QQ", "JJ"])
    exact = equity_exact_vs_range(hero, vill)
    mc = equity_vs_range(jax.random.key(3), hero, vill, 400_000)
    lo, hi = mc.ci95
    assert lo - 0.003 <= exact.equity <= hi + 0.003, (exact.equity, mc.ci95)


def test_equity_exact_multiway_two_hands_matches_equity_exact():
    from montecarlo_tpu.rollout.equity import (
        equity_exact, equity_exact_multiway,
    )

    hero = [make_card(0, 14), make_card(0, 13)]
    villain = [make_card(1, 12), make_card(2, 12)]
    flop = [make_card(3, 2), make_card(3, 9), make_card(1, 5)]
    eq = equity_exact_multiway([hero, villain], board=flop)
    ref = equity_exact(hero, villain, board=flop).equity
    assert abs(eq[0] - ref) < 1e-12 and abs(eq.sum() - 1.0) < 1e-12


def test_equity_exact_multiway_three_hands_sums_to_one():
    from montecarlo_tpu.rollout.equity import equity_exact_multiway

    trio = [[make_card(0, 14), make_card(0, 13)],
            [make_card(1, 12), make_card(2, 12)],
            [make_card(3, 11), make_card(3, 10)]]
    turn = [make_card(1, 2), make_card(2, 9), make_card(0, 5),
            make_card(2, 7)]
    eq = equity_exact_multiway(trio, board=turn)
    assert abs(eq.sum() - 1.0) < 1e-12 and np.all(eq >= 0)
