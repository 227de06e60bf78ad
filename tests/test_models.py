"""Policy-network model family: features, net, REINFORCE training."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from montecarlo_tpu.engine.state import TableConfig, init_state
from montecarlo_tpu.models.features import NUM_FEATURES, state_features
from montecarlo_tpu.models.policy_net import (
    NUM_ACTIONS,
    action_from_index,
    init_params,
    net_policy,
    policy_logits,
)
from montecarlo_tpu.rollout.policy import always_call
from montecarlo_tpu.rollout.selfplay import play_hands


def test_features_shape_and_finite():
    cfg = TableConfig(num_seats=3)
    st = init_state(jax.random.key(0), cfg)
    f = state_features(st)
    assert f.shape == (NUM_FEATURES,)
    assert bool(jnp.all(jnp.isfinite(f)))
    # vmapped over a batch
    keys = jax.random.split(jax.random.key(1), 8)
    states = jax.vmap(lambda k: init_state(k, cfg))(keys)
    fb = jax.vmap(state_features)(states)
    assert fb.shape == (8, NUM_FEATURES)
    assert bool(jnp.all(jnp.isfinite(fb)))


def test_policy_net_forward_and_action_mapping():
    params = init_params(jax.random.key(0))
    cfg = TableConfig(num_seats=2)
    st = init_state(jax.random.key(1), cfg)
    logits = policy_logits(params, state_features(st))
    assert logits.shape == (NUM_ACTIONS,)
    acts = [int(action_from_index(jnp.asarray(i), st))
            for i in range(NUM_ACTIONS)]
    assert acts[0] == -1 and acts[1] == 0
    assert acts[2] == 20 and acts[3] >= acts[2]  # 2bb, pot-size


def test_net_policy_plays_full_hands():
    params = init_params(jax.random.key(0))
    cfg = TableConfig(num_seats=2, rules="standard")
    keys = jax.random.split(jax.random.key(2), 64)
    final = play_hands(keys, cfg, num_hands=1, policy=net_policy(params))
    assert bool(jnp.all(final.hand_over))
    sums = np.asarray(final.stacks).sum(axis=1)
    np.testing.assert_array_equal(sums, np.full_like(sums, 200))


@pytest.mark.slow
def test_reinforce_improves_vs_calling_station():
    from montecarlo_tpu.models.train import train_policy

    cfg = TableConfig(num_seats=2, rules="standard")
    out = train_policy(jax.random.key(3), cfg=cfg, opponent=always_call,
                       tables=512, steps=60, lr=5e-3)
    hist = np.asarray(out.mean_reward_bb)
    assert np.all(np.isfinite(hist))
    # Training signal: late-phase reward beats the early phase.
    assert hist[-15:].mean() > hist[:15].mean() + 0.05, (
        hist[:15].mean(), hist[-15:].mean())


def test_reinforce_one_step_runs():
    from montecarlo_tpu.models.train import train_policy

    cfg = TableConfig(num_seats=2, rules="standard")
    out = train_policy(jax.random.key(4), cfg=cfg, opponent=always_call,
                       tables=64, steps=2, lr=1e-3, max_steps=24)
    assert np.isfinite(np.asarray(out.mean_reward_bb)).all()


def test_push_fold_solver_logic_on_synthetic_matrix():
    from montecarlo_tpu.models.pushfold import solve_push_fold

    # Synthetic equity: hand i beats hand j with probability proportional
    # to rank separation -> the solver must produce monotone ranges.
    idx = np.arange(169, dtype=np.float64)
    strength = 1.0 - idx / 168.0  # hand 0 strongest
    eqm = 0.5 + 0.4 * (strength[:, None] - strength[None, :])
    sol10 = solve_push_fold(eqm, 10)
    sol5 = solve_push_fold(eqm, 5)
    # Strongest hand always jams/calls; weakest never (at 10bb).
    assert sol10.jam[0] > 0.9 and sol10.call[0] > 0.9
    assert sol10.jam[-1] < 0.1
    # Shallower stacks widen both ranges.
    assert sol5.jam_fraction >= sol10.jam_fraction
    assert sol5.call_fraction >= sol10.call_fraction


def test_push_fold_artifact_matches_published_nash():
    # The committed solution table (computed from 32k-rollout matchup
    # equities) must reproduce the textbook 10bb Nash numbers.
    import json
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data", "pushfold_ranges.json")
    with open(path) as f:
        table = json.load(f)["solutions"]
    ten = table["10bb"]
    assert 0.52 < ten["sb_jam_fraction"] < 0.64   # published ~0.58
    assert 0.32 < ten["bb_call_fraction"] < 0.44  # published ~0.37
    assert "AA" in ten["sb_jam_range"] and "AA" in ten["bb_call_range"]
    assert "32o" not in ten["sb_jam_range"]
    # Ranges widen as stacks shrink.
    assert (table["3bb"]["sb_jam_fraction"]
            > table["10bb"]["sb_jam_fraction"]
            > table["20bb"]["sb_jam_fraction"])


def test_pretrained_policy_artifact_loads_and_plays():
    import os

    from montecarlo_tpu.models.policy_net import load_params, net_policy

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data", "policy_hu_300.npz")
    params = load_params(path)
    cfg = TableConfig(num_seats=2, rules="standard")
    keys = jax.random.split(jax.random.key(77), 64)
    final = play_hands(keys, cfg, num_hands=1, policy=net_policy(params))
    assert bool(jnp.all(final.hand_over))


def test_all_combos_partition():
    from montecarlo_tpu.models.pushfold import _all_combos, _representatives

    combos, cls = _all_combos()
    assert combos.shape == (1326, 2) and cls.shape == (1326,)
    # class sizes are exactly the 6/4/12 combo counts
    _, _, _, w = _representatives()
    counts = np.bincount(cls, minlength=169)
    np.testing.assert_array_equal(counts, w.astype(np.int64))
    # no duplicate combos
    flat = {tuple(sorted(c)) for c in combos.tolist()}
    assert len(flat) == 1326


def test_matchup_pair_counts_invariants():
    from montecarlo_tpu.models.pushfold import (
        matchup_pair_counts, _representatives,
    )

    _, _, _, w = _representatives()
    n = matchup_pair_counts()
    # every row sums to combos(a) * C(50,2)
    np.testing.assert_array_equal(n.sum(axis=1), (w * 1225).astype(np.int64))
    # deal counts are symmetric: #(a,b) pairs == #(b,a) pairs
    np.testing.assert_array_equal(n, n.T)
    # blocker sanity: AA vs AA has 6*1=6 pairs (2 aces left -> 1 combo),
    # AA vs KK the full 6*6.
    labels = [l for l, _ in __import__(
        "montecarlo_tpu.rollout.equity", fromlist=["canonical_hands"]
    ).canonical_hands()]
    aa, kk = labels.index("AA"), labels.index("KK")
    assert n[aa, aa] == 6 * 1
    assert n[aa, kk] == 6 * 6


def test_push_fold_cr_solver_book_values():
    """CR solver on the round-1 exact matrix + true pair counts still lands
    on the textbook 10bb equilibrium (removal shifts ranges only slightly;
    the matrix itself is replaced by the CR artifact when built)."""
    import os

    from montecarlo_tpu.models.pushfold import (
        matchup_pair_counts, solve_push_fold_cr,
    )

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data", "pushfold_eq169_exact.npz")
    eq = np.load(path)["equity"]
    sol = solve_push_fold_cr(eq, matchup_pair_counts(), stack_bb=10.0)
    assert 0.50 < sol.jam_fraction < 0.66, sol.jam_fraction
    assert 0.30 < sol.call_fraction < 0.45, sol.call_fraction
    assert "AA" in sol.jam_range() and "AA" in sol.call_range()
    assert "72o" not in sol.call_range()


def test_push_fold_cr_artifact_matches_book():
    """The committed card-removal-correct artifact reproduces the textbook
    10bb heads-up Nash equilibrium (jam ~58.4%, call ~37.7%) with NO
    removal approximation (exact combo-pair enumeration)."""
    import json
    import os

    base = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data")
    npz = os.path.join(base, "pushfold_eq169_cr.npz")
    rj = os.path.join(base, "pushfold_ranges_cr.json")
    if not (os.path.exists(npz) and os.path.exists(rj)):
        import pytest
        pytest.skip("CR artifacts not built")
    with np.load(npz) as d:
        eq, n_pairs = d["equity"], d["n_pairs"]
    assert eq.shape == (169, 169) and n_pairs.shape == (169, 169)
    # exact complementarity: class-pair equities + transpose == 1
    np.testing.assert_allclose(eq + eq.T, 1.0, atol=1e-9)
    np.testing.assert_array_equal(n_pairs, n_pairs.T)
    with open(rj) as f:
        ranges = json.load(f)["stacks_bb"]
    assert abs(ranges["10"]["jam_fraction"] - 0.584) < 0.02
    assert abs(ranges["10"]["call_fraction"] - 0.377) < 0.02
    # monotone: shallower stacks jam and call wider
    fracs = [ranges[s]["jam_fraction"] for s in ("3", "5", "10", "20")]
    assert fracs == sorted(fracs, reverse=True)


def test_es_trainer_improves_toy_fitness():
    """ES machinery sanity on an analytic objective: fitness is a smooth
    function of the flattened weights with a known optimum direction; the
    trainer must ascend it. (The packed-engine evaluator is exercised by
    the tests below and, at full size, by scripts/train_es_kernel.py.)"""
    import numpy as np

    from montecarlo_tpu.models.policy_net import init_params
    from montecarlo_tpu.models.train_es import _flatten, train_es

    params0 = init_params(jax.random.key(0))
    vec0, _ = _flatten(params0)
    target = np.asarray(
        jax.random.normal(jax.random.key(1), (16,))) * 0.5

    def eval_fn(params, eval_seed):
        # Fitness depends on a 16-dim slice (ES progress per generation
        # scales like pop/dim, so a full-width toy would need hundreds of
        # generations); the remaining coordinates drift harmlessly.
        from montecarlo_tpu.models.train_es import _flatten as fl
        v, _ = fl(params)
        return -float(np.mean((np.asarray(v)[:16] - target) ** 2)), 100

    out = train_es(3, params0, eval_fn, generations=40, pop=8,
                   sigma=0.05, lr=0.1)
    assert out.fitness_history[-5:].mean() > out.fitness_history[:5].mean()
    assert out.hands_total == 40 * 16 * 100


def test_es_pop_path_matches_per_candidate():
    """eval_pop_fn receives the generation ordered [+e0, -e0, +e1, ...];
    with a deterministic evaluator the population-batched path must
    reproduce the per-candidate trajectory exactly (same perturbations,
    same fitnesses, same updates)."""
    import numpy as np

    from montecarlo_tpu.models.policy_net import init_params
    from montecarlo_tpu.models.train_es import _flatten, train_es

    params0 = init_params(jax.random.key(0))
    target = np.asarray(
        jax.random.normal(jax.random.key(1), (16,))) * 0.5

    def fitness(params):
        from montecarlo_tpu.models.train_es import _flatten as fl
        v, _ = fl(params)
        return -float(np.mean((np.asarray(v)[:16] - target) ** 2))

    def eval_fn(params, eval_seed):
        return fitness(params), 100

    def eval_pop_fn(params_list, eval_seed):
        return [fitness(p) for p in params_list], \
            [100] * len(params_list)

    a = train_es(3, params0, eval_fn, generations=6, pop=4,
                 sigma=0.05, lr=0.1)
    b = train_es(3, params0, eval_pop_fn=eval_pop_fn, generations=6,
                 pop=4, sigma=0.05, lr=0.1)
    assert np.allclose(a.fitness_history, b.fitness_history)
    assert a.hands_total == b.hands_total
    va, _ = _flatten(a.params)
    vb, _ = _flatten(b.params)
    assert bool(jnp.all(va == vb))


def test_league_block_diagonal_weights_equivalent():
    """_stack_weights_league flattens S nets into one wide MLP with
    block-diagonal w2/w3; bank s's [4] logit group must equal the plain
    per-net forward pass exactly (the kernel selects the group by head
    seat — tests/check on hardware pin the selection; this pins the
    algebra)."""
    import numpy as np

    from montecarlo_tpu.models.policy_net import init_params, policy_logits
    from montecarlo_tpu.ops.pallas_engine import _stack_weights_league

    nets = [init_params(jax.random.key(k)) for k in range(3)]
    w1t, b1, w2t, b2, w3t, b3 = _stack_weights_league(nets)
    feats = jax.random.normal(jax.random.key(9), (NUM_FEATURES,))

    h = jnp.maximum(w1t @ feats + b1[:, 0], 0.0)
    h = jnp.maximum(w2t @ h + b2[:, 0], 0.0)
    wide = w3t @ h + b3[:, 0]
    for s, p in enumerate(nets):
        direct = policy_logits(p, feats)
        assert np.allclose(np.asarray(wide[4 * s:4 * s + 4]),
                           np.asarray(direct), atol=1e-5)


def test_es_flatten_roundtrip():
    from montecarlo_tpu.models.policy_net import init_params
    from montecarlo_tpu.models.train_es import _flatten, _unflatten

    p = init_params(jax.random.key(2))
    vec, spec = _flatten(p)
    q = _unflatten(vec, spec)
    for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(q)):
        assert a.shape == b.shape
        assert bool(jnp.all(a == b))


def test_es_returns_best_mean_center():
    """When fitness peaks mid-run and then declines, ES must return the
    center AT the peak generation (== the final center of a run stopped
    there), not the drifted last center."""
    import numpy as np

    from montecarlo_tpu.models.policy_net import init_params
    from montecarlo_tpu.models.train_es import _flatten, train_es

    params0 = init_params(jax.random.key(0))
    sched = [0.0, 1.0, 2.0, 1.0, 0.0]

    def eval_pop_fn(params_list, eval_seed):
        g = eval_seed - 3 * 1_000_003
        # tiny candidate-dependent jitter keeps the spread nonzero
        fits = [sched[g] + 1e-6 * i for i in range(len(params_list))]
        return fits, [100] * len(params_list)

    a = train_es(3, params0, eval_pop_fn=eval_pop_fn, generations=5,
                 pop=4, sigma=0.05, lr=0.1)
    b = train_es(3, params0, eval_pop_fn=eval_pop_fn, generations=2,
                 pop=4, sigma=0.05, lr=0.1)
    va, _ = _flatten(a.params)
    vb, _ = _flatten(b.final_params)
    assert int(np.argmax(a.fitness_history)) == 2
    assert bool(jnp.all(va == vb))
    vf, _ = _flatten(a.final_params)
    assert not bool(jnp.all(va == vf))


def test_es_noise_floor_damps_collapsed_spread():
    """With pair differences far below the noise floor, the update must
    damp toward zero instead of standardizing measurement noise into a
    full lr-sized random-walk step (the observed league-run failure)."""
    import numpy as np

    from montecarlo_tpu.models.policy_net import init_params
    from montecarlo_tpu.models.train_es import _flatten, train_es

    params0 = init_params(jax.random.key(0))
    vec0, _ = _flatten(params0)

    def eval_pop_fn(params_list, eval_seed):
        fits = [1e-7 * i for i in range(len(params_list))]
        return fits, [100] * len(params_list)

    drift = train_es(3, params0, eval_pop_fn=eval_pop_fn, generations=5,
                     pop=4, sigma=0.05, lr=0.1)
    damped = train_es(3, params0, eval_pop_fn=eval_pop_fn, generations=5,
                      pop=4, sigma=0.05, lr=0.1, noise_floor=0.01)
    vd, _ = _flatten(drift.final_params)
    vn, _ = _flatten(damped.final_params)
    assert float(jnp.abs(vd - vec0).max()) > 1e-3       # noise amplified
    assert float(jnp.abs(vn - vec0).max()) < 1e-4       # damped


def test_es_center_eval_fn_selects_best_holdout():
    """With center_eval_fn given, the snapshot criterion is the holdout
    evaluation (not the noisy per-generation mean): the returned params
    must be the exact center seen at the best-scoring call."""
    import numpy as np

    from montecarlo_tpu.models.policy_net import init_params
    from montecarlo_tpu.models.train_es import _flatten, train_es

    params0 = init_params(jax.random.key(0))
    scores = iter([0.0, 5.0, 1.0, 0.5, 0.5, 0.5])
    seen = []

    def center_eval(params):
        v, _ = _flatten(params)
        seen.append(np.asarray(v).copy())
        return next(scores)

    def eval_pop_fn(params_list, eval_seed):
        # means are deliberately deceptive: huge and increasing
        return [100.0 + eval_seed + 1e-3 * i
                for i in range(len(params_list))], \
            [1] * len(params_list)

    out = train_es(3, params0, eval_pop_fn=eval_pop_fn, generations=5,
                   pop=4, sigma=0.05, lr=0.1, center_eval_fn=center_eval,
                   center_eval_every=1)
    vbest, _ = _flatten(out.params)
    assert len(seen) == 5
    assert bool(jnp.all(vbest == jnp.asarray(seen[1])))  # score 5.0


def test_bot_constructors_implement_their_rules():
    from montecarlo_tpu.models.bots import (
        _HOLE, action_bot, panel, threshold_bot,
    )

    rng = np.random.default_rng(0)
    feats = jnp.asarray(rng.uniform(0.0, 1.0, (32, NUM_FEATURES)),
                        jnp.float32)

    # Pure-action bots argmax their action on any input.
    for a in range(4):
        logits = policy_logits(action_bot(a), feats)
        assert np.all(np.argmax(np.asarray(logits), axis=1) == a)

    # Threshold bot: hi above, lo below, others never competitive.
    bot = threshold_bot(_HOLE, 1.0, hi=3, lo=0)
    s = sum(w * np.asarray(feats[:, i]) for i, w in _HOLE.items())
    logits = np.asarray(policy_logits(bot, feats))
    margin = np.abs(s - 1.0) > 0.01
    want = np.where(s > 1.0, 3, 0)
    assert np.all(np.argmax(logits, axis=1)[margin] == want[margin])
    assert np.all(logits[:, 1] < np.maximum(logits[:, 0], logits[:, 3]))
    assert np.all(logits[:, 2] < np.maximum(logits[:, 0], logits[:, 3]))

    # bf16-robustness property: a matrix unit may round its INPUTS to
    # bf16, so hidden activations must stay near zero where bf16
    # granularity is relative (an affine +C offset construction was
    # measured to erase small score terms on hardware — bots.py
    # docstring). Pin both the activation bound and survival of the
    # decision under explicit bf16 rounding of every matmul input.
    def bf16(x):
        return jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)

    h1 = np.asarray(jax.nn.relu(feats @ bot.w1 + bot.b1))
    assert h1.max() <= 4.0
    hb = jax.nn.relu(bf16(feats) @ bf16(bot.w1) + bot.b1)
    hb = jax.nn.relu(bf16(hb) @ bf16(bot.w2) + bot.b2)
    lb = np.asarray(bf16(hb) @ bf16(bot.w3) + bot.b3)
    wide = np.abs(s - 1.0) > 0.02   # allow bf16's ~0.4% score warp
    assert np.all(np.argmax(lb, axis=1)[wide] == want[wide])

    # Spec hands: AA jams, AKo jams (0.96 < 1.0 -> folds at tight,
    # jams at loose), 72o folds everywhere.
    def hole_feats(r0, r1, suited, paired):
        f = np.zeros(NUM_FEATURES, np.float32)
        f[16], f[17], f[18], f[19] = r0 / 14, r1 / 14, suited, paired
        return jnp.asarray(f[None])

    tight = threshold_bot(_HOLE, 1.00, hi=3, lo=0)
    loose = threshold_bot(_HOLE, 0.85, hi=3, lo=0)
    aa = hole_feats(14, 14, 0, 1)
    ako = hole_feats(14, 13, 0, 0)
    s72 = hole_feats(7, 2, 0, 0)
    assert int(np.argmax(policy_logits(tight, aa))) == 3
    assert int(np.argmax(policy_logits(tight, ako))) == 0
    assert int(np.argmax(policy_logits(loose, ako))) == 3
    assert int(np.argmax(policy_logits(loose, s72))) == 0

    # Panel builds and every member forward-passes.
    for name, p in panel().items():
        out = policy_logits(p, feats)
        assert out.shape == (32, 4), name
        assert np.all(np.isfinite(np.asarray(out))), name


def test_bots_play_full_hands_through_the_engine():
    from montecarlo_tpu.models.bots import panel

    cfg = TableConfig(num_seats=3, rules="standard")
    keys = jax.random.split(jax.random.key(5), 32)
    for name, p in list(panel().items()):
        final = play_hands(keys, cfg, num_hands=1, policy=net_policy(p))
        assert bool(jnp.all(final.hand_over)), name
        sums = np.asarray(final.stacks).sum(axis=1)
        np.testing.assert_array_equal(sums, np.full_like(sums, 300))


def test_ladder_bot_three_way_rule():
    """ladder_bot: argmax(policy_logits) == (top if s1>t1 else mid if
    s2>t2 else bot) on synthetic feature grids, away from the documented
    cap/slope transition bands."""
    from montecarlo_tpu.models.bots import ladder_bot
    from montecarlo_tpu.models.features import NUM_FEATURES
    from montecarlo_tpu.models.policy_net import policy_logits

    rng = np.random.default_rng(3)

    def norm(v, t):
        # joint (score, threshold) scaling into the guarded bf16-safe
        # range — the same pre-normalization real callers apply
        # (scripts/opt_bot.py:_norm_rule); the decision s > t and the
        # clear-band geometry below scale with it
        c = max(1.0, (2.0 * float(np.abs(v).sum()) + abs(t)) / 4.0)
        return (v / c).astype(np.float32), t / c, c

    s1_vec, t1, c1 = norm(rng.normal(size=NUM_FEATURES), 0.4)
    s2_vec, t2, c2 = norm(rng.normal(size=NUM_FEATURES), -0.2)
    p = ladder_bot(dict(enumerate(s1_vec)), t1,
                   dict(enumerate(s2_vec)), t2, top=3, mid=1, bot=0)

    band = 0.25 / 4.0  # cap/slope transition width
    feats = rng.uniform(-1, 1, size=(4096, NUM_FEATURES)) \
        .astype(np.float32)
    s1 = feats @ s1_vec
    s2 = feats @ s2_vec
    clear = (np.abs(s1 - t1) > band) & (np.abs(s2 - t2) > band)
    feats, s1, s2 = feats[clear], s1[clear], s2[clear]
    assert len(feats) > 1000
    want = np.where(s1 > t1, 3, np.where(s2 > t2, 1, 0))
    got = np.asarray(jnp.argmax(policy_logits(p, jnp.asarray(feats)),
                                axis=-1))
    np.testing.assert_array_equal(got, want)


def test_pool_eval_pop_fn_averages_over_opponents(monkeypatch):
    """kernel_pool_eval_pop_fn: fitness = mean over pool members, hands
    summed, one shared initial state per eval seed (CRN across members),
    random members routed to the net-eval pop kernel and net/bot members
    to the league pop kernel."""
    from montecarlo_tpu.models import train_es as te
    from montecarlo_tpu.models.bots import action_bot
    from montecarlo_tpu.ops import pallas_engine as pe

    calls = []
    token = object()

    def fake_initial(seed, cfg, n_tables):
        return token

    def fake_eval_pop(seed, cfg, cands, net_seats, n_tables, n_steps,
                      state0):
        calls.append(("random", state0))
        m = np.full((len(cands), cfg.num_seats), 0.1)
        return m, None, np.full(len(cands), 100)

    def fake_league_pop(seed, cfg, cands, opp, n_tables, n_steps,
                        seat_to_bank, state0):
        calls.append(("league", state0))
        m = np.full((len(cands), cfg.num_seats), 0.3)
        return m, None, np.full(len(cands), 200)

    monkeypatch.setattr(pe, "initial_packed_state", fake_initial)
    monkeypatch.setattr(pe, "selfplay_net_eval_pop", fake_eval_pop)
    monkeypatch.setattr(pe, "selfplay_net_league_pop", fake_league_pop)

    cfg = TableConfig(num_seats=6, rules="standard")
    f = te.kernel_pool_eval_pop_fn(
        cfg, [None, action_bot(1)], n_tables=64, n_steps=8)
    cands = [init_params(jax.random.key(i)) for i in range(4)]
    fits, hands = f(cands, eval_seed=7)

    np.testing.assert_allclose(np.asarray(fits), 0.2)  # (0.1+0.3)/2
    assert hands == 4 * 100 + 4 * 200
    assert [k for k, _ in calls] == ["random", "league"]
    assert all(s is token for _, s in calls)  # shared state0


def test_pool_eval_pop_fn_lone_geometry_sums_candidate_seats(monkeypatch):
    """'lone' pool components: the opponent sits alone at ``seat`` and
    fitness is the SUM over the candidate's P-1 seats (= minus the
    opponent's extraction under conservation — the probe's scale), not
    the mean (which would enter the pool average at 1/(P-1) magnitude).
    Also pins that a bare MLPParams opponent (a NamedTuple, hence a
    tuple subclass) is NOT mistaken for an (opp, geometry) pair."""
    from montecarlo_tpu.models import train_es as te
    from montecarlo_tpu.models.bots import action_bot
    from montecarlo_tpu.ops import pallas_engine as pe

    stbs = []
    per_seat = np.arange(6) * 0.1  # seat k pays k/10 bb

    def fake_initial(seed, cfg, n_tables):
        return object()

    def fake_league_pop(seed, cfg, cands, opp, n_tables, n_steps,
                        seat_to_bank, state0):
        stbs.append(seat_to_bank)
        m = np.tile(per_seat, (len(cands), 1))
        return m, None, np.full(len(cands), 50)

    monkeypatch.setattr(pe, "initial_packed_state", fake_initial)
    monkeypatch.setattr(pe, "selfplay_net_league_pop", fake_league_pop)

    cfg = TableConfig(num_seats=6, rules="standard")
    bot = action_bot(1)
    f = te.kernel_pool_eval_pop_fn(cfg, [(bot, "lone"), bot],
                                   n_tables=64, n_steps=8)
    cands = [init_params(jax.random.key(i)) for i in range(3)]
    fits, hands = f(cands, eval_seed=7)

    lone = per_seat[1:].sum()   # candidate occupies seats 1..5
    five = per_seat[0]          # bare entry: candidate alone at seat 0
    np.testing.assert_allclose(np.asarray(fits), (lone + five) / 2)
    assert hands == 3 * 50 * 2
    # lone: opponent (bank 1) holds seat 0; five: candidate holds seat 0
    assert stbs == [(1, 0, 0, 0, 0, 0), (0, 1, 1, 1, 1, 1)]


def test_es_checkpoint_fn_cadence_and_payload():
    """checkpoint_fn fires with center evals (every center_eval_every
    plus the last generation) and carries the best-by-holdout params and
    its quality (monotone non-decreasing)."""
    from montecarlo_tpu.models.train_es import train_es

    target = np.zeros(2, np.float32)
    p0 = MLPParamsToy = None  # noqa: F841 (readability)
    base = init_params(jax.random.key(0), hidden=4)

    def eval_pop(cands, seed):
        fits = [-float(np.square(np.asarray(c.b3[:2])).sum())
                for c in cands]
        return np.asarray(fits), len(cands)

    calls = []

    def center_eval(p):
        return -float(np.square(np.asarray(p.b3[:2])).sum())

    def checkpoint(g, center, best, best_quality):
        calls.append((g, float(best_quality)))

    train_es(3, base, eval_pop_fn=eval_pop, generations=21, pop=4,
             sigma=0.1, lr=0.2, center_eval_fn=center_eval,
             center_eval_every=10, checkpoint_fn=checkpoint)

    gens = [g for g, _ in calls]
    assert gens == [0, 10, 20]
    quals = [q for _, q in calls]
    assert quals == sorted(quals)  # best-by-holdout never regresses


def test_es_adapt_hook_cadence_and_pool_mutation():
    """--adapt-every machinery: adapt_fn fires at generations 0, N, 2N
    with the CURRENT center, and an in-place swap of the opponent pool
    is visible to the very next eval_pop_fn call (the pool evaluator
    re-reads its opponents list per call — train_es.py docstring)."""
    import numpy as np

    from montecarlo_tpu.models.policy_net import init_params
    from montecarlo_tpu.models.train_es import _flatten, train_es

    params0 = init_params(jax.random.key(0))
    pool = ["attacker_v0"]          # the mutable shared pool
    seen_at = []                    # (gen, pool-version-at-next-eval)
    gen_counter = [0]

    def adapt_fn(g, center):
        from montecarlo_tpu.models.train_es import _flatten as fl
        v, _ = fl(center)
        assert np.all(np.isfinite(np.asarray(v)))
        pool[0] = f"attacker_v{g}"  # swap in place
        seen_at.append(g)

    def eval_pop_fn(params_list, eval_seed):
        # record which attacker version this generation trains against
        gen_counter[0] += 1
        eval_pool_log.append(pool[0])
        return [0.0] * len(params_list), [1] * len(params_list)

    eval_pool_log = []
    train_es(3, params0, eval_pop_fn=eval_pop_fn, generations=7, pop=2,
             sigma=0.05, lr=0.1, adapt_fn=adapt_fn, adapt_every=3)
    assert seen_at == [0, 3, 6]
    # generation g trains against the refresh from the latest multiple
    # of adapt_every <= g
    assert eval_pool_log == ["attacker_v0"] * 3 + ["attacker_v3"] * 3 \
        + ["attacker_v6"]


def test_resolve_opponent_adaptive_spec():
    """'adaptive:T-M[-B][@lone]' resolves to a placeholder slot (params
    None) carrying its geometry; the trainer refreshes it at gen 0
    before any fitness evaluation reads it."""
    from scripts.train_es_kernel import resolve_opponent

    tag, params, geom = resolve_opponent("adaptive:3-0")
    assert tag == "adaptive:3-0" and params is None and geom == "five"
    tag, params, geom = resolve_opponent("adaptive:3-1-0@lone")
    assert tag == "adaptive:3-1-0" and params is None and geom == "lone"
