"""Packed-block engine vs the XLA engine, exact trajectories.

The packed engine's deterministic mode takes the raw per-step actions and
the per-hand 17-card deals as inputs, and must reproduce the XLA
``step_table`` engine bit-exactly when both consume the same streams:
stacks, hand counts, stage/cursor, seat masks, and the live street levels,
at several horizons. The generator mode is checked statistically against
``rollout.policy.random_policy``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from montecarlo_tpu.engine.replay import (
    decks_from_cards,
    replay_injected,
    replay_net_argmax,
)
from montecarlo_tpu.engine.state import TableConfig, init_state, redeal
from montecarlo_tpu.engine.step import _select_tree, clamp_action, step_table
from montecarlo_tpu.ops.pallas_engine import (
    TABLES_PER_BLOCK,
    pack_state,
    run_perpetual_det,
    unpack_field,
)

P = 6
N_CARDS = 2 * P + 5
T = TABLES_PER_BLOCK
HMAX = 12


def make_cfg(rules="reference"):
    # Capacities must match the kernel's (engine kernel L: 6 reference /
    # 10 otherwise; pots = 4 street slots), or the two sides would drop
    # layers at different points under adversarial streams.
    if rules == "reference":
        return TableConfig(num_seats=P, max_layers=6, max_pot_layers=24,
                           rules=rules, bets_impl="levels")
    return TableConfig(num_seats=P, max_layers=10, max_pot_layers=40,
                       rules=rules, bets_impl="levels")


CFG = make_cfg()


def _streams(seed):
    rng = np.random.default_rng(seed)
    # Raw policy actions: folds 20%, calls 72%, raises 8% (pre-clamp).
    # The real policy bounds raises per street; this stream does not, so
    # the raise rate stays low enough that blowing through the L=6 street
    # cap is rare (capacity-latched tables are excluded below).
    u = rng.random((48, T))
    actions = np.where(u < 0.20, -1,
                       np.where(u < 0.92, 0,
                                rng.integers(1, 21, (48, T)))).astype(np.int32)
    # Per-hand deals: 17 distinct cards per (table, hand).
    cards = np.argsort(rng.random((T, HMAX, 52)), axis=-1)[..., :N_CARDS]
    return actions, cards.astype(np.int32)


def _decks_from_cards(cards):
    """[T, H, 17] dealt cards -> [T, H, 52] decks (engine/replay.py)."""
    return decks_from_cards(cards, P)


def _replica(actions, decks, n_steps, cfg=CFG):
    """XLA engine driven by the same injected streams (engine/replay.py).
    Returns (final state, per-position settled delta sums, hands done,
    per-seat bust hand)."""
    return replay_injected(actions, decks, n_steps, cfg)


def _bitmask(bools):
    """[T, P] bool -> [T] int bitmask."""
    return (np.asarray(bools, np.int64)
            << np.arange(P)[None, :]).sum(axis=1).astype(np.int32)


@pytest.mark.parametrize("rules,n_steps,seed", [
    ("reference", 6, 11), ("reference", 24, 11), ("reference", 48, 11),
    ("standard", 24, 11), ("standard", 48, 11), ("tournament", 48, 11),
    ("reference", 48, 29), ("standard", 48, 29), ("tournament", 48, 29),
])
def test_kernel_matches_engine(rules, n_steps, seed):
    cfg = make_cfg(rules)
    actions, cards = _streams(seed)
    decks = _decks_from_cards(cards)

    packed = pack_state(cfg, cards[:, 0])
    from montecarlo_tpu.ops.pallas_engine import TILE
    act_in = jnp.asarray(
        actions[:n_steps].reshape(n_steps, *TILE)[None])
    cards_in = jnp.asarray(
        cards.transpose(1, 2, 0).reshape(HMAX, N_CARDS, *TILE)[None])
    out = run_perpetual_det(packed, act_in, cards_in, P, n_steps,
                            cfg.small_blind, cfg.big_blind, rules=rules)
    out = np.asarray(out)

    ref, ref_deltas, ref_done, ref_bust = _replica(actions, decks,
                                                    n_steps, cfg)

    def col(name, i=0):
        return np.asarray(unpack_field(out, cfg, name, i))

    # The injected stream raises more densely than the real policy's
    # per-street bound, so a few tables legitimately hit the L=6 street
    # cap; capacity-drop behavior is latched, excluded here, and must be
    # rare. Every other table must match field-for-field.
    clean = col("overflow") == 0
    frac = clean.mean()
    assert frac > 0.9, f"too many overflow tables ({1 - frac:.1%})"

    def eq(a, b, what):
        assert np.array_equal(a[clean], np.asarray(b)[clean]), what

    eq(col("hand_ct"), ref_done, "hand counts")
    eq(col("stage"), ref.stage, "stage")
    eq(col("cursor"), ref.cursor, "cursor")
    eq(col("folded"), _bitmask(ref.folded), "folded")
    eq(col("in_hand"), _bitmask(ref.in_hand), "in_hand")
    eq(col("to_act"), _bitmask(ref.to_act), "to_act")
    eq(col("order"), _bitmask(ref.order_mask), "order")
    eq(col("street_raises"), ref.street_raises, "street_raises")
    eq(col("last_raiser"), ref.last_raiser, "last_raiser")
    for k in range(P):
        eq(col("stacks", k), ref.stacks[:, k], f"stacks[{k}]")
    for j in range(cfg.max_layers):
        eq(col("lvl", j), ref.bets.level[:, j], f"lvl[{j}]")
        eq(col("ln", j), ref.bets.n[:, j], f"ln[{j}]")
    for k in range(P):
        eq(col("contrib", k), ref.bets.contrib[:, k], f"contrib[{k}]")
    for k in range(P):
        eq(col("delta_sum", k), ref_deltas[:, k], f"delta_sum[{k}]")
    if rules == "tournament":
        for k in range(P):
            eq(col("bust_at", k), ref_bust[:, k], f"bust_at[{k}]")
        # placements: valid permutations; on frozen tables the winner
        # (place 1) is the unique seat holding every chip
        from montecarlo_tpu.ops.pallas_engine import tournament_results

        places, frozen = tournament_results(out, cfg)
        assert np.all(np.sort(places, axis=1) == np.arange(1, P + 1))
        if frozen.any():
            winners = places[frozen] == 1
            stacks_seat = np.stack([col("stacks", k) for k in range(P)],
                                   axis=1)
            button = col("button")
            idxs = (np.arange(P)[None, :] - button[:, None]) % P
            seat_stacks = np.take_along_axis(stacks_seat, idxs, axis=1)
            assert np.all(seat_stacks[frozen][winners]
                          == P * cfg.starting_stack)
    # at least some hands completed at the longer horizons
    if n_steps >= 24:
        assert col("hand_ct").sum() > 0


def test_kernel_features_match_models():
    """The kernel's in-block feature builder must reproduce
    models.features.state_features exactly (same ops on CPU) on states
    reached by real play — feature parity is what makes the trained
    policy artifacts valid inside the kernel."""
    from montecarlo_tpu.models.features import NUM_FEATURES, state_features
    from montecarlo_tpu.ops import pallas_engine as pe

    cfg = make_cfg("standard")
    actions, cards = _streams(31)
    decks = _decks_from_cards(cards)
    n_steps = 24

    packed = pack_state(cfg, cards[:, 0])
    act_in = jnp.asarray(actions[:n_steps].reshape(n_steps, *pe.TILE)[None])
    cards_in = jnp.asarray(
        cards.transpose(1, 2, 0).reshape(HMAX, N_CARDS, *pe.TILE)[None])
    out = run_perpetual_det(packed, act_in, cards_in, P, n_steps,
                            cfg.small_blind, cfg.big_blind,
                            rules=cfg.rules)

    # kernel-side features on the packed output block
    layout, _ = pe._field_layout(P, cfg.rules)
    block = jnp.asarray(out[0])
    st = pe._unpack(block, layout)
    head, _, exists = pe._head_info(st, P)
    feats_k = jnp.stack(pe._features(st, head, P, cfg.big_blind),
                        axis=0).reshape(NUM_FEATURES, -1)

    # model-side features on the trajectory-equal XLA states
    ref, _, _, _ = _replica(actions, decks, n_steps, cfg)
    feats_m = jax.vmap(state_features)(ref)  # [T, NUM_FEATURES]

    live = np.asarray(exists).reshape(-1)
    got = np.asarray(feats_k).T[live]
    want = np.asarray(feats_m)[live]
    assert np.allclose(got, want, atol=1e-5), (
        np.abs(got - want).max(axis=0))


def test_kernel_heads_up():
    """P-genericity: the kernel's seat/layer unrolls are parameterized on
    num_seats — pin heads-up (P=2) trajectory equality too (the reference
    BASELINE config 1 shape)."""
    from montecarlo_tpu.ops import pallas_engine as pe

    P2 = 2
    n_cards = 2 * P2 + 5
    cfg = TableConfig(num_seats=P2, max_layers=6, max_pot_layers=24,
                      rules="reference", bets_impl="levels")
    rng = np.random.default_rng(17)
    n_steps, hmax = 32, 14
    u = rng.random((n_steps, T))
    actions = np.where(u < 0.20, -1,
                       np.where(u < 0.92, 0,
                                rng.integers(1, 21, (n_steps, T)))
                       ).astype(np.int32)
    cards = np.argsort(rng.random((T, hmax, 52)),
                       axis=-1)[..., :n_cards].astype(np.int32)

    packed = pe.pack_state(cfg, cards[:, 0])
    act_in = jnp.asarray(actions.reshape(n_steps, *pe.TILE)[None])
    cards_in = jnp.asarray(
        cards.transpose(1, 2, 0).reshape(hmax, n_cards, *pe.TILE)[None])
    out = np.asarray(run_perpetual_det(
        packed, act_in, cards_in, P2, n_steps,
        cfg.small_blind, cfg.big_blind))

    # XLA replica with injected streams (hole/burn offsets for P=2)
    base = 2 * P2
    pos = list(range(base)) + [base + 1, base + 2, base + 3, base + 5,
                               base + 7]
    decks = np.zeros((T, hmax, 52), np.int64)
    decks[..., pos] = cards
    unused_pos = [p for p in range(52) if p not in pos]
    for t in range(T):
        for h in range(hmax):
            decks[t, h, unused_pos] = np.setdiff1d(np.arange(52),
                                                   cards[t, h])

    def one(table_actions, table_decks):
        st = init_state(jax.random.key(0), cfg)
        st = redeal(st, table_decks[0])

        def body(carry, a):
            st, done_ct = carry
            prev = st.hand_idx
            nxt = step_table(st, clamp_action(st, a), rules=cfg.rules)
            done_ct = done_ct + (nxt.hand_idx != prev)
            redealt = redeal(nxt, table_decks[jnp.minimum(nxt.hand_idx,
                                                          hmax - 1)])
            nxt = _select_tree(nxt.hand_idx != prev, redealt, nxt)
            return (nxt, done_ct), None

        (st, done_ct), _ = jax.lax.scan(
            body, (st, jnp.zeros((), jnp.int32)), jnp.asarray(table_actions))
        return st, done_ct

    ref, ref_done = jax.vmap(one, in_axes=(1, 0))(
        jnp.asarray(actions), jnp.asarray(decks.astype(np.int32)))

    clean = np.asarray(unpack_field(out, cfg, "overflow")) == 0
    assert clean.mean() > 0.95

    def eq(a, b, what):
        assert np.array_equal(np.asarray(a)[clean],
                              np.asarray(b)[clean]), what

    eq(unpack_field(out, cfg, "hand_ct"), ref_done, "hand counts")
    eq(unpack_field(out, cfg, "stage"), ref.stage, "stage")
    for k in range(P2):
        eq(unpack_field(out, cfg, "stacks", k), ref.stacks[:, k],
           f"stacks[{k}]")
    assert np.asarray(unpack_field(out, cfg, "hand_ct")).sum() > 0


def xla_net_det_reference(cfg, bots_by_seat, decks, n_steps, hmax):
    """XLA net-pipeline trajectory driver for det-mode pinning
    (engine/replay.py; ``hmax`` is the stash depth of ``decks``)."""
    assert np.asarray(decks).shape[1] == hmax
    return replay_net_argmax(cfg, bots_by_seat, decks, n_steps)


def test_net_kernel_det_matches_xla_net_pipeline():
    """Deterministic NET mode (argmax pick, injected deals — the
    ES/league deployment shape) vs the XLA net pipeline: every seat plays a packed rule bot
    (models/bots.py — huge logit margins, so f32 summation-order ulps
    cannot flip the argmax), seats map to two banked nets exactly like
    league evaluation, and the trajectories must agree field-for-field."""
    from montecarlo_tpu.models.bots import panel
    from montecarlo_tpu.ops import pallas_engine as pe
    from montecarlo_tpu.ops.pallas_engine import (
        _stack_weights_league, run_net_det,
    )

    cfg = make_cfg("standard")
    rng = np.random.default_rng(43)
    n_steps, hmax = 32, 16
    cards = np.argsort(rng.random((T, hmax, 52)),
                       axis=-1)[..., :N_CARDS].astype(np.int32)
    decks = _decks_from_cards(cards)

    bots = panel()
    banks = [bots["jam_tight"], bots["fof_call"]]
    stb = (0,) + (1,) * (P - 1)  # jam_tight at seat 0, fof_call others
    bots_by_seat = [banks[b] for b in stb]

    packed = pack_state(cfg, cards[:, 0])
    cards_in = jnp.asarray(
        cards.transpose(1, 2, 0).reshape(hmax, N_CARDS, *pe.TILE)[None])
    weights = _stack_weights_league(banks)
    out = np.asarray(run_net_det(
        packed, cards_in, weights, P, n_steps, cfg.small_blind,
        cfg.big_blind, cfg.starting_stack, cfg.rules, n_banks=2,
        seat_to_bank=stb))

    ref, ref_done = xla_net_det_reference(cfg, bots_by_seat, decks,
                                          n_steps, hmax)

    clean = np.asarray(unpack_field(out, cfg, "overflow")) == 0
    assert clean.mean() > 0.95
    # the deal stash must cover every completed hand
    assert np.asarray(unpack_field(out, cfg, "hand_ct")).max() < hmax - 1

    def eq(a, b, what):
        assert np.array_equal(np.asarray(a)[clean],
                              np.asarray(b)[clean]), what

    eq(unpack_field(out, cfg, "hand_ct"), ref_done, "hand counts")
    eq(unpack_field(out, cfg, "stage"), ref.stage, "stage")
    eq(unpack_field(out, cfg, "cursor"), ref.cursor, "cursor")
    eq(unpack_field(out, cfg, "folded"), _bitmask(ref.folded), "folded")
    eq(unpack_field(out, cfg, "in_hand"), _bitmask(ref.in_hand),
       "in_hand")
    for k in range(P):
        eq(unpack_field(out, cfg, "stacks", k), ref.stacks[:, k],
           f"stacks[{k}]")
    for k in range(P):
        eq(unpack_field(out, cfg, "contrib", k), ref.bets.contrib[:, k],
           f"contrib[{k}]")
    assert np.asarray(unpack_field(out, cfg, "hand_ct")).sum() > 0
