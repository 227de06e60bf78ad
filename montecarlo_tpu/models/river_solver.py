"""Exact heads-up river subgame solver (CFR+): the multi-street
equilibrium anchor.

The repo's only game-theoretic ground truth so far was preflop push/fold
(models/pushfold.py). This module solves a POSTFLOP subgame exactly — a
classic one-street river game — so (i) the engine's pot/payout mechanics
can be validated against solver EVs end-to-end, and (ii) trained
policy artifacts get a true Nash-gap meter on at least one subgame
instead of only relative panel numbers. The reference has no solver or
evaluation machinery (its stated purpose is "a poker server to test
AIs", README.md:9); the showdown comparisons ride the same packed hand
key as the engine (``hand_evaluator.clj:112-133`` semantics via
``ops/evaluator.py``, exhaustively certified).

Game definition
---------------
Heads-up on a FIXED 5-card board. Each player holds one combo from a
range (uniform prior over card-removal-consistent pairs). ``pot`` chips
are already in the middle; one bet size ``bet`` and one raise size
``raise_`` (raise TO ``bet + raise_``):

    P1: check | bet
      check -> P2: check (showdown, pot) | bet
                 check-bet -> P1: fold | call (showdown, pot+2B)
      bet   -> P2: fold | call (showdown, pot+2B) | raise
                 bet-raise -> P1: fold | call (showdown, pot+2(B+R))

Payoffs are P1's net chips from river start (w = P1 pot share: win 1,
tie 0.5, loss 0); the game is constant-sum (P1 + P2 = pot):

    cc: w*pot            xbf: 0            xbc: w*(pot+2B) - B
    bf: pot              bc:  w*(pot+2B) - B
    brf: -B              brc: w*(pot+2(B+R)) - (B+R)

Solver: CFR+ (Tammelin 2014; public method) with alternating updates,
regret-matching+, and linearly-weighted average strategies. Everything
is vectorized over combos — each traversal is a handful of [H, V]
elementwise float32 products and sums (f32 is ample at these
magnitudes). Convergence is certified by the exploitability gap
``br1 + br2 - pot`` (zero at Nash), not by iteration count.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

F32 = jnp.float32


class RiverGame(NamedTuple):
    W: jax.Array      # [H, V] P1 pot share (1 / 0.5 / 0)
    mask: jax.Array   # [H, V] card-removal-valid pair indicator (f32)
    pot: float
    bet: float
    raise_: float
    # Tree gates: disabling P2's bet-after-check and raise collapses the
    # tree to the classic HALF-STREET game, whose closed-form solution
    # (bluff ratio B/(pot+B), call frequency pot/(pot+B)) anchors the
    # solver in tests/test_river_solver.py.
    p2_can_bet: bool = True
    p2_can_raise: bool = True


class RiverStrategy(NamedTuple):
    """Average strategies; rows sum to 1 where the combo is live."""
    s0: jax.Array  # [H, 2] P1 root: check / bet
    s1: jax.Array  # [V, 2] P2 after check: check / bet
    s2: jax.Array  # [H, 2] P1 after check-bet: fold / call
    s3: jax.Array  # [V, 3] P2 after bet: fold / call / raise
    s4: jax.Array  # [H, 2] P1 after bet-raise: fold / call


def all_combos(board: Sequence[int]) -> np.ndarray:
    """All C(47, 2) hole combos from the cards not on the board."""
    dead = set(int(c) for c in board)
    live = [c for c in range(52) if c not in dead]
    return np.array([(a, b) for i, a in enumerate(live)
                     for b in live[i + 1:]], np.int32)


def make_river_game(board: Sequence[int],
                    hero_combos: Optional[np.ndarray] = None,
                    villain_combos: Optional[np.ndarray] = None,
                    pot: float = 4.0, bet: float = 2.0,
                    raise_: float = 6.0) -> Tuple[RiverGame, np.ndarray,
                                                  np.ndarray]:
    """Build the payoff/validity matrices from the certified evaluator.

    Combos default to every 2-card hand off the board (uniform random
    ranges). Returns (game, hero_combos, villain_combos)."""
    from montecarlo_tpu.ops.evaluator import (
        eval_masks_impl, suit_masks_from_cards,
    )

    board = np.asarray(board, np.int32)
    assert board.shape == (5,)
    if hero_combos is None:
        hero_combos = all_combos(board)
    if villain_combos is None:
        villain_combos = all_combos(board)
    hero_combos = np.asarray(hero_combos, np.int32)
    villain_combos = np.asarray(villain_combos, np.int32)

    def keys(combos):
        cards = jnp.concatenate([
            jnp.asarray(combos),
            jnp.broadcast_to(jnp.asarray(board)[None],
                             (len(combos), 5))], axis=1)
        return jax.vmap(
            lambda c: eval_masks_impl(*suit_masks_from_cards(c)))(cards)

    kh = np.asarray(keys(hero_combos)).astype(np.uint32)
    kv = np.asarray(keys(villain_combos)).astype(np.uint32)
    W = (kh[:, None] > kv[None, :]).astype(np.float32) \
        + 0.5 * (kh[:, None] == kv[None, :]).astype(np.float32)

    hc = hero_combos
    vc = villain_combos
    clash = ((hc[:, None, 0] == vc[None, :, 0])
             | (hc[:, None, 0] == vc[None, :, 1])
             | (hc[:, None, 1] == vc[None, :, 0])
             | (hc[:, None, 1] == vc[None, :, 1]))
    mask = (~clash).astype(np.float32)
    return (RiverGame(jnp.asarray(W), jnp.asarray(mask),
                      float(pot), float(bet), float(raise_)),
            hero_combos, villain_combos)


def _payoffs(game: RiverGame):
    """Terminal P1 utilities as [H, V] matrices / scalars."""
    W, pot, B, R = game.W, game.pot, game.bet, game.raise_
    return dict(
        cc=pot * W,
        xbc=(pot + 2 * B) * W - B,
        bc=(pot + 2 * B) * W - B,
        brc=(pot + 2 * (B + R)) * W - (B + R),
        bf=pot,      # P2 folds to the bet
        xbf=0.0,     # P1 folds after check-bet
        brf=-B,      # P1 folds after bet-raise
    )


def _normalize(r, allow=None):
    """Regret-matching: positive part normalized; uniform over allowed
    actions if all regrets <= 0. ``allow``: optional [n_actions] 0/1
    gate (tree-config action removal)."""
    p = jnp.maximum(r, 0.0)
    if allow is not None:
        a = jnp.asarray(allow, r.dtype)
        p = p * a[None]
        fallback = a[None] / jnp.sum(a)
    else:
        fallback = jnp.ones_like(r) / r.shape[-1]
    tot = jnp.sum(p, axis=-1, keepdims=True)
    return jnp.where(tot > 0, p / jnp.where(tot > 0, tot, 1.0), fallback)


def _gates(game: RiverGame):
    g1 = jnp.array([1.0, 1.0 if game.p2_can_bet else 0.0], F32)
    g3 = jnp.array([1.0, 1.0, 1.0 if game.p2_can_raise else 0.0], F32)
    return g1, g3


def _p1_values(game, U, s1, s2, s3, s4):
    """P1 action values [H] at each node vs P2 strategy (counterfactual:
    weighted by mask * P2 reach; P1's own strategy excluded)."""
    m = game.mask
    pot, B = game.pot, game.bet
    # node 4 (after bet-raise); P2 reach = s3[:, 2]
    r4 = m * s3[None, :, 2]
    v4 = jnp.stack([jnp.sum(r4, 1) * (-B),
                    jnp.sum(r4 * U["brc"], 1)], axis=1)        # [H, 2]
    # node 2 (after check-bet); P2 reach = s1[:, 1]
    r2 = m * s1[None, :, 1]
    v2 = jnp.stack([jnp.zeros(m.shape[0]),
                    jnp.sum(r2 * U["xbc"], 1)], axis=1)        # [H, 2]
    # node 0
    v4_cur = jnp.sum(s4 * v4, axis=1)
    v2_cur = jnp.sum(s2 * v2, axis=1)
    v_check = jnp.sum(m * s1[None, :, 0] * U["cc"], 1) + v2_cur
    v_bet = (jnp.sum(m * s3[None, :, 0], 1) * pot
             + jnp.sum(m * s3[None, :, 1] * U["bc"], 1)
             + v4_cur)
    v0 = jnp.stack([v_check, v_bet], axis=1)                   # [H, 2]
    return v0, v2, v4


def _p2_values(game, U, s0, s2, s4):
    """P2 action values [V] at each node (P2 utility = pot - U1)."""
    m = game.mask
    pot, B = game.pot, game.bet
    # node 1 (after P1 check); P1 reach = s0[:, 0]
    r1 = m * s0[:, 0][:, None]
    v1_check = jnp.sum(r1 * (pot - U["cc"]), 0)
    v1_bet = (jnp.sum(r1 * s2[:, 0][:, None], 0) * pot
              + jnp.sum(r1 * s2[:, 1][:, None] * (pot - U["xbc"]), 0))
    v1 = jnp.stack([v1_check, v1_bet], axis=1)                 # [V, 2]
    # node 3 (after P1 bet); P1 reach = s0[:, 1]
    r3 = m * s0[:, 1][:, None]
    v3_fold = jnp.zeros(m.shape[1])
    v3_call = jnp.sum(r3 * (pot - U["bc"]), 0)
    v3_raise = (jnp.sum(r3 * s4[:, 0][:, None], 0) * (pot + B)
                + jnp.sum(r3 * s4[:, 1][:, None] * (pot - U["brc"]), 0))
    v3 = jnp.stack([v3_fold, v3_call, v3_raise], axis=1)       # [V, 3]
    return v1, v3


def solve_cfr_plus(game: RiverGame, iterations: int = 2000
                   ) -> RiverStrategy:
    """CFR+ with alternating updates and linear strategy averaging."""
    H, V = game.W.shape
    U = _payoffs(game)

    def init(n, k):
        return jnp.zeros((n, k), F32)

    state0 = dict(
        r0=init(H, 2), r2=init(H, 2), r4=init(H, 2),
        r1=init(V, 2), r3=init(V, 3),
        a0=init(H, 2), a2=init(H, 2), a4=init(H, 2),
        a1=init(V, 2), a3=init(V, 3),
    )

    g1, g3 = _gates(game)

    def body(t, st):
        s0, s2, s4 = (_normalize(st["r0"]), _normalize(st["r2"]),
                      _normalize(st["r4"]))
        s1, s3 = _normalize(st["r1"], g1), _normalize(st["r3"], g3)
        w = (t + 1).astype(F32)

        # P1 regret update (P2 plays current s1/s3)
        v0, v2, v4 = _p1_values(game, U, s1, s2, s3, s4)
        st["r0"] = jnp.maximum(
            st["r0"] + v0 - jnp.sum(s0 * v0, 1, keepdims=True), 0.0)
        st["r2"] = jnp.maximum(
            st["r2"] + v2 - jnp.sum(s2 * v2, 1, keepdims=True), 0.0)
        st["r4"] = jnp.maximum(
            st["r4"] + v4 - jnp.sum(s4 * v4, 1, keepdims=True), 0.0)
        # average strategies weighted by own reach and iteration (CFR+
        # linear averaging)
        st["a0"] = st["a0"] + w * s0
        st["a2"] = st["a2"] + w * s0[:, 0][:, None] * s2
        st["a4"] = st["a4"] + w * s0[:, 1][:, None] * s4

        # P2 regret update (P1 plays the JUST-updated strategies —
        # alternating updates)
        s0n, s2n, s4n = (_normalize(st["r0"]), _normalize(st["r2"]),
                         _normalize(st["r4"]))
        v1, v3 = _p2_values(game, U, s0n, s2n, s4n)
        st["r1"] = jnp.maximum(
            st["r1"] + v1 - jnp.sum(s1 * v1, 1, keepdims=True), 0.0)
        st["r3"] = jnp.maximum(
            st["r3"] + v3 - jnp.sum(s3 * v3, 1, keepdims=True), 0.0)
        st["a1"] = st["a1"] + w * s1
        st["a3"] = st["a3"] + w * s3
        return st

    st = jax.lax.fori_loop(0, iterations, body, state0)

    def avg(a, allow=None):
        tot = jnp.sum(a, axis=-1, keepdims=True)
        if allow is not None:
            fb = jnp.broadcast_to(allow[None] / jnp.sum(allow), a.shape)
        else:
            fb = jnp.full_like(a, 1.0 / a.shape[-1])
        return jnp.where(tot > 0, a / jnp.where(tot > 0, tot, 1.0), fb)

    return RiverStrategy(avg(st["a0"]), avg(st["a1"], g1), avg(st["a2"]),
                         avg(st["a3"], g3), avg(st["a4"]))


def strategy_values(game: RiverGame, strat: RiverStrategy
                    ) -> Tuple[float, float]:
    """(P1 EV, P2 EV) under the strategy profile, averaged over the
    uniform valid-pair prior. P1 + P2 == pot always (constant-sum)."""
    U = _payoffs(game)
    s0, s1, s2, s3, s4 = strat
    v0, _, _ = _p1_values(game, U, s1, s2, s3, s4)
    total = jnp.sum(jnp.sum(s0 * v0, axis=1))
    pairs = jnp.sum(game.mask)
    ev1 = float(total / pairs)
    return ev1, float(game.pot) - ev1


def best_response_values(game: RiverGame, strat: RiverStrategy
                         ) -> Tuple[float, float]:
    """(BR1, BR2): each side's best-response EV vs the other's average
    strategy. Exploitability gap = br1 + br2 - pot >= 0, zero at Nash."""
    U = _payoffs(game)
    s0, s1, s2, s3, s4 = strat
    m = game.mask
    pot, B = game.pot, game.bet
    pairs = jnp.sum(m)

    # BR for P1: maximize bottom-up
    r4 = m * s3[None, :, 2]
    v4 = jnp.stack([jnp.sum(r4, 1) * (-B), jnp.sum(r4 * U["brc"], 1)], 1)
    b4 = jnp.max(v4, axis=1)
    r2 = m * s1[None, :, 1]
    v2 = jnp.stack([jnp.zeros(m.shape[0]), jnp.sum(r2 * U["xbc"], 1)], 1)
    b2 = jnp.max(v2, axis=1)
    v_check = jnp.sum(m * s1[None, :, 0] * U["cc"], 1) + b2
    v_bet = (jnp.sum(m * s3[None, :, 0], 1) * pot
             + jnp.sum(m * s3[None, :, 1] * U["bc"], 1) + b4)
    br1 = float(jnp.sum(jnp.maximum(v_check, v_bet)) / pairs)

    # BR for P2: at n1/n3 the best response maximizes over P2 actions,
    # with P1's later nodes played from the AVERAGE strategy.
    r1 = m * s0[:, 0][:, None]
    v1_check = jnp.sum(r1 * (pot - U["cc"]), 0)
    v1_bet = (jnp.sum(r1 * s2[:, 0][:, None], 0) * pot
              + jnp.sum(r1 * s2[:, 1][:, None] * (pot - U["xbc"]), 0))
    r3 = m * s0[:, 1][:, None]
    v3 = jnp.stack([
        jnp.zeros(m.shape[1]),
        jnp.sum(r3 * (pot - U["bc"]), 0),
        (jnp.sum(r3 * s4[:, 0][:, None], 0) * (pot + B)
         + jnp.sum(r3 * s4[:, 1][:, None] * (pot - U["brc"]), 0)),
    ], axis=1)
    # Tree gates: a disabled action is unavailable to the best response
    # too (it is not part of the game).
    if not game.p2_can_bet:
        v1_bet = v1_check - 1.0  # never chosen
    if not game.p2_can_raise:
        v3 = v3.at[:, 2].set(jnp.min(v3, axis=1) - 1.0)
    # P2 reaches exactly one of n1/n3 per hand (they follow different P1
    # root actions), so the BR total is the sum of the two nodes' best
    # values — the reach weights are already inside r1/r3.
    br2 = float(jnp.sum(jnp.maximum(v1_check, v1_bet)
                        + jnp.max(v3, axis=1)) / pairs)
    return br1, br2


def exploitability_gap(game: RiverGame, strat: RiverStrategy) -> float:
    """br1 + br2 - pot (chips; zero exactly at Nash)."""
    br1, br2 = best_response_values(game, strat)
    return br1 + br2 - float(game.pot)


# ---------------------------------------------------------------------------
# Trained-net Nash gap: extract a policy artifact's river strategy and
# measure its exploitability in the solved subgame
# ---------------------------------------------------------------------------

def river_node_states(board: Sequence[int], pot_bb: int = 2):
    """Engine states at the five decision nodes of the river tree.

    A heads-up hand is scripted to the river on an injected deck (blinds,
    then checks through preflop/flop/turn -> pot = 2bb = 20 chips), then
    the in-tree prefixes are applied. Bet/raise sizes are the NET'S OWN
    pot-raise menu at those nodes, MEASURED from
    ``action_from_index(3, state)``: B = 20 at the root, raise-by R = 50
    facing the bet (raise TO 70) — the menu's "pot" formula rides the
    reference's n-inflated layer quirk, so it is NOT the real pot
    (round-3 note: the original release assumed R = 60/raise TO 80,
    overstating the net's raise by 1 bb; the tree now speaks the
    artifact's action language exactly).

    Returns (states, sizes): ``states`` maps node -> a single TableState
    with the acting player at the head (P1 nodes: position 0; P2 nodes:
    position 1); hole cards are dummies — swap them per combo via
    ``_replace(hole=...)`` (features read only the head's own cards +
    public state, ``models/features.py``).
    """
    import numpy as np

    from montecarlo_tpu.engine.state import TableConfig, init_state, redeal
    from montecarlo_tpu.engine.step import clamp_action, step_table

    assert pot_bb == 2, "the scripted prelude produces a 2bb river pot"
    from montecarlo_tpu.models.policy_net import action_from_index

    cfg = TableConfig(num_seats=2, rules="standard")
    board = np.asarray(board, np.int32)
    pot = 2 * cfg.big_blind

    dead = set(int(c) for c in board)
    dummies = [c for c in range(52) if c not in dead][:4]
    deck = np.zeros(52, np.int32)
    base = 4
    pos = list(range(base)) + [base + 1, base + 2, base + 3, base + 5,
                               base + 7]
    dealt = np.array(dummies + list(board), np.int32)
    deck[pos] = dealt
    rest = np.setdiff1d(np.arange(52), dealt)
    deck[[p for p in range(52) if p not in pos]] = rest

    st = init_state(jax.random.key(0), cfg)
    st = redeal(st, jnp.asarray(deck))
    for a in (0, 0, 0, 0, 0, 0):  # SB call, BB check, check x4
        st = step_table(st, clamp_action(st, jnp.asarray(a, jnp.int32)),
                        rules=cfg.rules)

    def advance(s, actions):
        for a in actions:
            s = step_table(s, clamp_action(s, jnp.asarray(a, jnp.int32)),
                           rules=cfg.rules)
        return s

    # the net's own menu sizes at the decision points (raise-by amounts)
    B = int(action_from_index(jnp.asarray(3), st))
    assert B == pot, (B, pot)
    n3 = advance(st, [B])
    R = int(action_from_index(jnp.asarray(3), n3))  # raise-by facing B
    states = {
        "n0": st,                       # P1 to act (head position 0)
        "n1": advance(st, [0]),         # P2 after check
        "n2": advance(st, [0, B]),      # P1 facing bet
        "n3": n3,                       # P2 facing bet
        "n4": advance(n3, [R]),         # P1 facing raise
    }
    return states, dict(pot=float(pot), bet=float(B), raise_=float(R))


def net_river_strategy(params, states, hero_combos, villain_combos
                       ) -> RiverStrategy:
    """Extract an artifact's strategy at each node for each combo.

    The net's 4-action menu maps onto the tree: with nothing owed
    {check = call-menu, bet = either raise size}; facing a bet at n3
    {fold, call, raise = either raise size}; at n2/n4 the tree has no
    raise, so raise mass continues the hand as a call (the conservative
    mapping — it neither folds out equity nor invents new lines).
    Probabilities come from the same masked softmax the artifact plays
    with everywhere else (policy_net.net_policy's fold mask included).
    """
    from montecarlo_tpu.engine.street import bets_needed
    from montecarlo_tpu.engine.step import head_info
    from montecarlo_tpu.models.features import state_features
    from montecarlo_tpu.models.policy_net import policy_logits

    def node_probs(state, combos, head_pos):
        holes0 = jnp.asarray(state.hole)

        def one(combo):
            holes = holes0.at[head_pos].set(combo)
            s = state._replace(hole=holes)
            feats = state_features(s)
            logits = policy_logits(params, feats)
            pos, _, _ = head_info(s)
            free = bets_needed(s.bets, pos) == 0
            logits = logits.at[0].add(jnp.where(free, -1e9, 0.0))
            return jax.nn.softmax(logits)

        return np.asarray(jax.vmap(one)(jnp.asarray(combos)))

    p0 = node_probs(states["n0"], hero_combos, 0)
    p1 = node_probs(states["n1"], villain_combos, 1)
    p2 = node_probs(states["n2"], hero_combos, 0)
    p3 = node_probs(states["n3"], villain_combos, 1)
    p4 = node_probs(states["n4"], hero_combos, 0)

    def free_map(p):      # {check, bet}
        return np.stack([p[:, 1], p[:, 2] + p[:, 3]], axis=1)

    def owed2_map(p):     # {fold, call(+raise mass)}
        return np.stack([p[:, 0], p[:, 1] + p[:, 2] + p[:, 3]], axis=1)

    def owed3_map(p):     # {fold, call, raise}
        return np.stack([p[:, 0], p[:, 1], p[:, 2] + p[:, 3]], axis=1)

    return RiverStrategy(
        s0=jnp.asarray(free_map(p0)), s1=jnp.asarray(free_map(p1)),
        s2=jnp.asarray(owed2_map(p2)), s3=jnp.asarray(owed3_map(p3)),
        s4=jnp.asarray(owed2_map(p4)))
