"""Batched random-policy self-play: full betting hands to showdown.

One table-hand is a bounded ``lax.scan`` of ``step_action`` (the device form
of the reference's action-channel loop, ``board.clj:131-138``); a batch of
tables is a ``vmap`` over the leading axis; multiple hands chain through
``settle_showdown`` + ``next_hand`` (the perpetual-game loop of
``gameplay.clj:149-150``, with busted players kept at the table exactly like
the reference).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp

from montecarlo_tpu.engine.state import TableConfig, TableState, init_state, next_hand
from montecarlo_tpu.engine.step import (
    _select_tree,
    clamp_action,
    settle_showdown,
    step_action,
)
from montecarlo_tpu.rollout.policy import random_policy

I32 = jnp.int32


def hand_action_bound(cfg: TableConfig, max_raises_per_street: int = 2) -> int:
    """Static scan bound: a street ends after at most P*(1+R) actions when the
    policy raises at most R times per street; 4 streets per hand."""
    return 4 * cfg.num_seats * (1 + max_raises_per_street)


def play_one_hand(
    state: TableState,
    key: jax.Array,
    policy: Callable = random_policy,
    max_steps: int = 72,
    rules: str = "reference",
) -> TableState:
    """Scan a single table-hand to completion and settle the showdown.

    Steps after the hand ends are masked no-ops inside ``step_action``.
    (A vmapped ``while_loop`` with early exit was measured ~25% slower: the
    batchwide max trip count approaches the bound anyway and the dynamic
    loop blocks XLA's scan pipelining.)
    """

    def body(carry, k):
        st, street_raises = carry
        action = clamp_action(st, policy(k, st, street_raises))
        prev_stage = st.stage
        nxt = step_action(st, action, rules=rules)
        applied_raise = (action > 0) & ~st.hand_over
        street_raises = jnp.where(
            nxt.stage != prev_stage, 0, street_raises + applied_raise)
        return (nxt, street_raises), None

    keys = jax.random.split(key, max_steps)
    (state, _), _ = jax.lax.scan(body, (state, jnp.zeros((), I32)), keys)
    # The bound guarantees completion; the mask keeps semantics safe anyway.
    return _select_tree(state.hand_over,
                        settle_showdown(state, rules=rules), state)


@partial(jax.jit,
         static_argnames=("cfg", "num_hands", "max_steps", "policy",
                          "collect_deltas"))
def play_hands(
    keys: jax.Array,
    cfg: TableConfig,
    num_hands: int = 1,
    max_steps: Optional[int] = None,
    policy: Callable = random_policy,
    collect_deltas: bool = False,
):
    """Play ``num_hands`` consecutive hands on ``len(keys)`` parallel tables.

    Returns the batch of final (settled) states; with
    ``collect_deltas=True`` returns ``(final, deltas)`` where ``deltas`` is
    ``[tables, hands, P]`` settled chip change per hand by *position*
    (position 0 = that hand's small blind). Chip conservation holds exactly
    under standard rules; under reference rules only up to the n-inflation
    minting (see ``engine.bets``).
    """
    steps = max_steps or hand_action_bound(cfg)

    def one_table(key):
        st = init_state(key, cfg)

        def hand_body(st, xs):
            i, hand_key = xs
            # Pre-hand stacks in this hand's position space.
            pre = jnp.where(i > 0, jnp.roll(st.stacks, -1),
                            jnp.full_like(st.stacks, cfg.starting_stack))
            st = _select_tree(i > 0, next_hand(st, rules=cfg.rules), st)
            st = play_one_hand(st, hand_key, policy=policy, max_steps=steps,
                               rules=cfg.rules)
            return st, st.stacks - pre

        hand_keys = jax.random.split(jax.random.fold_in(key, 0x5E1F), num_hands)
        final, deltas = jax.lax.scan(
            hand_body, st, (jnp.arange(num_hands), hand_keys))
        return final, deltas  # settled state of the last hand; [hands, P]

    final, deltas = jax.vmap(one_table)(keys)
    return (final, deltas) if collect_deltas else final


@partial(jax.jit, static_argnames=("cfg", "n_steps", "policy"))
def play_hands_perpetual(
    keys: jax.Array,
    cfg: TableConfig,
    n_steps: int,
    policy: Callable = random_policy,
):
    """Perpetual-table self-play: scan ``n_steps`` of ``step_table`` (the
    reference's endless-game loop, ``gameplay.clj:149-150``) on every
    table — each hand settles and the next deals INSIDE the step, so every
    lane does useful work on every step (no masked tail).

    This is the steady-state throughput form: ``play_hands`` pays the
    worst-case action bound per hand (72 steps for 6-max) with most steps
    masked no-ops; here a hand completes every ~E[actions] steps (~27 for
    6-max random play) at a higher per-step price, for more hands/s
    overall (see PERF.md).

    Returns ``(final_states, hands_completed)`` (total across tables).
    """
    from montecarlo_tpu.engine.step import step_table

    def one_table(key):
        st = init_state(key, cfg)

        def body(carry, k):
            st, street_raises = carry
            action = clamp_action(st, policy(k, st, street_raises))
            prev_stage, prev_idx = st.stage, st.hand_idx
            nxt = step_table(st, action, rules=cfg.rules)
            applied = (action > 0) & ~st.hand_over
            street_raises = jnp.where(
                (nxt.stage != prev_stage) | (nxt.hand_idx != prev_idx),
                0, street_raises + applied)
            return (nxt, street_raises), None

        ks = jax.random.split(jax.random.fold_in(key, 0x5CAD), n_steps)
        (final, _), _ = jax.lax.scan(body, (st, jnp.zeros((), I32)), ks)
        return final

    final = jax.vmap(one_table)(keys)
    return final, jnp.sum(final.hand_idx)


@partial(jax.jit,
         static_argnames=("cfg", "max_hands", "max_steps", "policy"))
def play_tournament(
    keys: jax.Array,
    cfg: TableConfig,
    max_hands: int,
    max_steps: Optional[int] = None,
    policy: Callable = random_policy,
):
    """Play up to ``max_hands`` TOURNAMENT hands per table (true
    elimination: busted seats leave the deal, blinds advance over them,
    the table freezes when one player holds everything).

    Returns ``(final_states, busted_at)`` where ``busted_at[t, s]`` is the
    0-based hand index at which SEAT ``s`` (stable across hands; position
    arrays rotate, seat = (button + position) % P) first hit zero chips —
    ``max_hands + 1`` for seats still alive at the end.
    """
    assert cfg.rules == "tournament", "play_tournament needs tournament rules"
    steps = max_steps or hand_action_bound(cfg)
    P = cfg.num_seats

    def seat_view(stacks, button):
        """Positional stacks -> seat-indexed (gather-free dynamic roll)."""
        out = stacks
        for k in range(1, P):
            out = jnp.where(button == k, jnp.roll(stacks, k), out)
        return out

    def one_table(key):
        st = init_state(key, cfg)
        busted = jnp.full((P,), max_hands + 1, I32)

        def hand_body(carry, xs):
            st, busted = carry
            i, hand_key = xs
            st = _select_tree(i > 0, next_hand(st, rules=cfg.rules), st)
            st = play_one_hand(st, hand_key, policy=policy,
                               max_steps=steps, rules=cfg.rules)
            seat_stacks = seat_view(st.stacks, st.button)
            newly = (seat_stacks <= 0) & (busted > max_hands)
            busted = jnp.where(newly, i, busted)
            return (st, busted), None

        hand_keys = jax.random.split(
            jax.random.fold_in(key, 0x70A8), max_hands)
        (final, busted), _ = jax.lax.scan(
            hand_body, (st, busted), (jnp.arange(max_hands), hand_keys))
        return final, busted, seat_view(final.stacks, final.button)

    final, busted, seat_stacks = jax.vmap(one_table)(keys)
    return final, busted, seat_stacks


def tournament_placements(busted_at, seat_stacks):
    """[tables, P] finishing places (1 = winner) from bust times + final
    stacks: later bust beats earlier; unbusted seats rank by final stack."""
    import numpy as np

    b = np.asarray(busted_at, np.int64)
    s = np.asarray(seat_stacks, np.int64)
    order_key = b * (s.max() + 2) + s  # bust time dominates, stack breaks
    ranks = np.argsort(np.argsort(-order_key, axis=1, kind="stable"),
                       axis=1, kind="stable") + 1
    return ranks


def position_winrates(deltas, big_blind: int):
    """[tables, hands, P] chip deltas -> (bb/hand mean[P], stderr[P]).

    Position 0 is each hand's small blind."""
    import numpy as np

    bb = np.asarray(deltas, np.float64) / big_blind
    flat = bb.reshape(-1, bb.shape[-1])
    return flat.mean(axis=0), flat.std(axis=0, ddof=1) / np.sqrt(flat.shape[0])


def selfplay_stats(states: TableState) -> Dict[str, jax.Array]:
    """Aggregate diagnostics over a batch of final states."""
    return {
        "tables": states.time.shape[0],
        "mean_stack": jnp.mean(states.stacks.astype(jnp.float32)),
        "min_stack": jnp.min(states.stacks),
        "max_stack": jnp.max(states.stacks),
        "bet_overflow_frac": jnp.mean(states.bets.overflow.astype(jnp.float32)),
        "pot_overflow_frac": jnp.mean(states.pots.overflow.astype(jnp.float32)),
        "hands_played": jnp.max(states.hand_idx),
    }
