"""The XLA engine driven by injected streams: the reference trajectories.

The packed-block engine (``ops/pallas_engine.py``) has a deterministic
mode that takes its raw actions and per-hand deals as inputs. These
drivers feed the same streams through ``engine.step.step_table`` (and the
policy-net pipeline of ``models/``), so the two engines can be compared
field for field: in the test suite on the CPU, and by ``chip_smoke.py`` on
the GPU at deployment sizes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from montecarlo_tpu.engine.state import init_state, redeal
from montecarlo_tpu.engine.step import _select_tree, clamp_action, step_table


def deal_positions(P: int):
    """Deck positions ``state.begin_hand`` deals from: holes round-robin,
    then the board past the burn cards."""
    base = 2 * P
    return list(range(base)) + [base + 1, base + 2, base + 3, base + 5,
                                base + 7]


def decks_from_cards(cards, P: int):
    """[T, H, 2P+5] dealt cards -> [T, H, 52] full decks whose consumption
    order yields exactly those cards (unused positions hold the remaining
    cards, ascending)."""
    cards = np.asarray(cards, np.int64)
    pos = deal_positions(P)
    unused = [p for p in range(52) if p not in pos]
    used = np.zeros(cards.shape[:2] + (52,), bool)
    np.put_along_axis(used, cards, True, axis=-1)
    rest = np.argsort(used, axis=-1, kind="stable")[..., :len(unused)]
    decks = np.zeros(cards.shape[:2] + (52,), np.int64)
    decks[..., pos] = cards
    decks[..., unused] = rest
    return decks.astype(np.int32)


def replay_injected(actions, decks, n_steps: int, cfg):
    """The XLA engine on injected raw actions [>= n_steps, T] and per-hand
    decks [T, H, 52] (hand h > 0 reads deck row min(h, H-1)).

    Returns (final state, per-position settled delta sums [T, P], hands
    completed [T], per-seat bust hand [T, P]). ``step_table`` rotates and
    posts blinds inside the step, so the settled stacks of a finished hand
    are observed by recomputing the step's settle half with the same
    engine functions (bit-identical by construction)."""
    from montecarlo_tpu.engine.step import (
        _advance_streets,
        apply_action,
        settle_showdown,
    )

    P = cfg.num_seats
    hmax = np.asarray(decks).shape[1]
    actions = jnp.asarray(np.asarray(actions)[:n_steps])
    decks = jnp.asarray(decks)

    def one(table_actions, table_decks):
        st = redeal(init_state(jax.random.key(0), cfg), table_decks[0])
        hand_start = jnp.full((P,), cfg.starting_stack, jnp.int32)
        acc = jnp.zeros((P,), jnp.int32)
        done_ct = jnp.zeros((), jnp.int32)
        bust = jnp.full((P,), -1, jnp.int32)

        def body(carry, a):
            st, hand_start, acc, done_ct, bust = carry
            prev = st.hand_idx
            ca = clamp_action(st, a)
            nxt = step_table(st, ca, rules=cfg.rules)
            # hand COMPLETED this step: a redeal happened, or (tournament)
            # the table froze terminal after its final settlement.
            done = (nxt.hand_idx != prev) | (nxt.hand_over & ~st.hand_over)
            settled = settle_showdown(
                _advance_streets(apply_action(st, ca, rules=cfg.rules),
                                 cfg.rules), rules=cfg.rules).stacks
            if cfg.rules == "tournament":
                # seat view = roll(positional, button)
                seat_stacks = settled
                for b in range(1, P):
                    seat_stacks = jnp.where(
                        st.button == b, jnp.roll(settled, b), seat_stacks)
                newly = done & (seat_stacks <= 0) & (bust < 0)
                bust = jnp.where(newly, done_ct, bust)
            done_ct = done_ct + done
            acc = acc + jnp.where(done, settled - hand_start, 0)
            # next hand's pre-blind stacks: the players list rotates by 1
            # (reference/standard) or by the distance to the next alive
            # position (tournament, state.py:next_hand).
            if cfg.rules == "tournament":
                alive = settled > 0
                idxs = jnp.arange(P)
                shift = jnp.clip(jnp.min(jnp.where(alive & (idxs >= 1),
                                                   idxs, P)), 1, P - 1)
                pre = settled
                for k in range(1, P):
                    pre = jnp.where(shift == k, jnp.roll(settled, -k), pre)
            else:
                pre = jnp.roll(settled, -1)
            hand_start = jnp.where(done, pre, hand_start)
            redealt = redeal(nxt, table_decks[jnp.minimum(nxt.hand_idx,
                                                          hmax - 1)])
            nxt = _select_tree(nxt.hand_idx != prev, redealt, nxt)
            return (nxt, hand_start, acc, done_ct, bust), None

        (st, _, acc, done_ct, bust), _ = jax.lax.scan(
            body, (st, hand_start, acc, done_ct, bust), table_actions)
        return st, acc, done_ct, bust

    return jax.jit(jax.vmap(one, in_axes=(1, 0)))(actions, decks)


def replay_net_argmax(cfg, bots_by_seat, decks, n_steps: int):
    """The XLA net pipeline on injected decks: every seat plays its net
    (``bots_by_seat[seat]``, by stable seat) by argmax over the masked
    menu. Returns (final vmapped TableState, hands completed [T])."""
    from montecarlo_tpu.engine.street import bets_needed
    from montecarlo_tpu.engine.step import head_info
    from montecarlo_tpu.models.features import state_features
    from montecarlo_tpu.models.policy_net import (
        action_from_index, policy_logits,
    )

    P = cfg.num_seats
    hmax = np.asarray(decks).shape[1]

    def one(table_decks):
        st = redeal(init_state(jax.random.key(0), cfg), table_decks[0])

        def body(carry, _):
            st, done_ct = carry
            prev = st.hand_idx
            pos, _, _ = head_info(st)
            seat = (st.button + pos) % P  # bank by STABLE seat
            feats = state_features(st)
            logits_all = jnp.stack([policy_logits(b, feats)
                                    for b in bots_by_seat])  # [P, 4]
            logits = jnp.sum(jnp.where(jnp.arange(P)[:, None] == seat,
                                       logits_all, 0.0), axis=0)
            # engine arrays are indexed by hand-order POSITION
            free = bets_needed(st.bets, pos) == 0
            logits = logits.at[0].add(jnp.where(free, -1e9, 0.0))
            a = action_from_index(jnp.argmax(logits), st)
            nxt = step_table(st, clamp_action(st, a), rules=cfg.rules)
            done_ct = done_ct + (nxt.hand_idx != prev)
            redealt = redeal(nxt, table_decks[jnp.minimum(nxt.hand_idx,
                                                          hmax - 1)])
            nxt = _select_tree(nxt.hand_idx != prev, redealt, nxt)
            return (nxt, done_ct), None

        (st, done_ct), _ = jax.lax.scan(
            body, (st, jnp.zeros((), jnp.int32)), None, length=n_steps)
        return st, done_ct

    return jax.jit(jax.vmap(one))(jnp.asarray(decks))
