"""Table state pytree and hand setup (deal, blinds, hand reset).

The reference ``Board`` is a record of 14 fields, 10 of them STM refs
(``board.clj:15-29``, ``init-board`` ``:140-157``), plus per-player state in
a global database (``database.clj``). Here the whole table — board *and*
players — is one flat pytree of int32/bool arrays, so a batch of tables is
just a leading axis and a full betting hand is a ``lax.scan``.

Array encodings of the reference's dynamic structures:

- All per-player arrays are indexed by **hand-order position** (position 0
  posts the small blind this hand), not by a fixed seat: dealing, blinds,
  and the play-order head are then pure static-index/arithmetic ops with no
  dynamic gathers (which lower poorly inside vmapped scans). The
  players-list rotation at hand end (``gameplay.clj:136-137``) is a
  constant ``roll`` of the persistent arrays; ``button`` (+1 per hand) maps
  positions to stable seats only at the host boundary:
  ``seat = (button + position) % P``.
- ``play-order`` (a lazy ``(cycle ids)`` with folds filtered, ``board.clj:21``)
  becomes ``(cursor, order_mask)``: the head is the first unmasked position
  scanning cyclically from ``cursor`` — an arithmetic min-reduction.
- ``(shuffle COMPLETE-DECK)`` (``board.clj:148``, ``gameplay.clj:145``)
  becomes a counter-based threefry permutation keyed by (table key,
  hand_idx) — reproducible and parallel-safe across millions of tables.
- The deck is consumed eagerly at deal time: hole cards AND the five
  community cards (with the reference's burn offsets, ``gameplay.clj:30-54``)
  are materialized up front; streets merely reveal ``n_community``. Unrevealed
  cards never influence pre-showdown state, so traces are unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from montecarlo_tpu.cards import NUM_CARDS
from montecarlo_tpu.engine.bets import Layers, empty_layers
from montecarlo_tpu.engine.street import (
    bets_empty_like,
    bets_thread,
    make_empty_bets,
)

I32 = jnp.int32


@dataclass(frozen=True)
class TableConfig:
    """Static table parameters (shapes and defaults).

    Defaults mirror the reference: 100-chip starting stacks
    (``database.clj:31``), 5/10 blinds (``server.clj:61``).
    """

    num_seats: int
    small_blind: int = 5
    big_blind: int = 10
    starting_stack: int = 100
    max_layers: int = 12       # per-street bet layers (L)
    max_pot_layers: int = 24   # accumulated across 4 streets (PL)
    # "reference": bit-exact Clojure semantics, quirks included (n-inflation
    # chip minting, all-in seats excluded from showdown, lost remainders).
    # "standard": real poker accounting — calls/raises capped at the stack
    # (all-in for less splits a side pot), all-in seats stay eligible at
    # showdown, boards run out when betting is closed, pots pay
    # amt * |contributors| with odd chips to the first-position winner;
    # chips are exactly conserved.
    # "tournament": standard accounting plus true elimination — busted
    # seats leave the deal (live-mask shrinks, array shape fixed), blinds
    # advance over eliminated seats, and the table freezes once one player
    # holds all the chips (next_hand returns a terminal hand_over state).
    rules: str = "reference"
    # Street bet-state implementation: "layers" is the literal four-column
    # transcription of bet.clj (engine.bets); "levels" is the minimal
    # boundary/contribution form (engine.street) — trajectory-equal (pinned
    # by tests/test_street.py) and faster per action, but requires positive
    # blinds (a zero-chip post must not create a layer).
    bets_impl: str = "layers"


class TableState(NamedTuple):
    """Complete state of one table (batch tables by vmapping over a leading
    axis). All fields are fixed-shape jnp arrays."""

    key: jax.Array          # u32 threefry key, fixed per table
    hand_idx: jax.Array     # i32[] hand counter (deck = f(key, hand_idx))
    deck: jax.Array         # i32[52] permutation of card ids
    hole: jax.Array         # i32[P, 2] hole cards by seat
    community: jax.Array    # i32[5] materialized at deal, revealed by stage
    n_community: jax.Array  # i32[] cards currently revealed
    stage: jax.Array        # i32[] 0 preflop, 1 flop, 2 turn, 3 river
    time: jax.Array         # i32[] logical clock, +1 per action
    button: jax.Array       # i32[] hand-order offset (rotates each hand)
    cursor: jax.Array       # i32[] play-order scan start (hand-order space)
    in_hand: jax.Array      # bool[P] reference :players membership
    all_in: jax.Array       # bool[P] standard-rules all-in (showdown-live)
    folded: jax.Array       # bool[P] filtered out of play-order
    order_mask: jax.Array   # bool[P] current play-order cycle membership
    to_act: jax.Array       # bool[P] reference :remaining-players
    stacks: jax.Array       # i32[P] chips (global per player; may go negative)
    bets: Layers            # current street layers
    pots: Layers            # accumulated pot layers
    small_blind: jax.Array  # i32[]
    big_blind: jax.Array    # i32[]
    hand_over: jax.Array    # bool[] latched at game end (single-hand mode)
    # Observational betting-history metadata (appended fields so older
    # flattened-leaf checkpoints keep their leaf prefix; no rule reads
    # them — they exist for policy features, models/features.py):
    street_raises: jax.Array  # i32[] raises since the street began
    last_raiser: jax.Array    # i32[] position of the last raiser; P = none

    @property
    def num_seats(self) -> int:
        return self.hole.shape[0]


def init_state(key: jax.Array, cfg: TableConfig) -> TableState:
    """Fresh table: full stacks, button at seat 0, first hand dealt."""
    P = cfg.num_seats
    if cfg.bets_impl == "levels":
        assert cfg.small_blind > 0 and cfg.big_blind > 0, (
            "the levels street form requires positive blinds "
            "(zero-chip posts must not create a layer)")
    ones = jnp.ones((P,), jnp.bool_)
    state = TableState(
        key=key,
        hand_idx=jnp.zeros((), I32),
        deck=jnp.arange(NUM_CARDS, dtype=I32),
        hole=jnp.zeros((P, 2), I32),
        community=jnp.zeros((5,), I32),
        n_community=jnp.zeros((), I32),
        stage=jnp.zeros((), I32),
        time=jnp.zeros((), I32),
        button=jnp.zeros((), I32),
        cursor=jnp.zeros((), I32),
        in_hand=ones,
        all_in=jnp.zeros((P,), jnp.bool_),
        folded=jnp.zeros((P,), jnp.bool_),
        order_mask=ones,
        to_act=ones,
        stacks=jnp.full((P,), cfg.starting_stack, I32),
        bets=make_empty_bets(cfg.bets_impl, cfg.max_layers, P),
        pots=empty_layers(cfg.max_pot_layers, P),
        small_blind=jnp.asarray(cfg.small_blind, I32),
        big_blind=jnp.asarray(cfg.big_blind, I32),
        hand_over=jnp.zeros((), jnp.bool_),
        street_raises=jnp.zeros((), I32),
        last_raiser=jnp.full((), P, I32),
    )
    return begin_hand(state, rules=cfg.rules)


@partial(jax.jit, static_argnames=("rules",))
def begin_hand(state: TableState, rules: str = "reference") -> TableState:
    """Reset per-hand state, shuffle, post blinds, deal (the tail of
    ``gameplay.clj:122-150`` plus ``play-blinds``/``deal-hand``).

    Caller is responsible for ``button``/``hand_idx`` (advanced by
    ``next_hand``; left alone for the first hand). Under standard rules
    blind posts cap at the stack (an all-in blind) and busted seats sit out
    as all-in-for-nothing; the reference posts full blinds unconditionally
    (stacks go negative, ``gameplay.clj:83-88``).
    """
    P = state.num_seats
    deck = jax.random.permutation(
        jax.random.fold_in(state.key, state.hand_idx), NUM_CARDS
    ).astype(I32)

    # deal-hand (gameplay.clj:63-75): one card at a time round-robin in hand
    # order, so position j receives deck[j] and deck[P + j] (static slices).
    hole = jnp.stack([deck[:P], deck[P:2 * P]], axis=1)
    # Streets with burns (gameplay.clj:30-54): burn 1 + flop 3, burn 1 +
    # turn 1, burn 1 + river 1, starting right after the 2P hole cards.
    base = 2 * P
    community = jnp.stack([
        deck[base + 1], deck[base + 2], deck[base + 3],  # flop
        deck[base + 5],                                   # turn
        deck[base + 7],                                   # river
    ])

    ones = jnp.ones((P,), jnp.bool_)
    bets = bets_empty_like(state.bets, P)

    # play-blinds (gameplay.clj:77-88): position 0 posts small, position 1
    # posts big; play-order drops 2; blinds do not touch remaining-players
    # or the clock.
    stacks = state.stacks
    in_hand = ones
    cursor0 = jnp.full((), 2 % P, I32)
    if rules == "tournament":
        # True elimination: only alive seats are dealt in. Position 0 is
        # alive by next_hand's rotation invariant; the big blind goes to
        # the first alive position >= 1 and action starts after it. Dead
        # positions still consume deck slots (their cards never play).
        alive = state.stacks > 0
        idx = jnp.arange(P)
        bb_pos = jnp.min(jnp.where(alive & (idx >= 1), idx, P))

        def post_at(stacks, bets, pos, amount):
            sel = idx == pos
            stack_at = jnp.sum(jnp.where(sel, stacks, 0))
            pay = jnp.clip(amount, 0, jnp.maximum(stack_at, 0))
            stacks = stacks - jnp.where(sel, pay, 0)
            posted = bets_thread(bets, pay, pos)
            bets = jax.tree.map(
                lambda a, b: jnp.where(pay > 0, a, b), posted, bets)
            return stacks, bets

        stacks, bets = post_at(stacks, bets, jnp.zeros((), I32),
                               state.small_blind)
        stacks, bets = post_at(stacks, bets, bb_pos, state.big_blind)
        all_in = alive & (stacks <= 0)  # all-in blinds still contest
        in_hand = alive
        actable = alive & (stacks > 0)
        cursor0 = ((bb_pos + 1) % P).astype(I32)
    elif rules == "standard":
        def post(stacks, bets, pos, amount):
            pay = jnp.clip(amount, 0, jnp.maximum(stacks[pos], 0))
            stacks = stacks.at[pos].add(-pay)
            posted = bets_thread(bets, pay, pos)
            bets = jax.tree.map(
                lambda a, b: jnp.where(pay > 0, a, b), posted, bets)
            return stacks, bets

        stacks, bets = post(stacks, bets, 0, state.small_blind)
        stacks, bets = post(stacks, bets, 1, state.big_blind)
        all_in = stacks <= 0  # all-in blinds and busted seats sit out
        actable = ~all_in
    else:
        stacks = stacks.at[0].add(-state.small_blind)
        bets = bets_thread(bets, state.small_blind, 0)
        stacks = stacks.at[1].add(-state.big_blind)
        bets = bets_thread(bets, state.big_blind, 1)
        all_in = jnp.zeros((P,), jnp.bool_)
        actable = jnp.ones((P,), jnp.bool_)

    return state._replace(
        deck=deck,
        hole=hole,
        community=community,
        n_community=jnp.zeros((), I32),
        stage=jnp.zeros((), I32),
        time=jnp.zeros((), I32),
        cursor=cursor0,
        in_hand=in_hand,
        all_in=all_in,
        folded=jnp.zeros((P,), jnp.bool_),
        order_mask=actable,
        to_act=actable,
        stacks=stacks,
        bets=bets,
        pots=empty_layers(state.pots.capacity, P),
        hand_over=jnp.zeros((), jnp.bool_),
        street_raises=jnp.zeros((), I32),
        last_raiser=jnp.full((), P, I32),
    )


@jax.jit
def redeal(state: TableState, deck) -> TableState:
    """Re-derive hole/community cards from an injected deck order.

    Conformance tool: seeded single-table traces are validated against the
    reference by injecting an explicit deck (bit-exactness vs Clojure's
    ``java.util.Random`` shuffle is neither possible nor meaningful; the
    *consumption order* is what's conformant — ``gameplay.clj:63-75``).
    Betting state (blinds already posted by ``begin_hand``) is untouched.
    """
    P = state.num_seats
    deck = jnp.asarray(deck, I32)
    hole = jnp.stack([deck[:P], deck[P:2 * P]], axis=1)
    base = 2 * P
    community = jnp.stack([
        deck[base + 1], deck[base + 2], deck[base + 3],
        deck[base + 5],
        deck[base + 7],
    ])
    return state._replace(deck=deck, hole=hole, community=community)


@partial(jax.jit, static_argnames=("rules",))
def next_hand(state: TableState, rules: str = "reference") -> TableState:
    """Rotate the players list (``gameplay.clj:136-137``), bump the hand
    counter, and deal the next hand. Positional state rotates left by one —
    a constant roll — so new position 0 (the next small blind) is the old
    position 1; the button metadata advances for host seat-mapping. Stacks
    persist; busted players are never eliminated (reference quirk — blinds
    may drive stacks negative, ``gameplay.clj:83-88``).

    Tournament rules rotate by the distance to the next ALIVE seat (blinds
    advance over eliminated seats), and once at most one player has chips
    the table FREEZES: a terminal ``hand_over`` state with cleared pots
    (idempotent under further ``next_hand``/``step_table`` calls)."""
    P = state.num_seats
    if rules != "tournament":
        return begin_hand(state._replace(
            stacks=jnp.roll(state.stacks, -1),
            button=(state.button + 1) % P,
            hand_idx=state.hand_idx + 1,
        ), rules=rules)

    alive = state.stacks > 0
    n_alive = jnp.sum(alive.astype(I32))
    idx = jnp.arange(P)
    shift = jnp.min(jnp.where(alive & (idx >= 1), idx, P))
    shift = jnp.clip(shift, 1, P - 1)  # well-defined even when freezing
    # Gather-free dynamic roll: compose static rolls under a select.
    rolled = state.stacks
    for k in range(1, P):
        rolled = jnp.where(shift == k, jnp.roll(state.stacks, -k), rolled)
    nxt = begin_hand(state._replace(
        stacks=rolled,
        button=(state.button + shift) % P,
        hand_idx=state.hand_idx + 1,
    ), rules=rules)
    frozen = state._replace(
        bets=bets_empty_like(state.bets, P),
        pots=empty_layers(state.pots.capacity, P),
        to_act=jnp.zeros((P,), jnp.bool_),
        order_mask=jnp.zeros((P,), jnp.bool_),
        hand_over=jnp.ones((), jnp.bool_),
    )
    return jax.tree.map(
        lambda a, b: jnp.where(n_alive <= 1, a, b), frozen, nxt)
