"""Whole-step betting engine on packed table blocks.

The complete ``step_table`` (all three rule sets) written as one block
program over a packed state: a block of 1024 tables (an (8, 128) tile per
state row) whose seat/layer/pot axes are small LEADING dims of stacked
arrays ([P, 8, 128] seats, [L, 8, 128] levels, [4, L, 8, 128] per-street
pot slots), so the whole step traces to a few hundred elementwise ops. The
block program is plain JAX: ``jax.vmap`` runs it over the blocks and
``lax.fori_loop`` over the steps, and XLA compiles and fuses it for the
device at hand.

Semantics: all three rule sets of ``engine/step.py`` on the levels street
form (``engine/street.py``), selected statically:

- ``reference`` — bit-exact ``board.clj:31-97`` + ``gameplay.clj:94-150``:
  integer action encoding and raise clamp, the n-inflation quirk,
  exact-equality all-ins leaving ``:players``, integer pot splits with
  vanished remainders, button rotation by one, perpetual redeal;
- ``standard`` — real poker accounting: stack-capped payments, a
  showdown-live all-in mask, original-contributor payouts with
  odd-chips-to-first (chips conserve exactly), capped blinds, all-in
  board runouts (up to 4 chained street transitions per step);
- ``tournament`` — standard accounting plus true elimination: rotation by
  the distance to the next alive position, blinds skip busted seats, and
  a table with one chip-holder freezes by emptying its play order (the
  no-head guard then no-ops it forever).

Pots are four per-street slots of L layers ((amt, seat-set bitmask) plus
the reference ``n`` counter where those rules need it). Street flushes
write the slot of the finished street; settlement scans all 4*L rows.
Payouts are per-layer independent, so the slot layout pays identically to
the reference's appended pot list.

Beyond the random-policy perpetual form, the engine hosts: per-position
and per-seat settled-delta meters, tournament bust records + placements
(``tournament_results``), and seat-pinned policy-NET evaluation
(``selfplay_net_eval_kernel``: the 24 decision features built on block
arrays bit-exact to ``models/features.py``, dense layers as [out, in] x
[in, 8, 128] contractions, Gumbel-argmax sampling).

Two modes:

- ``deterministic``: per-step raw actions and per-hand 17-card deals come
  from inputs. ``tests/test_pallas_engine.py`` pins trajectory equality
  against the XLA engine driven with the same injected streams.
- ``prng``: the production form — policy draws and deals come from the
  counter-based generator of ``ops/counter_rng.py``, keyed by (launch
  seed, global table index, step, draw), one 32-bit word per bounded
  draw. Distributionally identical to ``rollout.policy.random_policy`` +
  uniform deals (``tests/test_pallas_engine.py`` checks the statistics).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from montecarlo_tpu.models.policy_net import MATMUL_PRECISION
from montecarlo_tpu.ops.counter_rng import bits, stream_keys, uniform_int

I32 = jnp.int32

# Tables per block: the (8, 128) tile every state row is stored as.
TILE = (8, 128)
TABLES_PER_BLOCK = TILE[0] * TILE[1]

# Betting steps per settle pass (PRNG mode). Tables whose hand ends wait
# (no-op, ~DEFER/2 idle slots) until the next pass settles, rotates, and
# redeals them; the settle tensors are the bulk of a fused step, so
# evaluating them once per DEFER slots is the engine's biggest lever.
# Per-table hand SEQUENCES are identical for any DEFER (same rules,
# different idle timing). Launch lengths that DEFER does not divide fall
# back to settling every step.
DEFER = 16

# Inner betting-loop unroll (PRNG mode); draw order is unchanged, so
# trajectories are identical for any unroll.
UNROLL = 2

# Counter layout of one engine step's draws: policy words at 0-1, Gumbel
# words at 2.., deal words at DEAL_DRAW... A settle pass draws with the
# counter of the last betting step it follows.
STEP_DRAWS = 64
DEAL_DRAW = 32

# Street layer capacity. Reference rules: L=6 covered 51.7M audited random
# 6-max hands with zero overflows (PERF.md) — levels come only from blinds
# (2) and policy-bounded raises (2/street). Standard rules additionally
# insert a level per distinct all-in-for-less (up to P-1), so the cap is
# wider. The engine latches an overflow flag regardless.
L = 6
L_STANDARD = 10


def _L_for(rules: str) -> int:
    return L if rules == "reference" else L_STANDARD

# Policy constants — must match rollout.policy.random_policy defaults.
FOLD_P_BITS = int(0.15 * 2**32)
RAISE_P_BITS = int((0.15 + 0.30) * 2**32)
MAX_RAISE = 20
MAX_RAISES_PER_STREET = 2


def _field_layout(P: int, rules: str = "reference"):
    """Name -> (offset, rows) map of the packed per-table state. Multi-row
    fields are stored as contiguous row ranges of the [F, 8, 128] block.

    ``pot_set`` holds the per-layer seat set used at settlement: current
    members under reference rules (``:players``, all-in/folded removed at
    flush) vs original contributors under standard rules. ``pot_n`` (the
    reference n-inflation counter) and ``all_in`` (standard showdown-live
    all-in seats) exist only for the rules that use them."""
    fields = [
        ("stage", 1), ("cursor", 1), ("street_raises", 1),
        ("last_raiser", 1),  # acting position of the last raiser; P = none
        ("folded", 1), ("in_hand", 1), ("to_act", 1), ("order", 1),
        ("wait", 1),  # hand ended, settle pass pending (deferred settle)
        ("hand_ct", 1), ("overflow", 1), ("button", 1),
        ("stacks", P), ("contrib", P), ("hole0", P), ("hole1", P),
        ("hand_start", P), ("delta_sum", P), ("seat_delta", P),
        ("board", 5), ("lvl", _L_for(rules)), ("ln", _L_for(rules)),
        ("pot_amt", 4 * _L_for(rules)), ("pot_set", 4 * _L_for(rules)),
    ]
    if rules == "reference":
        fields.append(("pot_n", 4 * _L_for(rules)))
    else:
        fields.append(("all_in", 1))
    if rules == "tournament":
        fields.append(("bust_at", P))  # per-SEAT first-busted hand index
    layout, off = {}, 0
    for name, rows in fields:
        layout[name] = (off, rows)
        off += rows
    return layout, off


def _unpack(block, layout):
    """[F, 8, 128] array -> dict of scalar [8,128] / stacked [R,8,128]."""
    st = {}
    for name, (off, rows) in layout.items():
        st[name] = block[off] if rows == 1 else block[off:off + rows]
    return st


def _pack(st, layout, F):
    # layout insertion order == ascending offsets (built that way).
    parts = [st[name][None] if n == 1 else st[name]
             for name, (off, n) in layout.items()]
    return jnp.concatenate(parts, axis=0)


def _iota(n):
    """[n, 1, 1] leading-axis iota (broadcasts over the (8, 128) tile)."""
    return jax.lax.broadcasted_iota(I32, (n, 1, 1), 0)


def _pick(stacked, idx):
    """stacked[idx] for an [8,128] idx (one-hot reduce over the lead axis)."""
    return jnp.sum(jnp.where(_iota(stacked.shape[0]) == idx[None], stacked,
                             0), axis=0)


def _shift_down(x):
    """x[j] -> x[j-1] along the lead axis (zeros into row 0)."""
    return jnp.concatenate([jnp.zeros_like(x[:1]), x[:-1]], axis=0)


def _seat_bits(P):
    """[P, 1, 1] bit per seat."""
    return jnp.left_shift(jnp.ones((P, 1, 1), I32), _iota(P))


def _mask_bits(bm, P):
    """[8,128] seat bitmask -> [P, 8, 128] 0/1 per seat."""
    return jnp.right_shift(bm[None], _iota(P)) & 1


def _head_info(st, P):
    """First unmasked play-order position from cursor (step.py:head_info)."""
    prio = (_iota(P) - st["cursor"][None]) % P
    on = _mask_bits(st["order"], P) != 0
    best = jnp.min(jnp.where(on, prio, P), axis=0)
    head = (st["cursor"] + best) % P
    return head, (head + 1) % P, st["order"] != 0


def _street_total(lvl):
    """Top boundary == total standing bet (dead rows are 0)."""
    return jnp.max(lvl, axis=0)


def _street_update(lvl, ln, amount, do):
    """Levels-form ``update-bets`` (street.py:street_update): +1 the n of
    covered levels, sorted-insert a new boundary. Dead rows are 0."""
    n_rows = lvl.shape[0]
    valid = lvl > 0
    cnt = jnp.sum(valid.astype(I32), axis=0)
    a = amount[None]
    n_inc = ln + (valid & (lvl <= a)).astype(I32)
    exists = jnp.any(valid & (lvl == a), axis=0)
    pos = jnp.sum((valid & (lvl < a)).astype(I32), axis=0)
    new_n = jnp.where(pos == cnt, 1, _pick(ln, pos) + 1)

    rows = _iota(n_rows)
    below, at = rows < pos[None], rows == pos[None]
    ins_lvl = jnp.where(below, lvl, jnp.where(at, a, _shift_down(lvl)))
    ins_ln = jnp.where(below, n_inc,
                       jnp.where(at, new_n[None], _shift_down(n_inc)))
    do_insert = do & ~exists
    out_lvl = jnp.where(do_insert[None], ins_lvl, lvl)
    out_ln = jnp.where(do_insert[None], ins_ln,
                       jnp.where(do[None], n_inc, ln))
    return out_lvl, out_ln, do_insert & (cnt >= n_rows)


def _street_merge(lvl, ln, contrib, do):
    """Levels-form ``merge-bets`` (street.py:street_merge): delete
    boundaries no contribution matches, compact the two columns."""
    n_rows = lvl.shape[0]
    matched = jnp.any(contrib[None] == lvl[:, None], axis=1)  # [L, 8, 128]
    keep = matched & (lvl > 0)
    # prefix sum over the (static, small) layer axis
    runs, run = [], None
    for j in range(n_rows):
        run = keep[j].astype(I32) if run is None else run + keep[j]
        runs.append(run)
    rank = jnp.stack(runs, axis=0) - 1
    sel = (rank[None] == _iota(n_rows)[:, None]) & keep[None]
    out_lvl = jnp.sum(jnp.where(sel, lvl[None], 0), axis=1)
    out_ln = jnp.sum(jnp.where(sel, ln[None], 0), axis=1)
    return (jnp.where(do[None], out_lvl, lvl),
            jnp.where(do[None], out_ln, ln))


def _suit_masks(cards):
    """Suit masks for a list of card-id arrays of any (equal) shape
    (pallas_equity._masks_of packed two-planes construction)."""
    pa = jnp.zeros_like(cards[0])
    pb = jnp.zeros_like(cards[0])
    one = jnp.ones_like(cards[0])
    for card in cards:
        suit = jnp.right_shift(card * 5, 6)
        p = (card - 13 * suit + 2) | jnp.left_shift(suit & 1, 4)
        bitv = jnp.left_shift(one, p)
        hi = suit > 1
        pa = pa | jnp.where(hi, 0, bitv)
        pb = pb | jnp.where(hi, bitv, 0)
    mask15 = (1 << 15) - 1
    return [pa & mask15, jnp.right_shift(pa, 16) & mask15,
            pb & mask15, jnp.right_shift(pb, 16) & mask15]


def _sample_cards(key, step, k):
    """k distinct cards from 52 via ordered draws + bubble insertion
    (``rollout.equity.sample_distinct`` on the counter generator): deal
    words DEAL_DRAW.. of ``step``. Returns [k] + key.shape card ids."""
    assert DEAL_DRAW + k <= STEP_DRAWS, k
    base = step * STEP_DRAWS + DEAL_DRAW
    draws = [uniform_int(key, base + t, 52 - t) for t in range(k)]
    sorted_chosen, cards = [], []
    for t in range(k):
        x = draws[t]
        for c in sorted_chosen:
            x = x + (x >= c).astype(I32)
        new_sorted, carry = [], x
        for c in sorted_chosen:
            new_sorted.append(jnp.minimum(carry, c))
            carry = jnp.maximum(carry, c)
        new_sorted.append(carry)
        sorted_chosen = new_sorted
        cards.append(x)
    # Materialize the deal: left to itself the compiler inlines the whole
    # insertion network into every consumer in the settle pass, and the
    # fused expressions (and compile times) blow up.
    return jax.lax.optimization_barrier(jnp.stack(cards, axis=0))


def _settle_payout(st, pots_amt, pots_set, pots_n, in_hand, P, reference):
    """Showdown evaluation + per-layer payout (step.py:settle_showdown):
    rank every seat's 7 cards with the cmp key, then pay each of the 4*L
    pot layers to its best eligible seat(s)."""
    from montecarlo_tpu.ops.evaluator import eval_masks_cmp_impl

    board_masks = _suit_masks([st["board"][i] for i in range(5)])
    hole_masks = _suit_masks([st["hole0"], st["hole1"]])  # [P, 8, 128] x4
    values = eval_masks_cmp_impl(*[b[None] | h for b, h
                                   in zip(board_masks, hole_masks)])
    in_hand_b = _mask_bits(in_hand, P) != 0  # [P, 8, 128]
    set_bits = (jnp.right_shift(pots_set[:, :, None], _iota(P)[None, None])
                & 1)  # [4, L, P, 8, 128]
    elig = (set_bits != 0) & in_hand_b[None, None]
    vmax = jnp.max(jnp.where(elig, values[None, None], 0), axis=2)
    winners = elig & (values[None, None] == vmax[:, :, None])
    cnt = jnp.sum(winners.astype(I32), axis=2)  # [4, L, 8, 128]
    if reference:
        # amt * inflated n, integer split, remainders vanish
        total_pot = pots_amt * pots_n
    else:
        # exactly the chips contributed: amt * |contributors|
        total_pot = pots_amt * jnp.sum(set_bits, axis=2)
    share = jnp.where(cnt > 0, total_pot // jnp.maximum(cnt, 1), 0)
    pay_rows = jnp.where(winners, share[:, :, None], 0)
    if not reference:
        # odd chips to the first-position winner of each layer
        rem = jnp.where(cnt > 0, total_pot % jnp.maximum(cnt, 1), 0)
        first = jnp.min(jnp.where(winners, _iota(P)[None, None], P), axis=2)
        pay_rows = pay_rows + jnp.where(
            _iota(P)[None, None] == first[:, :, None], rem[:, :, None], 0)
    return jnp.sum(pay_rows, axis=(0, 1))  # [P, 8, 128]


def _step_nosettle(st, raw_action, P, sb, bb, rules="reference"):
    """The betting half of ``step_table``: clamp, payment, levels algebra,
    membership updates, street flush + transitions, and hand-end
    DETECTION. A table whose hand ends here does not settle — it latches
    ``wait=1`` and empties its play order (so subsequent calls no-op via
    the no-head guard) until ``_settle_pass`` processes it. The per-step
    composition ``_settle_pass(_step_nosettle(st))`` is bit-identical to
    the round-2 fused step (pinned by the det-mode trajectory tests); the
    generator-mode runners instead run U betting steps per settle pass,
    removing the settle tensors — 74% of the fused step's time
    (PERF.md round-3 ablation) — from U-1 of every U steps.

    ``raw_action``: [8,128] pre-clamp policy action. Mirrors
    engine/step.py:apply_action + _advance_streets under the configured
    rules.
    """
    reference = rules == "reference"
    n_lvl = st["lvl"].shape[0]
    zero = jnp.zeros_like(st["stage"])
    head, cursor_after, exists = _head_info(st, P)
    head_onehot = _iota(P) == head[None]  # [P, 8, 128]
    head_bit = _pick(_seat_bits(P) + zero[None], head)

    # --- totals / clamp (street.py, step.py:clamp_action) ---
    total = _street_total(st["lvl"])
    delta = total - _pick(st["contrib"], head)
    stack_head = _pick(st["stacks"], head)
    cap = stack_head - delta
    clamped = jnp.maximum(0, jnp.minimum(raw_action, cap))
    action = jnp.where(raw_action > 0, clamped, raw_action)

    is_fold = action < 0
    is_raise = action > 0
    is_call = action == 0
    r = jnp.maximum(action, 0)
    is_check = is_call & (total == 0)
    threads = (is_call & (total > 0)) | is_raise

    # --- payment (step.py:apply_action) ---
    if reference:
        # call pays the full delta (stacks may go negative); raise threads
        # r + total.
        amount = jnp.where(is_raise, r + total, total)
        paid = jnp.where(threads, jnp.where(is_raise, delta + r, delta), 0)
    else:
        # standard: payments cap at the stack; an all-in for less joins
        # only what it can cover (splitting a side pot in the street).
        pay_call = jnp.minimum(delta, stack_head)
        pay_raise = jnp.minimum(delta + r, stack_head)
        amount = jnp.where(is_raise, r + total - (delta + r - pay_raise),
                           total - (delta - pay_call))
        paid = jnp.where(threads, jnp.where(is_raise, pay_raise, pay_call),
                         0)

    up_lvl, up_ln, ovf = _street_update(st["lvl"], st["ln"], amount, threads)
    do_merge = is_fold | is_check
    mg_lvl, mg_ln = _street_merge(st["lvl"], st["ln"], st["contrib"],
                                  do_merge)
    lvl = jnp.where(do_merge[None], mg_lvl, up_lvl)
    ln = jnp.where(do_merge[None], mg_ln, up_ln)
    contrib = jnp.where(head_onehot & threads[None],
                        jnp.maximum(st["contrib"], amount[None]),
                        st["contrib"])
    stacks = st["stacks"] - jnp.where(head_onehot, paid[None], 0)

    went_all_in = threads & (paid == stack_head)
    if reference:
        # exact-equality all-ins leave :players entirely (board.clj:53-89)
        in_hand = st["in_hand"] & ~jnp.where(is_fold | went_all_in,
                                             head_bit, 0)
        to_act = jnp.where(is_raise, in_hand & ~head_bit,
                           st["to_act"] & ~head_bit)
        order = st["order"] & ~jnp.where(is_fold, head_bit, 0)
    else:
        # standard: all-in seats stop acting but stay showdown-live
        in_hand = st["in_hand"] & ~jnp.where(is_fold, head_bit, 0)
        all_in = st["all_in"] | jnp.where(went_all_in, head_bit, 0)
        actable_now = in_hand & ~all_in
        to_act = jnp.where(is_raise, actable_now & ~head_bit,
                           st["to_act"] & ~head_bit)
        order = st["order"] & ~jnp.where(is_fold | went_all_in, head_bit, 0)
    folded = st["folded"] | jnp.where(is_fold, head_bit, 0)
    cursor = jnp.where(is_fold, st["cursor"], cursor_after)

    # --- street / hand end (step.py:stage_end/game_end) ---
    n_in = jnp.sum(_mask_bits(in_hand, P), axis=0)

    # --- flush the street into its pot slot. The street's content moves
    # to pots exactly once — when the betting round closes (transition or
    # settlement); later chained transitions see an empty street. ---
    stage_done0 = to_act == 0
    flush = stage_done0 | (n_in <= 1)
    live = lvl > 0
    row_amt = lvl - _shift_down(lvl)
    ge = (contrib[None] >= lvl[:, None]) & live[:, None]  # [L, P, 8, 128]
    if reference:
        # :players — folds removed at flush time
        not_folded = _mask_bits(folded, P) == 0
        layer_set = jnp.sum(jnp.where(ge & not_folded[None],
                                      _seat_bits(P)[None], 0), axis=1)
    else:
        # original contributors (folds keep their dead money's membership)
        layer_set = jnp.sum(jnp.where(ge, _seat_bits(P)[None], 0), axis=1)
    pots_amt = st["pot_amt"].reshape(4, n_lvl, *TILE)
    pots_set = st["pot_set"].reshape(4, n_lvl, *TILE)
    w = (flush[None] & (_iota(4) == st["stage"][None]))[:, None] & live[None]
    pots_amt = jnp.where(w, row_amt[None], pots_amt)
    pots_set = jnp.where(w, layer_set[None], pots_set)
    if reference:
        pots_n = st["pot_n"].reshape(4, n_lvl, *TILE)
        pots_n = jnp.where(w, ln[None], pots_n)

    # street reset after a flush
    lvl = jnp.where(flush[None], 0, lvl)
    ln = jnp.where(flush[None], 0, ln)
    contrib = jnp.where(flush[None], 0, contrib)

    # --- street transitions (step.py:_advance_streets): at most one under
    # reference rules; standard chains the board out (everyone all-in) ---
    stage = st["stage"]
    for _ in range(1 if reference else 4):
        stage_done = to_act == 0
        gend = (n_in <= 1) | (stage_done & (stage == 3))
        trans = stage_done & ~gend
        stage = jnp.where(trans, stage + 1, stage)
        actable = in_hand if reference else (in_hand & ~all_in)
        to_act = jnp.where(trans, actable, to_act)
        order = jnp.where(trans, actable, order)
        cursor = jnp.where(trans, zero, cursor)
    ended = (n_in <= 1) | ((to_act == 0) & (stage == 3))

    # --- hand-end latch: empty the play order (no-head no-op until the
    # settle pass) and raise the wait flag ---
    to_act = jnp.where(ended, zero, to_act)
    order = jnp.where(ended, zero, order)
    wait = st["wait"] | ended.astype(I32)

    # street_raises: reset on street or hand change (selfplay.py:140-147).
    applied = (action > 0) & exists
    transition_any = stage != st["stage"]
    street_raises = jnp.where(transition_any | ended, zero,
                              st["street_raises"] + applied.astype(I32))
    # last_raiser (engine/step.py:apply_action): set on raise, reset to P
    # ("none") with street_raises — feature-set v2 input.
    last_raiser = jnp.where(applied, head, st["last_raiser"])
    last_raiser = jnp.where(transition_any | ended, zero + P, last_raiser)

    out = {
        "stage": stage, "cursor": cursor, "street_raises": street_raises,
        "last_raiser": last_raiser,
        "folded": folded, "in_hand": in_hand, "to_act": to_act,
        "order": order, "wait": wait,
        "overflow": st["overflow"] | ovf.astype(I32),
        "stacks": stacks, "contrib": contrib,
        "lvl": lvl, "ln": ln,
        "pot_amt": pots_amt.reshape(4 * n_lvl, *TILE),
        "pot_set": pots_set.reshape(4 * n_lvl, *TILE),
    }
    if reference:
        out["pot_n"] = pots_n.reshape(4 * n_lvl, *TILE)
    else:
        out["all_in"] = all_in
    # No-head guard (step.py:step_table): full no-op when the play order is
    # empty — covers waiting tables between settle passes and frozen
    # tournament tables (and mirrors the XLA engine exactly).
    guarded = {
        name: jnp.where(exists[None] if out[name].ndim == 3 else exists,
                        out[name], st[name])
        for name in out
    }
    return {**st, **guarded}


def _settle_pass(st, new_cards, P, sb, bb, rules="reference", ss=100,
                 reset_stacks=False):
    """Settlement + next hand for every table whose ``wait`` flag is up:
    showdown payout (step.py:settle_showdown), delta meters, players-list
    rotation (gameplay.clj:136-137), blinds, and the injected/PRNG deal
    (``new_cards``: [2P+5, 8, 128]). Clears ``wait``; all other tables
    pass through untouched (tournament-frozen tables have wait == 0)."""
    reference = rules == "reference"
    tournament = rules == "tournament"
    n_lvl = st["lvl"].shape[0]
    zero = jnp.zeros_like(st["stage"])
    ended = st["wait"] != 0
    lvl, ln, contrib = st["lvl"], st["ln"], st["contrib"]
    in_hand, to_act, order = st["in_hand"], st["to_act"], st["order"]
    folded, cursor, stage = st["folded"], st["cursor"], st["stage"]
    if not reference:
        all_in = st["all_in"]
    pots_amt = st["pot_amt"].reshape(4, n_lvl, *TILE)
    pots_set = st["pot_set"].reshape(4, n_lvl, *TILE)
    if reference:
        pots_n = st["pot_n"].reshape(4, n_lvl, *TILE)

    # --- settlement (step.py:settle_showdown) ---
    payout = _settle_payout(st, pots_amt, pots_set,
                            pots_n if reference else None, in_hand, P,
                            reference)
    stacks = jnp.where(ended[None], st["stacks"] + payout, st["stacks"])
    hand_ct = st["hand_ct"] + ended.astype(I32)
    # Per-position settled chip delta for the finished hand (position 0 =
    # that hand's small blind; blinds paid are included — same accounting
    # as rollout.selfplay.play_hands collect_deltas).
    delta = stacks - st["hand_start"]
    delta_sum = st["delta_sum"] + jnp.where(ended[None], delta, 0)
    # Seat-space meters: seat = (button + position) % P, so the seat view
    # of the positional delta vector is roll(delta, button) — composed
    # from static rolls under a select (gather-free).
    seat_delta_inc = jnp.where(st["button"][None] == 0, delta, 0)
    for b in range(1, P):
        rolled = jnp.concatenate([delta[-b:], delta[:-b]], axis=0)
        seat_delta_inc = seat_delta_inc + jnp.where(
            st["button"][None] == b, rolled, 0)
    seat_delta = st["seat_delta"] + jnp.where(ended[None], seat_delta_inc,
                                              0)
    if tournament:
        # Record the 0-based hand index at which each SEAT first busted
        # (rollout/selfplay.py:play_tournament's busted_at). Seat view of
        # the settled positional stacks = roll(stacks, button).
        seat_stacks = jnp.where(st["button"][None] == 0, stacks, 0)
        for b in range(1, P):
            rolled = jnp.concatenate([stacks[-b:], stacks[:-b]], axis=0)
            seat_stacks = seat_stacks + jnp.where(st["button"][None] == b,
                                                  rolled, 0)
        newly = ended[None] & (seat_stacks <= 0) & (st["bust_at"] < 0)
        bust_at = jnp.where(newly, st["hand_ct"][None], st["bust_at"])

    # --- next hand (state.py:next_hand + begin_hand) ---
    # Rotate the players list by one (gameplay.clj:136-137): new position k
    # = old k+1; then blinds (unconditional under reference rules; capped
    # at the stack under standard) and the injected/PRNG deal.
    if tournament:
        # True elimination (state.py:next_hand tournament): rotate by the
        # distance to the next ALIVE position (blinds advance over busted
        # seats); once <=1 player holds chips the table FREEZES — setting
        # the play order empty makes the no-head guard a fixpoint.
        alive_pos = stacks > 0  # [P, 8, 128], settled position space
        n_alive = jnp.sum(alive_pos.astype(I32), axis=0)
        shift = jnp.min(jnp.where(alive_pos & (_iota(P) >= 1), _iota(P), P),
                        axis=0)
        shift = jnp.clip(shift, 1, P - 1)
        rot = jnp.where(shift[None] == 1,
                        jnp.concatenate([stacks[1:], stacks[:1]], axis=0),
                        stacks)
        for b in range(2, P):
            rolled = jnp.concatenate([stacks[b:], stacks[:b]], axis=0)
            rot = jnp.where(shift[None] == b, rolled, rot)
        freeze = ended & (n_alive <= 1)
        redeal = ended & ~freeze
        button_shift = shift
    else:
        rot = jnp.concatenate([stacks[1:], stacks[:1]], axis=0)
        freeze = jnp.zeros_like(ended)
        redeal = ended
        button_shift = 1
    if reset_stacks:
        # Independent-hand evaluation mode: every hand starts from full
        # stacks (the packed analog of single-hand duplicate evaluation;
        # seats still rotate through positions via the button).
        rot = jnp.full_like(rot, ss)
    seats = _iota(P)
    hand_start = jnp.where(redeal[None], rot, st["hand_start"])
    full = (1 << P) - 1
    if reference:
        blinds = jnp.where(seats == 0, sb, jnp.where(seats == 1, bb, 0))
        stacks = jnp.where(redeal[None], rot - blinds, stacks)
        lo, hi = min(sb, bb), max(sb, bb)
        if sb == bb:
            b_lvl, b_ln = [lo, 0], [2, 0]
        else:
            b_lvl, b_ln = [lo, hi], [2, 1]
        rows = _iota(n_lvl)
        blind_lvl = jnp.where(rows == 0, b_lvl[0],
                              jnp.where(rows == 1, b_lvl[1], 0)) + zero[None]
        blind_ln = jnp.where(rows == 0, b_ln[0],
                             jnp.where(rows == 1, b_ln[1], 0)) + zero[None]
        lvl = jnp.where(redeal[None], blind_lvl, lvl)
        ln = jnp.where(redeal[None], blind_ln, ln)
        contrib = jnp.where(redeal[None], blinds + zero[None], contrib)
        to_act_new = order_new = full + zero
        in_hand_new = full + zero
        cursor0 = 2 % P + zero
    else:
        if tournament:
            # Dead seats leave the deal; the big blind goes to the first
            # alive position >= 1 and action starts after it
            # (state.py:begin_hand tournament).
            alive_new = rot > 0
            alive_bm = jnp.sum(jnp.where(alive_new, _seat_bits(P), 0),
                               axis=0)
            bb_pos = jnp.min(jnp.where(alive_new & (_iota(P) >= 1),
                                       _iota(P), P), axis=0)
            bb_pos = jnp.minimum(bb_pos, P - 1)
            is_bb = _iota(P) == bb_pos[None]
            pay1_cap = _pick(rot, bb_pos)
            cursor0 = (bb_pos + 1) % P
            in_hand_new = alive_bm
        else:
            is_bb = _iota(P) == 1
            pay1_cap = rot[1]
            cursor0 = 2 % P + zero
            in_hand_new = full + zero
        pay0 = jnp.clip(sb, 0, jnp.maximum(rot[0], 0))
        pay1 = jnp.clip(bb, 0, jnp.maximum(pay1_cap, 0))
        pays = jnp.where(seats == 0, pay0[None],
                         jnp.where(is_bb, pay1[None], 0))
        new_stacks = rot - pays
        stacks = jnp.where(redeal[None], new_stacks, stacks)
        z = jnp.zeros_like(st["lvl"])
        l1, n1, _ = _street_update(z, z, pay0, pay0 > 0)
        l2, n2, _ = _street_update(l1, n1, pay1, pay1 > 0)
        lvl = jnp.where(redeal[None], l2, lvl)
        ln = jnp.where(redeal[None], n2, ln)
        contrib = jnp.where(redeal[None], pays, contrib)
        # all-in blinds (and, under standard rules, busted seats) sit out
        # as all-in-for-nothing but stay showdown-live
        dead_bm = jnp.sum(jnp.where(new_stacks <= 0, _seat_bits(P), 0),
                          axis=0)
        allin_bm = dead_bm & in_hand_new
        all_in = jnp.where(redeal, allin_bm, all_in)
        to_act_new = order_new = in_hand_new & ~allin_bm
    in_hand = jnp.where(redeal, in_hand_new, in_hand)
    to_act = jnp.where(redeal, to_act_new, to_act)
    order = jnp.where(redeal, order_new, order)
    folded = jnp.where(redeal, zero, folded)
    cursor = jnp.where(redeal, cursor0, cursor)
    stage = jnp.where(redeal, zero, stage)
    hole0 = jnp.where(redeal[None], new_cards[:P], st["hole0"])
    hole1 = jnp.where(redeal[None], new_cards[P:2 * P], st["hole1"])
    board = jnp.where(redeal[None], new_cards[2 * P:], st["board"])
    pots_amt = jnp.where(ended[None, None], 0, pots_amt)
    pots_set = jnp.where(ended[None, None], 0, pots_set)
    # Tournament freeze: empty play order makes the no-head guard a
    # permanent no-op (the XLA engine's terminal hand_over state).
    to_act = jnp.where(freeze, zero, to_act)
    order = jnp.where(freeze, zero, order)
    button = jnp.where(redeal, (st["button"] + button_shift) % P,
                       st["button"])
    wait = jnp.where(ended, zero, st["wait"])

    out = {
        "stage": stage, "cursor": cursor,
        "folded": folded, "in_hand": in_hand, "to_act": to_act,
        "order": order, "wait": wait, "hand_ct": hand_ct,
        "button": button,
        "stacks": stacks, "contrib": contrib,
        "hole0": hole0, "hole1": hole1, "board": board,
        "hand_start": hand_start, "delta_sum": delta_sum,
        "seat_delta": seat_delta,
        "lvl": lvl, "ln": ln,
        "pot_amt": pots_amt.reshape(4 * n_lvl, *TILE),
        "pot_set": pots_set.reshape(4 * n_lvl, *TILE),
    }
    if reference:
        pots_n = jnp.where(ended[None, None], 0, pots_n)
        out["pot_n"] = pots_n.reshape(4 * n_lvl, *TILE)
    else:
        out["all_in"] = all_in
    if tournament:
        out["bust_at"] = bust_at
    return {**st, **out}


def _engine_step(st, raw_action, new_cards, P, sb, bb,
                 rules="reference", ss=100, reset_stacks=False):
    """One fused ``step_table``: the betting step composed with an
    immediate settle pass (the det-mode runners use this form; the PRNG
    runners defer the settle pass, see ``_run_steps``)."""
    st = _step_nosettle(st, raw_action, P, sb, bb, rules)
    return _settle_pass(st, new_cards, P, sb, bb, rules, ss, reset_stacks)


def _policy_random(st, P, key, step):
    """random_policy (rollout/policy.py) on policy words 0-1 of ``step``."""
    base = step * STEP_DRAWS
    u = bits(key, base)
    amt = uniform_int(key, base + 1, MAX_RAISE) + 1

    head, _, _ = _head_info(st, P)
    owes = (_street_total(st["lvl"]) - _pick(st["contrib"], head)) > 0
    can_raise = st["street_raises"] < MAX_RAISES_PER_STREET

    is_fold = u < jnp.uint32(FOLD_P_BITS)
    is_raise = (u < jnp.uint32(RAISE_P_BITS)) & ~is_fold & can_raise
    return jnp.where(is_fold, jnp.where(owes, I32(-1), I32(0)),
                     jnp.where(is_raise, amt, I32(0)))


def _run_steps(st, n_steps, key, act, P, sb, bb, rules, ss=100,
               reset_stacks=False):
    """``n_steps`` PRNG-mode steps of one block: ``act(st, step)`` gives
    the raw actions; deals come from the counter generator. With DEFER
    dividing ``n_steps``, DEFER betting steps run per settle pass;
    otherwise every step settles."""
    n_cards = 2 * P + 5

    def betting(s, st):
        return _step_nosettle(st, act(st, s), P, sb, bb, rules)

    def settle(st, s):
        return _settle_pass(st, _sample_cards(key, s, n_cards), P, sb, bb,
                            rules, ss, reset_stacks=reset_stacks)

    if n_steps % DEFER:
        return jax.lax.fori_loop(
            0, n_steps, lambda s, st: settle(betting(s, st), s), st)

    def deferred(i, st):
        s0 = i * DEFER
        st = jax.lax.fori_loop(0, DEFER, lambda j, st: betting(s0 + j, st),
                               st, unroll=UNROLL)
        return settle(st, s0 + DEFER - 1)

    return jax.lax.fori_loop(0, n_steps // DEFER, deferred, st)


def _stash_cards(stash, st, hmax):
    """Deal of the next hand from an injected [hmax, 2P+5, 8, 128] stash:
    hand 0 was dealt at init; hand h reads stash row h, clamped to the
    last row like the XLA pipeline's table_decks[min(hand_idx, hmax-1)]
    (an exhausted stash re-deals the final deck instead of zero-filling)."""
    hand_ptr = jnp.minimum(st["hand_ct"] + 1, hmax - 1)
    sel = (jax.lax.broadcasted_iota(I32, (hmax, 1, 1, 1), 0)
           == hand_ptr[None, None])
    return jnp.sum(jnp.where(sel, stash, 0), axis=0)


def _launch_seed(seed: int, done: int) -> int:
    """Seed of the launch that starts after ``done`` steps of a run."""
    return (seed + done * 7919) & 0x7FFFFFFF


def _block_keys(seed, n_blocks, block0=0):
    """[n_blocks, 8, 128] generator keys of the tables of blocks
    ``block0 .. block0 + n_blocks - 1`` (global table index = block *
    TABLES_PER_BLOCK + row-major lane)."""
    lane = (jax.lax.broadcasted_iota(I32, (n_blocks,) + TILE, 0)
            * TABLES_PER_BLOCK
            + jax.lax.broadcasted_iota(I32, (n_blocks,) + TILE, 1) * TILE[1]
            + jax.lax.broadcasted_iota(I32, (n_blocks,) + TILE, 2))
    return stream_keys(seed, block0 * TABLES_PER_BLOCK + lane)


@partial(jax.jit, static_argnames=("P", "n_steps", "sb", "bb", "rules"))
def run_perpetual_prng(seed, state, P: int, n_steps: int, sb: int, bb: int,
                       rules: str = "reference", block0=0):
    """Run ``n_steps`` random-policy steps on every block.

    ``state``: packed [n_blocks, F, 8, 128] i32; ``block0``: global index
    of its first block (a shard's offset), so a sharded run draws exactly
    what one device draws for the same tables. ``n_steps`` is static: it
    fixes the deferred-settlement schedule."""
    layout, F = _field_layout(P, rules)

    def block(key, blk):
        st = _unpack(blk, layout)
        st = _run_steps(st, n_steps, key,
                        lambda st, s: _policy_random(st, P, key, s),
                        P, sb, bb, rules)
        return _pack(st, layout, F)

    return jax.vmap(block)(_block_keys(seed, state.shape[0], block0), state)


@partial(jax.jit, static_argnames=("P", "n_steps", "sb", "bb", "rules"))
def run_perpetual_det(state, actions, cards, P: int, n_steps: int,
                      sb: int, bb: int, rules: str = "reference"):
    """Deterministic mode: injected raw actions [n_blocks, n_steps, 8, 128]
    and per-hand deals [n_blocks, hmax, 2P+5, 8, 128] (hand 0 must already
    be dealt into ``state``; hand h>0 reads stash row h). Settles every
    step."""
    layout, F = _field_layout(P, rules)
    hmax = cards.shape[1]

    def block(blk, acts, stash):
        def body(i, st):
            return _engine_step(st, acts[i], _stash_cards(stash, st, hmax),
                                P, sb, bb, rules)

        st = jax.lax.fori_loop(0, n_steps, body, _unpack(blk, layout))
        return _pack(st, layout, F)

    return jax.vmap(block)(state, actions, cards)


# ---------------------------------------------------------------------------
# Host-side pack / unpack
# ---------------------------------------------------------------------------

def pack_state(cfg, first_cards):
    """Initial packed state for ``n_tables`` tables: first hand already
    dealt from ``first_cards`` [n_tables, 2P+5] (hole round-robin + board,
    matching state.py:begin_hand's consumption order), blinds posted.

    Returns [n_blocks, F, 8, 128] i32."""
    import numpy as np

    P = cfg.num_seats
    rules = cfg.rules
    assert rules in ("reference", "standard", "tournament"), rules
    layout, F = _field_layout(P, rules)
    n_tables = first_cards.shape[0]
    assert n_tables % TABLES_PER_BLOCK == 0
    n_blocks = n_tables // TABLES_PER_BLOCK
    sb, bb = cfg.small_blind, cfg.big_blind
    assert sb > 0 and bb > 0

    state = np.zeros((n_blocks, F) + TILE, np.int32)

    def put(name, i, val):
        off, rows = layout[name]
        assert 0 <= i < rows
        state[:, off + i] = np.asarray(val).reshape((n_blocks,) + TILE)

    full = (1 << P) - 1
    put("cursor", 0, np.full(n_tables, 2 % P))
    put("last_raiser", 0, np.full(n_tables, P))  # none yet this street
    put("in_hand", 0, np.full(n_tables, full))
    # Blinds: unconditional under reference rules; capped at the stack
    # under standard (fresh full stacks, so the cap only bites for tiny
    # configured starting stacks).
    pay0 = sb if rules == "reference" else min(sb, max(cfg.starting_stack,
                                                       0))
    pay1 = bb if rules == "reference" else min(bb, max(cfg.starting_stack,
                                                       0))
    for k in range(P):
        blind = pay0 if k == 0 else (pay1 if k == 1 else 0)
        put("stacks", k, np.full(n_tables, cfg.starting_stack - blind))
        put("hand_start", k, np.full(n_tables, cfg.starting_stack))
    lo, hi = min(pay0, pay1), max(pay0, pay1)
    if lo == hi:
        put("lvl", 0, np.full(n_tables, lo))
        put("ln", 0, np.full(n_tables, 2))
    else:
        put("lvl", 0, np.full(n_tables, lo))
        put("lvl", 1, np.full(n_tables, hi))
        put("ln", 0, np.full(n_tables, 2))
        put("ln", 1, np.full(n_tables, 1))
    put("contrib", 0, np.full(n_tables, pay0))
    put("contrib", 1, np.full(n_tables, pay1))
    if rules in ("standard", "tournament"):
        allin = sum((1 << k) for k, b in
                    enumerate([pay0, pay1] + [0] * (P - 2))
                    if cfg.starting_stack - b <= 0)
        put("all_in", 0, np.full(n_tables, allin))
        put("to_act", 0, np.full(n_tables, full & ~allin))
        put("order", 0, np.full(n_tables, full & ~allin))
    else:
        put("to_act", 0, np.full(n_tables, full))
        put("order", 0, np.full(n_tables, full))
    if rules == "tournament":
        for k in range(P):
            put("bust_at", k, np.full(n_tables, -1))
    fc = np.asarray(first_cards, np.int32)
    for k in range(P):
        put("hole0", k, fc[:, k])
        put("hole1", k, fc[:, P + k])
    for i in range(5):
        put("board", i, fc[:, 2 * P + i])
    return jnp.asarray(state)


def pack_streams(actions=None, cards=None):
    """Injected streams in block layout for the deterministic mode:
    raw actions [n_steps, T] -> [n_blocks, n_steps, 8, 128]; per-hand
    deals [T, hmax, 2P+5] -> [n_blocks, hmax, 2P+5, 8, 128]."""
    out = []
    if actions is not None:
        a = jnp.asarray(actions, I32)
        n_steps, T = a.shape
        out.append(a.reshape(n_steps, T // TABLES_PER_BLOCK, *TILE)
                   .transpose(1, 0, 2, 3))
    if cards is not None:
        c = jnp.asarray(cards, I32)
        T, hmax, k = c.shape
        out.append(c.transpose(1, 2, 0)
                   .reshape(hmax, k, T // TABLES_PER_BLOCK, *TILE)
                   .transpose(2, 0, 1, 3, 4))
    return out[0] if len(out) == 1 else tuple(out)


def unpack_field(state, cfg, name, i=0):
    """[n_blocks, F, 8, 128] -> flat [n_tables] view of one field row."""
    layout, _ = _field_layout(cfg.num_seats, cfg.rules)
    off, rows = layout[name]
    assert 0 <= i < rows
    return state[:, off + i].reshape(-1)


# ---------------------------------------------------------------------------
# Production wrapper: perpetual self-play on the packed engine
# ---------------------------------------------------------------------------

def selfplay_perpetual_kernel(seed: int, cfg, n_tables: int, n_steps: int,
                              steps_per_launch: int = 512):
    """Random-policy perpetual self-play on the packed-block engine.

    The packed-block counterpart of ``rollout.selfplay.play_hands_perpetual``:
    identical semantics (pinned by the deterministic mode's
    trajectory-equality tests), different (counter-based) random streams.
    The first hand is dealt with threefry; every subsequent deal and policy
    draw comes from the counter generator on the device.

    Returns ``(final_packed_state, hands_completed, overflowed_tables)``.
    """
    import numpy as np

    P = cfg.num_seats
    assert cfg.rules in ("reference", "standard", "tournament")
    assert n_tables % TABLES_PER_BLOCK == 0

    # First hand via threefry (same consumption order as begin_hand).
    keys = jax.random.split(jax.random.key(seed), n_tables)
    decks = jax.vmap(lambda k: jax.random.permutation(k, 52))(keys)
    base = 2 * P
    pos = list(range(base)) + [base + 1, base + 2, base + 3, base + 5,
                               base + 7]
    first_cards = np.asarray(decks)[:, pos]

    state = pack_state(cfg, first_cards)
    done = 0
    while done < n_steps:
        chunk = min(steps_per_launch, n_steps - done)
        state = run_perpetual_prng(_launch_seed(seed, done), state, P, chunk,
                                   cfg.small_blind, cfg.big_blind,
                                   rules=cfg.rules)
        done += chunk
    hands = int(jnp.sum(unpack_field(state, cfg, "hand_ct")))
    ovf = int(jnp.sum(unpack_field(state, cfg, "overflow")))
    return state, hands, ovf


def position_deltas(state, cfg):
    """Accumulated settled chip change per hand-order position across all
    completed hands (position 0 = each hand's small blind): (sums[P],
    hands). Mean bb/hand per position = sums / hands / big_blind — the
    packed-engine form of ``rollout.selfplay.position_winrates``."""
    import numpy as np

    P = cfg.num_seats
    sums = np.array([
        float(jnp.sum(unpack_field(state, cfg, "delta_sum", k)
                      .astype(jnp.float32)))
        for k in range(P)
    ])
    hands = int(jnp.sum(unpack_field(state, cfg, "hand_ct")))
    return sums, hands


# ---------------------------------------------------------------------------
# Policy network on the packed engine: seat-pinned agent evaluation
# ---------------------------------------------------------------------------

def _masked_suit_masks(cards, valids):
    """Suit masks over (card, valid) pairs — the masked form of
    ``_suit_masks`` (models/features.py:_masked_suit_masks)."""
    pa = jnp.zeros_like(cards[0])
    pb = jnp.zeros_like(cards[0])
    one = jnp.ones_like(cards[0])
    for card, valid in zip(cards, valids):
        suit = jnp.right_shift(card * 5, 6)
        pos = (card - 13 * suit + 2) | jnp.left_shift(suit & 1, 4)
        bitv = jnp.where(valid, jnp.left_shift(one, pos), 0)
        hi = suit > 1
        pa = pa | jnp.where(hi, 0, bitv)
        pb = pb | jnp.where(hi, bitv, 0)
    mask15 = (1 << 15) - 1
    return [pa & mask15, jnp.right_shift(pa, 16) & mask15,
            pb & mask15, jnp.right_shift(pb, 16) & mask15]


def _features(st, head, P, bb):
    """models/features.py:state_features on block arrays — the exact
    feature order and (hardcoded /100) normalizations the trained policy
    artifacts expect. Returns a list of 24 float32 [8,128] arrays."""
    from montecarlo_tpu import handval as hv
    from montecarlo_tpu.ops.evaluator import eval_masks_impl

    F32 = jnp.float32
    total = _street_total(st["lvl"])
    pot = total + jnp.sum(st["pot_amt"], axis=0)
    needed = total - _pick(st["contrib"], head)
    stack = _pick(st["stacks"], head)
    stage = st["stage"]
    n_comm = jnp.where(stage == 0, 0,
                       jnp.where(stage == 1, 3,
                                 jnp.where(stage == 2, 4, 5)))

    hole0 = _pick(st["hole0"], head)
    hole1 = _pick(st["hole1"], head)
    cards = [hole0, hole1] + [st["board"][i] for i in range(5)]
    true_ = jnp.ones_like(stage) != 0
    valids = [true_, true_] + [i < n_comm for i in range(5)]
    key = eval_masks_impl(*_masked_suit_masks(cards, valids))
    # both payloads are < 2^12 after the shifts, so the int32 route
    # to float is exact
    key = key.astype(jnp.uint32)
    category = jnp.right_shift(key, hv.CAT_SHIFT).astype(I32) \
        .astype(F32) / 8.0
    top_rank = (jnp.right_shift(key, 16) & 0xF).astype(I32) \
        .astype(F32) / 14.0

    r0 = (2 + hole0 % 13).astype(F32) / 14.0
    r1 = (2 + hole1 % 13).astype(F32) / 14.0
    suited = (jnp.right_shift(hole0 * 5, 6)
              == jnp.right_shift(hole1 * 5, 6)).astype(F32)
    paired = (hole0 % 13 == hole1 % 13).astype(F32)

    n_in = jnp.sum(_mask_bits(st["in_hand"], P), axis=0)
    n_act = jnp.sum(_mask_bits(st["to_act"], P), axis=0)
    pot_f = pot.astype(F32)
    needed_f = needed.astype(F32)

    # feature-set v2 (models/features.py indices 20-23)
    sr = st["street_raises"]
    has_aggr = sr > 0
    rel_raiser = jnp.where(
        has_aggr,
        ((st["last_raiser"] - head) % P).astype(F32) / P, 0.0)

    return [
        (stage == 0).astype(F32), (stage == 1).astype(F32),
        (stage == 2).astype(F32), (stage == 3).astype(F32),
        n_comm.astype(F32) / 5.0,
        pot_f / (100.0 * P),
        needed_f / 100.0,
        stack.astype(F32) / 100.0,
        (needed == 0).astype(F32),
        n_in.astype(F32) / P,
        n_act.astype(F32) / P,
        head.astype(F32) / P,
        pot_f / jnp.maximum(needed_f + pot_f, 1.0),
        needed_f / float(bb) / 10.0,
        category, top_rank, r0, r1, suited, paired,
        sr.astype(F32) / 4.0,
        has_aggr.astype(F32),
        rel_raiser,
        (sr >= 2).astype(F32),
    ]


def _gumbel_pick(logits, key, step):
    """Categorical sample over the leading axis via Gumbel argmax on
    Gumbel words 2.. of ``step`` (24 bits of each word)."""
    F32 = jnp.float32
    n = logits.shape[0]
    ctr = step * STEP_DRAWS + 2 + _iota(n)
    assert 2 + n <= DEAL_DRAW, n
    u = jnp.right_shift(bits(key[None], ctr), 8).astype(I32).astype(F32) \
        * (2.0 ** -24)
    g = -jnp.log(-jnp.log(jnp.maximum(u, 1e-12)))
    z = logits + g
    m = jnp.max(z, axis=0)
    return jnp.min(jnp.where(z == m[None], _iota(n), n), axis=0)


def _argmax_pick(logits):
    """Deterministic pick over the leading axis: first index attaining
    the max — the same tie-break as ``jnp.argmax`` and the det twin of
    ``_gumbel_pick``."""
    n = logits.shape[0]
    m = jnp.max(logits, axis=0)
    return jnp.min(jnp.where(logits == m[None], _iota(n), n), axis=0)


def _mlp_logits(fl, weights):
    """[n_feats, 8, 128] features -> [4, 8, 128] logits via the MLP, in
    the precision of ``models.policy_net.policy_logits``."""
    w1t, b1, w2t, b2, w3t, b3 = weights

    def dense(wt, b, x):
        # [out, in] x [in, 8, 128] -> [out, 8, 128]
        y = jnp.einsum("oi,i...->o...", wt, x, precision=MATMUL_PRECISION,
                       preferred_element_type=jnp.float32)
        return y + b[..., None]

    h = jax.nn.relu(dense(w1t, b1, fl))
    h = jax.nn.relu(dense(w2t, b2, h))
    return dense(w3t, b3, h)  # [4, 8, 128]


def _net_action(st, head, P, bb, weights, banks=None, seat_to_bank=None,
                key=None, step=None):
    """models/policy_net.py:net_policy on block arrays: MLP logits,
    categorical sampling via Gumbel argmax (argmax when ``key`` is None —
    the deterministic mode), menu mapping fold/call/2bb/pot.

    With ``banks=B`` and a static ``seat_to_bank`` map, the weights are
    B distinct nets flattened into ONE wide MLP (hidden [B*64],
    block-diagonal w2/w3 — see ``_stack_weights_league``): the SAME
    three contractions as a single net, then the acting table's [4]
    logit group is selected by one-hot over its head seat's bank —
    different nets at different seats of the same table
    (league/head-to-head evaluation)."""
    F32 = jnp.float32
    feats = _features(st, head, P, bb)
    fl = jnp.stack(feats, axis=0)  # [n_feats, 8, 128]

    if banks is None:
        logits = _mlp_logits(fl, weights)
    else:
        z = _mlp_logits(fl, weights).reshape(banks, 4, *TILE)
        head_seat = (st["button"] + head) % P
        bank = jnp.zeros_like(head_seat)
        for s in range(P):
            if seat_to_bank[s]:
                bank += (head_seat == s) * seat_to_bank[s]
        sel = (jax.lax.broadcasted_iota(I32, (banks, 1, 1, 1), 0)
               == bank[None, None]).astype(F32)
        logits = jnp.sum(z * sel, axis=0)

    total = _street_total(st["lvl"])
    needed = total - _pick(st["contrib"], head)
    free = needed == 0
    # folding with nothing owed is masked (policy_net.py:80-81)
    logits = jnp.where(_iota(4) == 0,
                       logits + jnp.where(free, -1e9, 0.0)[None], logits)
    idx = (_argmax_pick(logits) if key is None
           else _gumbel_pick(logits, key, step))

    pot = total + jnp.sum(st["pot_amt"], axis=0)
    small = 2 * bb
    pot_raise = jnp.maximum(pot + needed, small)
    return jnp.where(idx == 0, -1,
                     jnp.where(idx == 1, 0,
                               jnp.where(idx == 2, small, pot_raise)))


def _net_block_fn(P, n_steps, rules, sb, bb, ss, net_seats: int,
                  reset_stacks: bool, banks=None, seat_to_bank=None):
    """PRNG-mode net evaluation of one block: ``(key, block, weights) ->
    block``. Seats whose bit is set in ``net_seats`` play the net, the
    rest ``random_policy``."""
    layout, F = _field_layout(P, rules)

    def block(key, blk, weights):
        def act(st, s):
            rand = _policy_random(st, P, key, s)
            head, _, _ = _head_info(st, P)
            head_seat = (st["button"] + head) % P
            use_net = (jnp.right_shift(
                jnp.full_like(head_seat, net_seats), head_seat) & 1) != 0
            net = _net_action(st, head, P, bb, weights, banks=banks,
                              seat_to_bank=seat_to_bank, key=key, step=s)
            return jnp.where(use_net, net, rand)

        st = _run_steps(_unpack(blk, layout), n_steps, key, act, P, sb, bb,
                        rules, ss, reset_stacks=reset_stacks)
        return _pack(st, layout, F)

    return block


@partial(jax.jit, static_argnames=("P", "n_steps", "sb", "bb", "ss",
                                   "rules", "net_seats", "reset_stacks"))
def run_net_eval(seed, state, weights, P: int, n_steps: int, sb: int,
                 bb: int, ss: int, rules: str, net_seats: int,
                 reset_stacks: bool = True):
    block = _net_block_fn(P, n_steps, rules, sb, bb, ss, net_seats,
                          reset_stacks)
    return jax.vmap(block, in_axes=(0, 0, None))(
        _block_keys(seed, state.shape[0]), state, weights)


@partial(jax.jit, static_argnames=("P", "n_steps", "sb", "bb", "ss",
                                   "rules", "net_seats", "n_banks",
                                   "seat_to_bank", "reset_stacks"))
def run_net_league(seed, state, weights, P: int, n_steps: int, sb: int,
                   bb: int, ss: int, rules: str, net_seats: int,
                   n_banks: int, seat_to_bank,
                   reset_stacks: bool = True):
    """League evaluation: ``n_banks`` distinct nets flattened into wide
    block-diagonal weights (``_stack_weights_league``); seat k plays
    bank ``seat_to_bank[k]`` (static tuple). Seats not in ``net_seats``
    still play the random policy."""
    block = _net_block_fn(P, n_steps, rules, sb, bb, ss, net_seats,
                          reset_stacks, banks=n_banks,
                          seat_to_bank=seat_to_bank)
    return jax.vmap(block, in_axes=(0, 0, None))(
        _block_keys(seed, state.shape[0]), state, weights)


@partial(jax.jit, static_argnames=("P", "n_steps", "sb", "bb", "ss",
                                   "rules", "n_banks", "seat_to_bank",
                                   "reset_stacks"))
def run_net_det(state, cards, weights, P: int, n_steps: int, sb: int,
                bb: int, ss: int, rules: str, n_banks=None,
                seat_to_bank=None, reset_stacks: bool = False):
    """Deterministic net/league mode: argmax action selection and
    injected per-hand deals (``cards`` [n_blocks, hmax, 2P+5, 8, 128];
    hand 0 must already be dealt into ``state``), settling every step.
    Every seat plays the net; with ``n_banks``/``seat_to_bank`` the
    weights are a wide banked MLP (league shape,
    ``_stack_weights_league``). Trajectory-pinned against the XLA net
    pipeline in tests/test_pallas_engine.py."""
    layout, F = _field_layout(P, rules)
    hmax = cards.shape[1]

    def block(blk, stash):
        def body(i, st):
            head, _, _ = _head_info(st, P)
            raw = _net_action(st, head, P, bb, weights, banks=n_banks,
                              seat_to_bank=seat_to_bank)
            return _engine_step(st, raw, _stash_cards(stash, st, hmax), P,
                                sb, bb, rules, ss, reset_stacks=reset_stacks)

        st = jax.lax.fori_loop(0, n_steps, body, _unpack(blk, layout))
        return _pack(st, layout, F)

    return jax.vmap(block)(state, cards)


def _stack_weights_league(params_banks):
    """B distinct MLPs -> ONE wide MLP: hidden dims concatenate to
    [B*64]; w2/w3 become block-diagonal so the banks never mix; the
    output [B*4] holds each bank's logit group (selected per table by
    the head seat's bank). Same three contractions as a single net
    instead of B unrolled MLPs."""
    import numpy as np

    params_per_seat = params_banks
    S = len(params_per_seat)
    h1 = params_per_seat[0].w1.shape[1]
    h2 = params_per_seat[0].w2.shape[1]
    n_in = params_per_seat[0].w1.shape[0]
    n_out = params_per_seat[0].w3.shape[1]
    w1t = np.zeros((S * h1, n_in), np.float32)
    b1 = np.zeros((S * h1, 1), np.float32)
    w2t = np.zeros((S * h2, S * h1), np.float32)
    b2 = np.zeros((S * h2, 1), np.float32)
    w3t = np.zeros((S * n_out, S * h2), np.float32)
    b3 = np.zeros((S * n_out, 1), np.float32)
    for s, p in enumerate(params_per_seat):
        w1t[s * h1:(s + 1) * h1] = np.asarray(p.w1).T
        b1[s * h1:(s + 1) * h1, 0] = np.asarray(p.b1)
        w2t[s * h2:(s + 1) * h2, s * h1:(s + 1) * h1] = np.asarray(p.w2).T
        b2[s * h2:(s + 1) * h2, 0] = np.asarray(p.b2)
        w3t[s * n_out:(s + 1) * n_out, s * h2:(s + 1) * h2] = \
            np.asarray(p.w3).T
        b3[s * n_out:(s + 1) * n_out, 0] = np.asarray(p.b3)
    return tuple(jnp.asarray(a) for a in (w1t, b1, w2t, b2, w3t, b3))


def selfplay_net_league(seed: int, cfg, params_banks, seat_to_bank,
                        n_tables: int, n_steps: int, net_seats: int = -1,
                        steps_per_launch: int = 256, state0=None):
    """Head-to-head: seat k plays net ``params_banks[seat_to_bank[k]]``
    (for seats in ``net_seats``; others play random). The button
    rotates, so every net cycles through all positions — per-seat
    bb/hand is a fair multi-agent comparison over enough hands.

    Returns ``(bb_per_hand[P], stderr[P], hands)``.
    """
    import numpy as np

    P = cfg.num_seats
    seat_to_bank = tuple(int(b) for b in seat_to_bank)
    assert len(seat_to_bank) == P
    assert all(0 <= b < len(params_banks) for b in seat_to_bank)
    assert cfg.rules in ("reference", "standard")
    assert n_tables % TABLES_PER_BLOCK == 0

    if state0 is None:
        state0 = initial_packed_state(seed, cfg, n_tables)
    state = state0
    weights = _stack_weights_league(params_banks)
    if net_seats == -1:
        net_seats = (1 << P) - 1

    done = 0
    while done < n_steps:
        chunk = min(steps_per_launch, n_steps - done)
        state = run_net_league(_launch_seed(seed, done), state, weights, P,
                               chunk, cfg.small_blind, cfg.big_blind,
                               cfg.starting_stack, cfg.rules, net_seats,
                               len(params_banks), seat_to_bank)
        done += chunk

    hands_t = np.asarray(unpack_field(state, cfg, "hand_ct"), np.float64)
    hands = hands_t.sum()
    bb = cfg.big_blind
    means, errs = [], []
    for k in range(P):
        d = np.asarray(unpack_field(state, cfg, "seat_delta", k),
                       np.float64)
        means.append(d.sum() / max(hands, 1) / bb)
        per_table = d / np.maximum(hands_t, 1) / bb
        errs.append(per_table.std(ddof=1) / np.sqrt(len(per_table)))
    return np.array(means), np.array(errs), int(hands)


@partial(jax.jit, static_argnames=("P", "n_steps", "sb", "bb", "ss",
                                   "rules", "net_seats", "n_banks",
                                   "seat_to_bank", "reset_stacks"))
def run_net_eval_pop(seed, state, weights, P: int, n_steps: int, sb: int,
                     bb: int, ss: int, rules: str, net_seats: int,
                     n_banks=None, seat_to_bank=None,
                     reset_stacks: bool = True):
    """Population-batched net evaluation: one call runs C candidates.

    ``state``: [C, n_blocks, F, 8, 128]; each ``weights`` leaf carries a
    leading candidate axis [C, ...]. The generator stream is a function
    of the TABLE only, so all candidates play the same deals/random-seat
    draws (common random numbers).

    With ``n_banks``/``seat_to_bank``, each candidate's weights are a
    wide banked MLP (``_stack_weights_league``) — league fitness: the
    candidate plays its mapped seats against fixed opponent bank(s)."""
    block = _net_block_fn(P, n_steps, rules, sb, bb, ss, net_seats,
                          reset_stacks, banks=n_banks,
                          seat_to_bank=seat_to_bank)
    keys = _block_keys(seed, state.shape[1])
    blocks = jax.vmap(block, in_axes=(0, 0, None))
    return jax.vmap(blocks, in_axes=(None, 0, 0))(keys, state, weights)


def initial_packed_state(seed: int, cfg, n_tables: int):
    """First-hand packed state: threefry decks host-side (the per-call
    cost that dominates short evaluations — cache and reuse it when many
    evaluations share a seed, e.g. ES common-random-number generations)."""
    import numpy as np

    P = cfg.num_seats
    keys = jax.random.split(jax.random.key(seed), n_tables)
    decks = jax.vmap(lambda k: jax.random.permutation(k, 52))(keys)
    base = 2 * P
    pos = list(range(base)) + [base + 1, base + 2, base + 3, base + 5,
                               base + 7]
    return jax.device_put(pack_state(cfg, np.asarray(decks)[:, pos]))


def selfplay_net_eval_kernel(seed: int, cfg, params, net_seats: int,
                             n_tables: int, n_steps: int,
                             steps_per_launch: int = 256, state0=None):
    """Seat-pinned policy-net evaluation on the packed engine: seats whose bit
    is set in ``net_seats`` play the trained net (models/policy_net.py),
    the rest play ``random_policy``; every hand starts from full stacks
    (independent-hand evaluation; the button rotates seats through
    positions) and per-SEAT settled deltas accumulate on the device.

    Returns ``(bb_per_hand[P], stderr[P], hands)`` — mean chips/hand per
    stable seat in big blinds, with a per-table-clustered standard error.
    """
    import numpy as np

    P = cfg.num_seats
    assert cfg.rules in ("reference", "standard")
    assert n_tables % TABLES_PER_BLOCK == 0

    if state0 is None:
        state0 = initial_packed_state(seed, cfg, n_tables)
    state = state0

    weights = net_weights(params)
    done = 0
    while done < n_steps:
        chunk = min(steps_per_launch, n_steps - done)
        state = run_net_eval(_launch_seed(seed, done), state, weights, P,
                             chunk,
                             cfg.small_blind, cfg.big_blind,
                             cfg.starting_stack, cfg.rules, net_seats)
        done += chunk

    hands_t = np.asarray(unpack_field(state, cfg, "hand_ct"), np.float64)
    hands = hands_t.sum()
    bb = cfg.big_blind
    means, errs = [], []
    for k in range(P):
        d = np.asarray(unpack_field(state, cfg, "seat_delta", k),
                       np.float64)
        means.append(d.sum() / max(hands, 1) / bb)
        per_table = d / np.maximum(hands_t, 1) / bb
        errs.append(per_table.std(ddof=1) / np.sqrt(len(per_table)))
    return np.array(means), np.array(errs), int(hands)


def net_weights(params):
    """MLPParams -> the engine's weight leaves: [out, in] matrices and
    [out, 1] biases (``_mlp_logits``)."""
    return tuple(
        jnp.asarray(w.T if w.ndim == 2 else w.reshape(-1, 1), jnp.float32)
        for w in (params.w1, params.b1, params.w2, params.b2, params.w3,
                  params.b3))


def _stack_weights(params_list):
    """[MLPParams] -> engine weight leaves, each with a leading C axis."""
    per = [net_weights(p) for p in params_list]
    return tuple(jnp.stack([w[i] for w in per]) for i in range(6))


def selfplay_net_eval_pop(seed: int, cfg, params_list, net_seats: int,
                          n_tables: int, n_steps: int,
                          steps_per_launch: int = 256, state0=None):
    """Evaluate a POPULATION of policies in one call per chunk.

    Same semantics as ``selfplay_net_eval_kernel`` run once per candidate
    with a shared seed (common random numbers), but the candidate axis is
    batched, so the per-call overhead is paid once per generation instead
    of once per candidate.

    Returns ``(bb_per_hand[C, P], stderr[C, P], hands[C])``.
    """
    P = cfg.num_seats
    C = len(params_list)
    assert cfg.rules in ("reference", "standard")
    assert n_tables % TABLES_PER_BLOCK == 0

    if state0 is None:
        state0 = initial_packed_state(seed, cfg, n_tables)
    state = jnp.broadcast_to(state0[None], (C,) + state0.shape)
    weights = _stack_weights(params_list)

    done = 0
    while done < n_steps:
        chunk = min(steps_per_launch, n_steps - done)
        state = run_net_eval_pop(_launch_seed(seed, done), state, weights, P,
                                 chunk, cfg.small_blind, cfg.big_blind,
                                 cfg.starting_stack, cfg.rules, net_seats)
        done += chunk

    return _pop_meters(state, cfg)


def _pop_meters(state, cfg):
    """Per-candidate meters from a population run's final state.

    Slices just the meter rows on device: transferring the full final
    state to host is ~830 MB at training shapes; the hand counter plus
    P seat-delta rows is ~100x smaller, and the host math below stays
    identical to selfplay_net_eval_kernel's."""
    import numpy as np

    P = cfg.num_seats
    C = state.shape[0]
    bb = cfg.big_blind
    means = np.zeros((C, P))
    errs = np.zeros((C, P))
    hands = np.zeros(C, np.int64)
    layout, _ = _field_layout(P, cfg.rules)
    rows = [layout["hand_ct"][0]] + \
        [layout["seat_delta"][0] + k for k in range(P)]
    host = np.asarray(state[:, :, jnp.asarray(rows)])  # [C,nb,P+1,8,128]
    for c in range(C):
        hands_t = host[c, :, 0].reshape(-1).astype(np.float64)
        h = hands_t.sum()
        hands[c] = int(h)
        for k in range(P):
            d = host[c, :, 1 + k].reshape(-1).astype(np.float64)
            means[c, k] = d.sum() / max(h, 1) / bb
            per_table = d / np.maximum(hands_t, 1) / bb
            errs[c, k] = per_table.std(ddof=1) / np.sqrt(len(per_table))
    return means, errs, hands


def selfplay_net_league_pop(seed: int, cfg, cand_list, opponent,
                            n_tables: int, n_steps: int,
                            seat_to_bank=None, net_seats: int = -1,
                            steps_per_launch: int = 256, state0=None):
    """League fitness for a POPULATION: candidate c plays bank 0 at its
    mapped seats against a FIXED ``opponent`` net (bank 1) — one launch
    per chunk for all candidates, common random numbers across the
    generation (table-indexed generator). Default map seats seat 0 -> the
    candidate, seats 1..P-1 -> the opponent.

    Returns ``(bb_per_hand[C, P], stderr[C, P], hands[C])``.
    """
    P = cfg.num_seats
    C = len(cand_list)
    assert cfg.rules in ("reference", "standard")
    assert n_tables % TABLES_PER_BLOCK == 0
    if seat_to_bank is None:
        seat_to_bank = (0,) + (1,) * (P - 1)
    seat_to_bank = tuple(int(b) for b in seat_to_bank)
    if net_seats == -1:
        net_seats = (1 << P) - 1

    if state0 is None:
        state0 = initial_packed_state(seed, cfg, n_tables)
    state = jnp.broadcast_to(state0[None], (C,) + state0.shape)
    per_cand = [_stack_weights_league([cand, opponent])
                for cand in cand_list]
    weights = tuple(jnp.stack([w[i] for w in per_cand])
                    for i in range(6))

    done = 0
    while done < n_steps:
        chunk = min(steps_per_launch, n_steps - done)
        state = run_net_eval_pop(_launch_seed(seed, done), state, weights, P,
                                 chunk, cfg.small_blind, cfg.big_blind,
                                 cfg.starting_stack, cfg.rules,
                                 net_seats, n_banks=2,
                                 seat_to_bank=seat_to_bank)
        done += chunk
    return _pop_meters(state, cfg)


def tournaments_to_completion(seed: int, cfg, n_tables: int,
                              steps_per_launch: int = 512,
                              max_steps: int = 1 << 17):
    """Run tournament-rules tables until EVERY table freezes (one player
    holds all chips), relaunching the engine as long as live tables
    remain — total placements, no silent 2-4% unfinished tail.

    Frozen tables are idempotent no-ops inside the engine (empty play
    order), so relaunching costs only the shrinking set of live tables'
    progress; the host checks the frozen count between launches (one int
    per table). Returns ``(state, steps_used)``; raises if ``max_steps``
    is hit with live tables (random 6-max tournaments at 5/10 blinds
    finish in ~2-4k steps; the default bound is ~30x that).
    """
    import numpy as np

    assert cfg.rules == "tournament"
    P = cfg.num_seats
    assert n_tables % TABLES_PER_BLOCK == 0

    keys = jax.random.split(jax.random.key(seed), n_tables)
    decks = jax.vmap(lambda k: jax.random.permutation(k, 52))(keys)
    base = 2 * P
    pos = list(range(base)) + [base + 1, base + 2, base + 3, base + 5,
                               base + 7]
    state = pack_state(cfg, np.asarray(decks)[:, pos])

    done = 0
    while done < max_steps:
        state = run_perpetual_prng(_launch_seed(seed, done), state, P,
                                   steps_per_launch, cfg.small_blind,
                                   cfg.big_blind, rules=cfg.rules)
        done += steps_per_launch
        frozen = int(jnp.sum((unpack_field(state, cfg, "order") == 0)
                             .astype(I32)))
        if frozen == n_tables:
            return state, done
    raise RuntimeError(
        f"{n_tables - frozen} tournaments still live after {done} steps")


def tournament_results(state, cfg):
    """Kernel-scale tournament outcomes: per-seat finishing places
    (1 = winner) from the engine's bust records + final stacks, the
    packed form of ``rollout.selfplay.tournament_placements``.

    Unbusted seats outrank busted ones; later busts beat earlier; ties
    (same bust hand / same stack) share by stable order. Returns
    (placements [n_tables, P], frozen [n_tables] bool)."""
    import numpy as np

    assert cfg.rules == "tournament"
    P = cfg.num_seats
    bust = np.stack([np.asarray(unpack_field(state, cfg, "bust_at", k))
                     for k in range(P)], axis=1).astype(np.int64)
    # positional stacks -> seat view via the button
    button = np.asarray(unpack_field(state, cfg, "button"))
    stacks_pos = np.stack(
        [np.asarray(unpack_field(state, cfg, "stacks", k))
         for k in range(P)], axis=1).astype(np.int64)
    idx = (np.arange(P)[None, :] - button[:, None]) % P
    stacks = np.take_along_axis(stacks_pos, idx, axis=1)
    frozen = np.asarray(unpack_field(state, cfg, "order")) == 0
    alive_rank = np.where(bust < 0, np.iinfo(np.int32).max, bust)
    key = alive_rank * (stacks.max() + 2) + stacks
    places = np.argsort(np.argsort(-key, axis=1, kind="stable"),
                        axis=1, kind="stable") + 1
    return places, frozen
