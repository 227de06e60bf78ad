"""Heads-up push/fold Nash solver on the equity engine.

The classic short-stack game: the small blind either jams its whole stack
or folds; the big blind calls or folds. Equilibrium jam/call ranges are a
textbook result (e.g. the SB jams ~55-60% of hands at 10bb) — a natural
end-to-end validation target for the whole stack: the 169x169 all-in
matchup equity matrix comes from the batched rollout engine, and the
equilibrium from damped best-response iteration (fictitious play).

Three matrix backends:
- ``matchup_equity_matrix`` (Monte Carlo, single representatives);
- ``matchup_equity_matrix_exact`` (every matchup enumerated over all
  C(48,5) boards — 4.9e10 evaluations, ~160 s on one chip, zero noise;
  single representatives, so suit interactions within a class are averaged
  only approximately and card-removal combo counts are unconditional);
- ``matchup_equity_matrix_cr`` + ``matchup_pair_counts``
  (card-removal-CORRECT: hero = one representative per class — WLOG by
  suit symmetry — versus every one of the villain's 1326 combos, all
  boards enumerated per disjoint pair; class equities are the true
  combo-weighted averages and ``n_pairs`` gives the conditional combo
  counts). ``solve_push_fold_cr`` consumes these for an equilibrium with
  no removal approximation.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from montecarlo_tpu.cards import make_card
from montecarlo_tpu.ops.evaluator import eval_masks, suit_masks_from_cards
from montecarlo_tpu.rollout.equity import (
    canonical_hands,
    sample_distinct,
    slots_to_cards,
)

I32 = jnp.int32


def _representatives():
    """(labels, hero_combos [169,2], villain_combos [169,2], weights[169])."""
    names = "23456789TJQKA"
    labels, hero, villain, w = [], [], [], []
    for label, _ in canonical_hands():
        r1 = names.index(label[0]) + 2
        r2 = names.index(label[1]) + 2
        labels.append(label)
        if r1 == r2:
            hero.append((make_card(0, r1), make_card(1, r1)))      # h,d
            villain.append((make_card(2, r1), make_card(3, r1)))   # s,c
            w.append(6)
        elif label.endswith("s"):
            hero.append((make_card(0, r1), make_card(0, r2)))      # hearts
            villain.append((make_card(2, r1), make_card(2, r2)))   # spades
            w.append(4)
        else:
            hero.append((make_card(0, r1), make_card(1, r2)))      # h,d
            villain.append((make_card(2, r1), make_card(3, r2)))   # s,c
            w.append(12)
    return (labels, np.array(hero, np.int32), np.array(villain, np.int32),
            np.array(w, np.float64))


@partial(jax.jit, static_argnames=("batch", "n_chunks"))
def _pair_equities(key, heroes, villains, batch: int, n_chunks: int):
    """Vmapped hand-vs-hand equity for [M] matchups; returns win+tie/2 sums
    as float32 [M] (divide by batch*n_chunks on the host)."""

    def one(key, hero, vill):
        dead = jnp.sort(jnp.concatenate([hero, vill]))
        hm = suit_masks_from_cards(hero)
        vm = suit_masks_from_cards(vill)

        def chunk(carry, i):
            slots = sample_distinct(jax.random.fold_in(key, i), 48, 5, batch)
            board = slots_to_cards(slots, dead)
            bm = suit_masks_from_cards(board)
            vh = eval_masks(*[m | h for m, h in zip(bm, hm)])
            vv = eval_masks(*[m | v for m, v in zip(bm, vm)])
            score = (jnp.sum((vh > vv).astype(jnp.float32))
                     + 0.5 * jnp.sum((vh == vv).astype(jnp.float32)))
            return carry + score, None

        total, _ = jax.lax.scan(chunk, jnp.zeros((), jnp.float32),
                                jnp.arange(n_chunks))
        return total

    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(
        jnp.arange(heroes.shape[0]))
    return jax.vmap(one)(keys, heroes, villains)


def matchup_equity_matrix(key, n_per: int = 1 << 15,
                          m_chunk: int = 2048) -> np.ndarray:
    """[169, 169] hero-row-vs-villain-column all-in equity matrix."""
    _, hero, villain, _ = _representatives()
    hh = np.repeat(np.arange(169), 169)
    vv = np.tile(np.arange(169), 169)
    heroes = jnp.asarray(hero[hh])
    villains = jnp.asarray(villain[vv])
    batch = min(n_per, 1 << 13)
    n_chunks = -(-n_per // batch)
    out = np.empty((169 * 169,), np.float64)
    for i in range(0, heroes.shape[0], m_chunk):
        sums = _pair_equities(jax.random.fold_in(key, i),
                              heroes[i:i + m_chunk], villains[i:i + m_chunk],
                              batch, n_chunks)
        out[i:i + m_chunk] = np.asarray(sums, np.float64) / (batch * n_chunks)
    return out.reshape(169, 169)


def _all_board_slots() -> np.ndarray:
    """All C(48,5) = 1,712,304 board slot quintuples (int8 [M, 5])."""
    import itertools

    return np.fromiter(
        itertools.chain.from_iterable(itertools.combinations(range(48), 5)),
        dtype=np.int8).reshape(-1, 5)


@partial(jax.jit, static_argnames=())
def _pair_exact_scores(dead, hm, vm, board_slots):
    """2*wins + ties over enumerated boards, vmapped over pairs.

    ``dead``: [G, 4]; ``hm``/``vm``: [G][4] suit masks; ``board_slots``:
    [NC, C, 5] int8 slot indices into the 48-card live deck, scanned over
    the leading chunk axis inside the jit (pair-independent: the dead-card
    shift maps slots to each pair's concrete cards)."""

    def one(dead, hm, vm):
        def chunk(acc, slots8):
            cards = slots8.astype(I32)
            for j in range(4):
                cards = cards + (cards >= dead[j])
            bm = suit_masks_from_cards(cards)
            vh = eval_masks(*[m | h for m, h in zip(bm, hm)])
            vv = eval_masks(*[m | v for m, v in zip(bm, vm)])
            return acc + 2 * jnp.sum((vh > vv).astype(I32)) \
                + jnp.sum((vh == vv).astype(I32)), None

        total, _ = jax.lax.scan(chunk, jnp.zeros((), I32), board_slots)
        return total

    return jax.vmap(one, in_axes=(0, 0, 0))(dead, hm, vm)


def matchup_equity_matrix_exact(m_chunk: int = 64,
                                board_chunk: int = 1 << 17) -> np.ndarray:
    """EXACT [169, 169] all-in equity matrix: every matchup enumerated over
    all C(48,5) boards (no Monte Carlo noise); an accelerator job."""
    _, hero, villain, _ = _representatives()
    hh = np.repeat(np.arange(169), 169)
    vv = np.tile(np.arange(169), 169)
    heroes = hero[hh]
    villains = villain[vv]
    M = heroes.shape[0]

    boards = _all_board_slots()
    n_boards = boards.shape[0]
    pad = (-n_boards) % board_chunk
    if pad:  # pad with repeats of board 0; subtract their contribution
        boards = np.concatenate([boards, np.tile(boards[:1], (pad, 1))])
    boards3d = jnp.asarray(boards.reshape(-1, board_chunk, 5))
    board0 = jnp.asarray(boards[:1].reshape(1, 1, 5))

    dead_all = np.sort(np.concatenate([heroes, villains], axis=1), axis=1)
    hm_all = np.stack(
        [np.asarray(m) for m in suit_masks_from_cards(jnp.asarray(heroes))],
        axis=1)
    vm_all = np.stack(
        [np.asarray(m) for m in suit_masks_from_cards(jnp.asarray(villains))],
        axis=1)

    scores = np.zeros((M,), np.int64)
    for g in range(0, M, m_chunk):
        dead = jnp.asarray(dead_all[g:g + m_chunk])
        hm = [jnp.asarray(hm_all[g:g + m_chunk, s]) for s in range(4)]
        vm = [jnp.asarray(vm_all[g:g + m_chunk, s]) for s in range(4)]
        total = np.asarray(_pair_exact_scores(dead, hm, vm, boards3d),
                           np.int64)
        if pad:  # remove the padded duplicates of board 0
            s0 = np.asarray(_pair_exact_scores(dead, hm, vm, board0),
                            np.int64)
            total -= s0 * pad
        scores[g:g + m_chunk] = total
    return (scores / (2.0 * n_boards)).reshape(169, 169)


def _all_combos():
    """All 1326 hole combos with their canonical-class index.

    Returns (combos [1326, 2] int32, cls [1326] int32 indexing the 169
    canonical hands in ``canonical_hands()`` order).
    """
    labels = [l for l, _ in canonical_hands()]
    idx = {l: i for i, l in enumerate(labels)}
    names = "23456789TJQKA"
    combos, cls = [], []
    for c1 in range(52):
        for c2 in range(c1 + 1, 52):
            s1, r1 = c1 // 13, 2 + c1 % 13
            s2, r2 = c2 // 13, 2 + c2 % 13
            if r1 < r2:
                (s1, r1), (s2, r2) = (s2, r2), (s1, r1)
            if r1 == r2:
                label = names[r1 - 2] * 2
            else:
                label = (names[r1 - 2] + names[r2 - 2]
                         + ("s" if s1 == s2 else "o"))
            combos.append((make_card(s1, r1), make_card(s2, r2)))
            cls.append(idx[label])
    return np.array(combos, np.int32), np.array(cls, np.int32)


def matchup_pair_counts() -> np.ndarray:
    """[169, 169] card-removal-correct pair counts:
    ``n_pairs[a, b] = combos(a) * #(villain combos of class b disjoint from
    one fixed hero-a combo)`` — by suit symmetry the inner count is the
    same for every hero-a combo, so this equals the number of (hero combo,
    villain combo) deals of classes (a, b). Rows sum to
    ``combos(a) * C(50, 2) = combos(a) * 1225``.
    """
    _, hero_reps, _, w = _representatives()
    combos, cls = _all_combos()
    n = np.zeros((169, 169), np.int64)
    for a in range(169):
        rep = set(hero_reps[a].tolist())
        disj = ~np.array([bool(rep & set(c)) for c in combos.tolist()])
        np.add.at(n[a], cls[disj], 1)
    return n * w[:, None].astype(np.int64)


def matchup_equity_matrix_cr(elem_budget: int = 1 << 27,
                             progress: bool = False):
    """Card-removal-correct EXACT [169, 169] class equity matrix.

    For each hero class one representative combo (WLOG: the villain side
    enumerates all 1326 combos, so suit relabeling maps any hero combo onto
    the representative) is matched against every disjoint villain combo
    over every C(48, 5) board. Entry [a, b] is hero-a's equity averaged
    over villain-b combos with true conditional weights.

    Returns (eq_cr [169, 169] float64, n_pairs [169, 169] int64).
    ~2.3e12 device comparisons — an accelerator job; use the committed
    artifact (``data/pushfold_eq169_cr.npz``) rather than rebuilding.
    """
    import sys
    import time as _time

    from montecarlo_tpu.rollout.equity import equity_exact_range_vs_range

    _, hero_reps, _, _ = _representatives()
    combos, cls = _all_combos()
    t0 = _time.perf_counter()

    def _log(done):
        if progress:
            print(f"  boards {done:,} ({_time.perf_counter() - t0:.0f}s)",
                  file=sys.stderr, flush=True)

    res = equity_exact_range_vs_range(hero_reps, combos,
                                      elem_budget=elem_budget,
                                      progress=_log)
    # Class-aggregate the [169, 1326] pair results with equal weight per
    # surviving combo pair (pair_weight is 1 where disjoint, 0 otherwise).
    w = res.pair_weight                      # [169, 1326]
    pe = np.where(w > 0, res.pair_equity, 0.0)
    eq = np.zeros((169, 169), np.float64)
    cnt = np.zeros((169, 169), np.float64)
    for b in range(169):
        sel = cls == b
        eq[:, b] = (pe[:, sel] * w[:, sel]).sum(axis=1)
        cnt[:, b] = w[:, sel].sum(axis=1)
    eq = eq / np.maximum(cnt, 1e-12)
    return eq, matchup_pair_counts()


class PushFoldSolution(NamedTuple):
    labels: list
    jam: np.ndarray         # [169] SB jam probability
    call: np.ndarray        # [169] BB call-vs-jam probability
    stack_bb: float

    def jam_range(self, threshold: float = 0.5):
        return [l for l, p in zip(self.labels, self.jam) if p > threshold]

    def call_range(self, threshold: float = 0.5):
        return [l for l, p in zip(self.labels, self.call) if p > threshold]

    @property
    def jam_fraction(self) -> float:
        _, _, _, w = _representatives()
        return float((self.jam * w).sum() / w.sum())

    @property
    def call_fraction(self) -> float:
        _, _, _, w = _representatives()
        return float((self.call * w).sum() / w.sum())


def solve_push_fold(eq: np.ndarray, stack_bb: float,
                    iters: int = 2000, damping: float = 0.05
                    ) -> PushFoldSolution:
    """Fictitious play on the jam/call game at ``stack_bb`` effective
    stacks (blinds 0.5/1; stacks include the posted blinds).

    SB folds: -0.5. SB jams: +1 if BB folds; 2S*eq - S if called.
    BB facing a jam: fold -1; call 2S*eq' - S.
    """
    labels, _, _, w = _representatives()
    w = w / w.sum()
    S = float(stack_bb)

    jam = np.full(169, 0.5)
    call = np.full(169, 0.5)
    for _ in range(iters):
        # BB best response to jam: call iff EV(call) > EV(fold) = -1.
        jam_w = w * jam
        jam_mass = jam_w.sum()
        if jam_mass > 0:
            # eq.T[v, h]: villain(BB) equity vs hero hand h = 1 - eq[h, v].
            ev_call = ((1.0 - eq) * jam_w[:, None]).sum(axis=0) / jam_mass
            br_call = (2 * S * ev_call - S > -1.0).astype(float)
        else:
            br_call = np.zeros(169)
        # SB best response to call: jam iff EV(jam) > EV(fold) = -0.5.
        ev_jam = ((1 - call[None, :]) * 1.0
                  + call[None, :] * (2 * S * eq - S)) @ w
        br_jam = (ev_jam > -0.5).astype(float)
        jam = (1 - damping) * jam + damping * br_jam
        call = (1 - damping) * call + damping * br_call
    return PushFoldSolution(labels=labels, jam=jam, call=call, stack_bb=S)


def solve_push_fold_cr(eq_cr: np.ndarray, n_pairs: np.ndarray,
                       stack_bb: float, iters: int = 2000,
                       damping: float = 0.05) -> PushFoldSolution:
    """Fictitious play with card-removal-correct combo weighting.

    ``eq_cr``/``n_pairs`` from ``matchup_equity_matrix_cr`` (or the
    committed ``data/pushfold_eq169_cr.npz``). Where ``solve_push_fold``
    weights opposing classes by unconditional combo counts, here the
    opponent-class distribution conditions on the player's own two cards:
    ``P(villain class b | hero class a) = n_pairs[a, b] / (combos(a)*1225)``
    and Bayes inverts through the same pair counts for the caller.
    """
    labels, _, _, _ = _representatives()
    S = float(stack_bb)
    # P(BB class b | SB class a): conditional on SB's two cards removed.
    p_b_given_a = n_pairs / n_pairs.sum(axis=1, keepdims=True)

    jam = np.full(169, 0.5)
    call = np.full(169, 0.5)
    for _ in range(iters):
        # BB best response: P(SB class a | BB class b, SB jams) ∝
        # jam[a] * n_pairs[a, b] (n_pairs is the joint deal count).
        post = jam[:, None] * n_pairs  # [a, b]
        mass = post.sum(axis=0)
        ev_call = np.where(
            mass > 0,
            (2 * S * ((1.0 - eq_cr) * post).sum(axis=0) / np.maximum(mass, 1e-300)) - S,
            -np.inf)
        br_call = (ev_call > -1.0).astype(float)
        # SB best response under conditional villain-class weights.
        ev_jam = (p_b_given_a
                  * ((1 - call[None, :]) * 1.0
                     + call[None, :] * (2 * S * eq_cr - S))).sum(axis=1)
        br_jam = (ev_jam > -0.5).astype(float)
        jam = (1 - damping) * jam + damping * br_jam
        call = (1 - damping) * call + damping * br_call
    return PushFoldSolution(labels=labels, jam=jam, call=call, stack_bb=S)
