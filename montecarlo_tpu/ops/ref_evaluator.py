"""Reference-faithful naive hand evaluator (pure Python oracle).

Mirrors the *semantics* of the reference's combinatorial evaluator
(``hand_evaluator.clj:112-133``): a 5-card hand maps to a triple
``[category hit-ranks kicker-ranks]``; a 7-card hand is the max over all
C(7,5)=21 five-card combinations (``hand_evaluator.clj:162-172``).

Faithfully preserved quirks:

- No wheel: a straight is *strictly consecutive ranks* (``:32-40``); the ace
  is always rank 14, so A-2-3-4-5 is not a straight.
- Full house compares by trips rank then pair rank with **no kickers**
  (``ret-full-house`` ``:104-106``). (The reference stores a lazy seq there,
  which would crash Clojure ``compare``; we implement the evident intent.)
- High card stores all five ranks as the *hit* with empty kickers — the
  reference calls ``(ret 0 [] cards)`` at ``:133``, passing the whole hand
  through the ``hit`` argument.

This module is the conformance oracle for the array evaluators; it is O(n^2)
per hand and never used on a hot path.
"""

from __future__ import annotations

from collections import Counter
from itertools import combinations
from typing import Iterable, List, Sequence, Tuple

from montecarlo_tpu.cards import card_rank, card_suit
from montecarlo_tpu import handval as hv

Card = Tuple[int, int]  # (suit, rank)


def _from_ids(cards: Iterable[int]) -> List[Card]:
    return [(card_suit(c), card_rank(c)) for c in cards]


def _is_straight(ranks: Sequence[int]) -> bool:
    s = sorted(ranks)
    return all(s[i] + 1 == s[i + 1] for i in range(len(s) - 1))


def ref_eval5_triple(cards: Sequence[Card]) -> Tuple[int, List[int], List[int]]:
    """Evaluate exactly 5 cards to the reference triple (cat, hits, kickers)."""
    assert len(cards) == 5
    ranks = [r for _, r in cards]
    suits = [s for s, _ in cards]
    desc = sorted(ranks, reverse=True)
    is_straight = _is_straight(ranks)
    is_flush = len(set(suits)) == 1
    counts = Counter(ranks)
    by_count = sorted(counts.items(), key=lambda kv: (kv[1], kv[0]), reverse=True)

    if is_straight and is_flush:
        return hv.CAT_STRAIGHT_FLUSH, desc, []
    if by_count[0][1] == 4:
        q = by_count[0][0]
        kick = [r for r in desc if r != q]
        return hv.CAT_QUADS, [q] * 4, kick
    if by_count[0][1] == 3 and len(by_count) == 2:  # 3 + 2
        t, p = by_count[0][0], by_count[1][0]
        return hv.CAT_FULL_HOUSE, [t, t, t, p, p], []
    if is_flush:
        return hv.CAT_FLUSH, desc, []
    if is_straight:
        return hv.CAT_STRAIGHT, desc, []
    if by_count[0][1] == 3:
        t = by_count[0][0]
        kick = [r for r in desc if r != t]
        return hv.CAT_TRIPS, [t] * 3, kick
    pairs = sorted((r for r, n in counts.items() if n == 2), reverse=True)
    if len(pairs) == 2:
        hi, lo = pairs
        kick = [r for r in desc if r != hi and r != lo]
        return hv.CAT_TWO_PAIR, [hi, hi, lo, lo], kick
    if len(pairs) == 1:
        p = pairs[0]
        kick = [r for r in desc if r != p]
        return hv.CAT_PAIR, [p, p], kick
    return hv.CAT_HIGH, desc, []


def ref_eval5(cards: Sequence[Card]) -> int:
    cat, hits, kicks = ref_eval5_triple(cards)
    return hv.pack_value(cat, hits, kicks)


def ref_eval_best(card_ids: Sequence[int]) -> int:
    """Max packed value over all 5-card combinations (reference 7-card path)."""
    cards = _from_ids(card_ids)
    assert len(cards) >= 5, "reference crashes below 5 available cards"
    return max(ref_eval5(list(c)) for c in combinations(cards, 5))
