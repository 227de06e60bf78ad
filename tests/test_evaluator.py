"""Evaluator conformance tests.

The 10 golden vectors come verbatim from the reference's only healthy suite
(``test/montecarlo/hand_evaluator_test.clj:57-137``) — they are the ranking
spec. The bitmask array evaluator is then cross-checked against the naive
oracle on random and structured 7-card hands.
"""

import itertools
import random

import jax.numpy as jnp
import numpy as np
import pytest

from montecarlo_tpu import handval as hv
from montecarlo_tpu.cards import make_card
from montecarlo_tpu.ops.ref_evaluator import (
    ref_eval5,
    ref_eval5_triple,
    ref_eval_best,
)
from montecarlo_tpu.ops.evaluator import eval7_from_cards, eval_masks, suit_masks_from_cards

H, D, S, C = 0, 1, 2, 3  # :hearts :diamonds :spades :clubs


def triple(cards):
    cat, hits, kicks = ref_eval5_triple(cards)
    return [cat, list(hits), list(kicks)]


# (cards as (suit, rank), expected [category hit-ranks kickers]) — verbatim
# from hand_evaluator_test.clj:57-137. Some reference hands contain duplicate
# physical cards (e.g. the hearts 5 twice); the oracle accepts them like the
# reference does.
GOLDEN = [
    ([(H, 5), (H, 6), (H, 7), (H, 8), (H, 9)], [8, [9, 8, 7, 6, 5], []]),
    ([(H, 1), (D, 1), (S, 1), (C, 1), (H, 3)], [7, [1, 1, 1, 1], [3]]),
    ([(H, 9), (D, 8), (S, 9), (C, 8), (H, 8)], [6, [8, 8, 8, 9, 9], []]),
    ([(H, 4), (H, 5), (H, 6), (H, 7), (H, 9)], [5, [9, 7, 6, 5, 4], []]),
    ([(H, 1), (D, 2), (S, 3), (C, 5), (H, 4)], [4, [5, 4, 3, 2, 1], []]),
    ([(H, 5), (D, 2), (S, 8), (C, 5), (S, 5)], [3, [5, 5, 5], [8, 2]]),
    ([(H, 5), (D, 2), (S, 3), (C, 5), (H, 5)], [3, [5, 5, 5], [3, 2]]),
    ([(H, 5), (D, 2), (S, 8), (C, 2), (H, 5)], [2, [5, 5, 2, 2], [8]]),
    ([(H, 5), (D, 2), (S, 7), (C, 7), (H, 5)], [2, [7, 7, 5, 5], [2]]),
    ([(H, 5), (D, 7), (S, 8), (C, 6), (H, 5)], [1, [5, 5], [8, 7, 6]]),
    ([(H, 2), (D, 7), (S, 8), (C, 6), (H, 4)], [0, [8, 7, 6, 4, 2], []]),
]


@pytest.mark.parametrize("cards,expected", GOLDEN)
def test_golden_vectors_oracle(cards, expected):
    for perm in itertools.islice(itertools.permutations(cards), 0, 120, 17):
        assert triple(list(perm)) == expected


def test_pack_order_matches_triple_order():
    # Integer order of packed keys == lexicographic order of triples.
    keys_and_triples = []
    for cards, expected in GOLDEN:
        cat, hits, kicks = ref_eval5_triple(cards)
        key = hv.pack_value(cat, hits, kicks)
        keys_and_triples.append((key, (cat, list(hits) + list(kicks))))
    by_key = sorted(keys_and_triples, key=lambda kv: kv[0])
    by_triple = sorted(keys_and_triples, key=lambda kv: kv[1])
    assert [k for k, _ in by_key] == [k for k, _ in by_triple]


def _mask_eval_single(cards):
    ids = jnp.array([[make_card(s, r) for s, r in cards]], dtype=jnp.int32)
    return int(eval7_from_cards(ids)[0])


@pytest.mark.parametrize(
    "cards,expected",
    # distinct physical cards with real ranks (card ids can't encode the
    # synthetic rank-1 cards some reference vectors use)
    [(c, e) for c, e in GOLDEN
     if len(set(c)) == 5 and all(r >= 2 for _, r in c)],
)
def test_golden_vectors_bitmask(cards, expected):
    cat, hits, kicks = expected[0], expected[1], expected[2]
    assert _mask_eval_single(cards) == hv.pack_value(cat, hits, kicks)


def test_bitmask_vs_oracle_random_7card():
    rng = random.Random(0xC0FFEE)
    hands = [rng.sample(range(52), 7) for _ in range(4000)]
    got = np.asarray(eval7_from_cards(jnp.array(hands, dtype=jnp.int32)))
    want = np.array([ref_eval_best(h) for h in hands], dtype=np.uint32)
    mismatch = np.nonzero(got != want)[0]
    assert mismatch.size == 0, (hands[mismatch[0]], got[mismatch[0]], want[mismatch[0]])


def test_bitmask_vs_oracle_structured_7card():
    # Structured corners: quads+trips, double trips, three pairs, near-wheel,
    # flush+straight-no-SF, 6-card flushes, SF with higher offsuit ranks.
    hands = [
        [make_card(s, 8) for s in range(4)] + [make_card(s, 11) for s in range(3)],
        [make_card(s, 8) for s in range(3)] + [make_card(s, 11) for s in range(3)]
        + [make_card(0, 2)],
        [make_card(0, 4), make_card(1, 4), make_card(0, 9), make_card(1, 9),
         make_card(0, 12), make_card(1, 12), make_card(2, 14)],
        [make_card(0, 14), make_card(1, 2), make_card(2, 3), make_card(3, 4),
         make_card(0, 5), make_card(1, 9), make_card(2, 11)],
        [make_card(0, 2), make_card(0, 3), make_card(0, 4), make_card(0, 5),
         make_card(1, 6), make_card(0, 9), make_card(0, 12)],
        [make_card(2, 5), make_card(2, 6), make_card(2, 7), make_card(2, 8),
         make_card(2, 9), make_card(2, 14), make_card(0, 14)],
        [make_card(3, 10), make_card(3, 11), make_card(3, 12), make_card(3, 13),
         make_card(3, 14), make_card(3, 2), make_card(0, 14)],
    ]
    got = np.asarray(eval7_from_cards(jnp.array(hands, dtype=jnp.int32)))
    want = np.array([ref_eval_best(h) for h in hands], dtype=np.uint32)
    np.testing.assert_array_equal(got, want)


def test_bitmask_vs_oracle_random_5card():
    rng = random.Random(1234)
    hands = [rng.sample(range(52), 5) for _ in range(2000)]
    masks = suit_masks_from_cards(jnp.array(hands, dtype=jnp.int32))
    got = np.asarray(eval_masks(*masks))
    want = np.array([ref_eval_best(h) for h in hands], dtype=np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.slow
def test_bitmask_vs_oracle_exhaustive_5card():
    hands = np.array(list(itertools.combinations(range(52), 5)), dtype=np.int32)
    got = np.asarray(eval7_from_cards(jnp.asarray(hands)))
    want = np.array([ref_eval5([(h // 13, 2 + h % 13) for h in hand])
                     for hand in hands], dtype=np.uint32)
    np.testing.assert_array_equal(got, want)


def test_cmp_eval_order_isomorphic_random():
    """eval_masks_cmp's keys order/tie 7-card hands exactly like the
    reference-packed keys (it is the comparator used inside the Pallas
    equity kernels, where keys are only ever compared)."""
    from montecarlo_tpu.ops.evaluator import eval_masks_cmp

    rng = random.Random(0xBEEF)
    hands = [rng.sample(range(52), 7) for _ in range(50_000)]
    masks = suit_masks_from_cards(jnp.array(hands, dtype=jnp.int32))
    ref = np.asarray(eval_masks(*masks), dtype=np.uint32)
    fast = np.asarray(eval_masks_cmp(*masks), dtype=np.int32)

    # Strict order isomorphism over every observed key: each reference key
    # maps to exactly one fast key, and sorting by one sorts the other.
    order = np.argsort(ref, kind="stable")
    r, f = ref[order], fast[order]
    same_ref = r[1:] == r[:-1]
    same_fast = f[1:] == f[:-1]
    np.testing.assert_array_equal(same_ref, same_fast)
    assert np.all(f[1:][~same_ref] > f[:-1][~same_ref])


def test_cmp_eval_order_isomorphic_structured():
    """Corner categories (quads+trips, double trips, three pairs, 6-card
    flushes, straight-flush-with-pair) order identically under both keys."""
    from montecarlo_tpu.ops.evaluator import eval_masks_cmp

    hands = []
    # all quads + kicker-trips combos and double-trips at adjacent ranks
    for r1 in range(2, 15):
        for r2 in (2, 9, 14):
            if r1 == r2:
                continue
            hands.append([make_card(s, r1) for s in range(4)]
                         + [make_card(s, r2) for s in range(3)])
            hands.append([make_card(s, r1) for s in range(3)]
                         + [make_card(s, r2) for s in range(3)]
                         + [make_card(3, 2 if 2 not in (r1, r2) else 3)])
    # three pairs with every kicker relation
    for k in (2, 8, 11, 13, 14):
        pr = [r for r in (3, 6, 10, 12) if r != k][:3]
        hands.append([make_card(0, pr[0]), make_card(1, pr[0]),
                      make_card(0, pr[1]), make_card(1, pr[1]),
                      make_card(0, pr[2]), make_card(1, pr[2]),
                      make_card(2, k)])
    # 5/6/7-card flushes sharing top cards
    hands.append([make_card(0, r) for r in (2, 5, 7, 9, 11)]
                 + [make_card(1, 13), make_card(2, 14)])
    hands.append([make_card(0, r) for r in (2, 5, 7, 9, 11, 13)]
                 + [make_card(2, 14)])
    hands.append([make_card(0, r) for r in (2, 4, 5, 7, 9, 11, 13)])

    masks = suit_masks_from_cards(jnp.array(hands, dtype=jnp.int32))
    ref = np.asarray(eval_masks(*masks), dtype=np.uint32)
    fast = np.asarray(eval_masks_cmp(*masks), dtype=np.int32)
    order = np.argsort(ref, kind="stable")
    r, f = ref[order], fast[order]
    same_ref = r[1:] == r[:-1]
    same_fast = f[1:] == f[:-1]
    np.testing.assert_array_equal(same_ref, same_fast)
    assert np.all(f[1:][~same_ref] > f[:-1][~same_ref])
