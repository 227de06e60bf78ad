"""Fused equity rollouts as Pallas kernels on the Triton route (GPU).

One program owns ``BLOCK`` rollout lanes and loops over its share of
rollouts inside the program; every iteration of every lane runs, start to
finish in registers:

    counter-based draws -> distinct card sample (ordered draws + bubble
    insertion) -> rank-shift past the dead cards -> suit masks -> bitmask
    hand evaluation (``eval_masks_cmp_impl``) -> win/tie compare -> per-lane
    counters.

No card array ever reaches device memory: each lane writes its counters
once, and XLA sums them per program (``[n_programs]`` partials, int32-safe
by construction of ``_plan``); the host adds the partials in int64, so a
call may cover more than 2^31 rollouts.

Random bits come from ``ops/counter_rng.py`` keyed by (seed, global lane,
iteration * DRAWS + draw), so no stream state is carried anywhere; a
sharded caller passes each device's first global lane (``lane0``) and
every lane of the mesh draws its own stream. ``rollout.equity`` and
``parallel.mesh`` route heads-up equity and the 169-hand sweep here on a
GPU (measured faster than the XLA path there, ``PERF.md``); the tests run
these kernels in interpret mode against the XLA rollouts.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from montecarlo_tpu.ops.counter_rng import stream_keys, uniform_int
from montecarlo_tpu.ops.evaluator import eval_masks_cmp_impl, suit_masks_from_cards

I32 = jnp.int32

BLOCK = 256        # rollout lanes per program (a power of two for Triton)
NUM_WARPS = 4
DRAWS = 8          # counter words reserved per lane-iteration (<= 7 used)
NO_CARD = 64       # dead-list padding: no live slot ever reaches it
DEAD_SLOTS = 8     # padded dead-card list (<= 4 hole + 4 board; sweep: 2)
TARGET_PROGRAMS = 4096  # enough programs in flight to fill every SM


def _plan(n_rollouts: int, scale: int, n_programs_max: int = TARGET_PROGRAMS):
    """(n_programs, n_iter) covering ``n_rollouts`` lanes-iterations, with
    every per-program partial (<= scale * BLOCK * n_iter) inside int32."""
    max_iter = (2**31 - 1) // (scale * BLOCK)
    lanes_needed = -(-n_rollouts // BLOCK)
    n_programs = max(1, min(n_programs_max, lanes_needed))
    n_iter = -(-lanes_needed // n_programs)
    if n_iter > max_iter:
        n_iter = max_iter
        n_programs = -(-lanes_needed // n_iter)
    return n_programs, n_iter


def _sample_cards(key, ctr0, dead, n_live: int, k: int):
    """k distinct live cards per lane: ordered draws + bubble insertion,
    slot -> card by rank-shifts past the ascending ``dead`` scalars."""
    sorted_chosen, cards = [], []
    for t in range(k):
        x = uniform_int(key, ctr0 + t, n_live - t)
        for c in sorted_chosen:
            x = x + (x >= c).astype(I32)
        new_sorted, carry = [], x
        for c in sorted_chosen:
            new_sorted.append(jnp.minimum(carry, c))
            carry = jnp.maximum(carry, c)
        new_sorted.append(carry)
        sorted_chosen = new_sorted
        card = x
        for d in dead:
            card = card + (card >= d).astype(I32)
        cards.append(card)
    return cards


def _masks_of(cards):
    """Four suit masks from per-lane card ids: two suits per int32 plane
    (suits 0/1 in plane A, 2/3 in plane B), unpacked once at the end;
    ``card // 13`` is the exact ``(card * 5) >> 6`` for ids < 64."""
    pa = jnp.zeros_like(cards[0])
    pb = jnp.zeros_like(cards[0])
    for card in cards:
        suit = jnp.right_shift(card * 5, 6)
        p = (card - 13 * suit + 2) | jnp.left_shift(suit & 1, 4)
        bitv = jnp.left_shift(jnp.ones_like(card), p)
        hi = suit > 1
        pa = pa | jnp.where(hi, 0, bitv)
        pb = pb | jnp.where(hi, bitv, 0)
    mask15 = (1 << 15) - 1
    return [pa & mask15, jnp.right_shift(pa, 16) & mask15,
            pb & mask15, jnp.right_shift(pb, 16) & mask15]


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _compiler_params():
    return pl_triton.CompilerParams(num_warps=NUM_WARPS, num_stages=1)


# ---------------------------------------------------------------------------
# N fixed hands against each other on sampled boards
# ---------------------------------------------------------------------------

def _lane0_slot(n_hands: int) -> int:
    """Index of the first-lane offset in the showdown params."""
    return 1 + DEAD_SLOTS + 4 * n_hands


def _showdown_kernel(n_hands: int, n_dead: int, n_iter: int, scale: int):
    """params: [seed, dead x DEAD_SLOTS, masks x 4 per hand, lane0, pad].
    Outputs: per lane, each hand's scaled share (ties split exactly by
    lcm(1..N)) and the count of hand 0's joint wins."""
    n_draw = 5 - (n_dead - 2 * n_hands)
    n_live = 52 - n_dead

    def kernel(params_ref, *out_refs):
        pid = pl.program_id(0)
        lane = (params_ref[_lane0_slot(n_hands)] + pid * BLOCK
                + jax.lax.broadcasted_iota(I32, (BLOCK,), 0))
        key = stream_keys(params_ref[0], lane)
        dead = [params_ref[1 + j] for j in range(n_dead)]
        hm = [[params_ref[1 + DEAD_SLOTS + 4 * h + s] for s in range(4)]
              for h in range(n_hands)]

        def body(i, acc):
            bm = _masks_of(_sample_cards(key, i * DRAWS, dead, n_live,
                                         n_draw))
            values = [eval_masks_cmp_impl(*[b | m for b, m in zip(bm, hm[h])])
                      for h in range(n_hands)]
            vmax = values[0]
            for v in values[1:]:
                vmax = jnp.maximum(vmax, v)
            win = [v == vmax for v in values]
            cnt = win[0].astype(I32)
            for w in win[1:]:
                cnt = cnt + w.astype(I32)
            share = I32(scale) // cnt
            out = [a + jnp.where(w, share, 0) for a, w in zip(acc, win)]
            out.append(acc[-1] + (win[0] & (cnt > 1)).astype(I32))
            return tuple(out)

        zero = jnp.zeros((BLOCK,), I32)
        acc = jax.lax.fori_loop(0, n_iter, body, (zero,) * (n_hands + 1))
        for ref, a in zip(out_refs, acc):
            ref[...] = a

    return kernel


@partial(jax.jit, static_argnames=("n_hands", "n_dead", "n_programs",
                                   "n_iter", "scale", "interpret"))
def showdown_counts(params, n_hands: int, n_dead: int, n_programs: int,
                    n_iter: int, scale: int, interpret: bool = False):
    """Per-program partials [n_hands + 1, n_programs] int32 (see
    ``_showdown_kernel``) over ``n_programs * BLOCK * n_iter`` rollouts."""
    lanes = jax.ShapeDtypeStruct((n_programs * BLOCK,), I32)
    outs = pl.pallas_call(
        _showdown_kernel(n_hands, n_dead, n_iter, scale),
        grid=(n_programs,),
        in_specs=[pl.BlockSpec(params.shape, lambda i: (0,))],
        out_specs=[pl.BlockSpec((BLOCK,), lambda i: (i,))] * (n_hands + 1),
        out_shape=[lanes] * (n_hands + 1),
        backend="triton",
        compiler_params=_compiler_params(),
        interpret=interpret,
        name="equity_showdown",
    )(params)
    return jnp.stack([o.reshape(n_programs, BLOCK).sum(axis=1)
                      for o in outs])


def showdown_params(seed: int, hands, board=()):
    """Host-side packing of the showdown kernel's scalar inputs (lane0 =
    0; a sharded caller sets its own). Returns (params, N, n_dead)."""
    hands = np.asarray(hands, np.int32).reshape(-1, 2)
    board = np.asarray(board, np.int32).reshape(-1)
    dead = np.sort(np.concatenate([hands.reshape(-1), board]))
    assert dead.shape[0] <= DEAD_SLOTS
    bmask = (np.stack([np.asarray(m) for m in
                       suit_masks_from_cards(jnp.asarray(board))])
             if board.size else np.zeros(4, np.int32))
    hm = np.stack([np.stack([np.asarray(m) for m in
                             suit_masks_from_cards(jnp.asarray(h))]) | bmask
                   for h in hands])  # [N, 4]
    vals = np.concatenate([[seed & 0x7FFFFFFF],
                           np.pad(dead, (0, DEAD_SLOTS - dead.shape[0]),
                                  constant_values=NO_CARD),
                           hm.reshape(-1), [0]]).astype(np.int32)
    return (jnp.asarray(np.pad(vals, (0, _pow2(vals.size) - vals.size))),
            hands.shape[0], dead.shape[0])


def equity_vs_hand_pallas(seed: int, hero, villain, n_rollouts: int,
                          board=(), interpret: bool = False):
    """Hand-vs-hand (wins, ties, n) of ``hero``, optionally on a known
    partial ``board`` (flop or flop+turn); n >= ``n_rollouts``."""
    params, _, n_dead = showdown_params(seed, [hero, villain], board)
    n_programs, n_iter = _plan(n_rollouts, 2)
    parts = showdown_counts(params, 2, n_dead, n_programs, n_iter, 2,
                            interpret=interpret)
    share, _, ties = (int(x) for x in np.asarray(parts, np.int64).sum(axis=1))
    # hero share = 2 * wins + ties (scale 2)
    return (share - ties) // 2, ties, n_programs * BLOCK * n_iter


# ---------------------------------------------------------------------------
# 169-hand sweep: each hero against a random villain on a random board
# ---------------------------------------------------------------------------

HERO_SLOTS = 8  # per hero: two ascending hole cards, four masks, pad


def _sweep_kernel(n_programs: int, n_iter: int):
    def kernel(params_ref, wins_ref, ties_ref):
        h = pl.program_id(0)
        pid = pl.program_id(1)
        lane = (params_ref[1] + (h * n_programs + pid) * BLOCK
                + jax.lax.broadcasted_iota(I32, (BLOCK,), 0))
        key = stream_keys(params_ref[0], lane)
        base = HERO_SLOTS * (h + 1)
        dead = [params_ref[base], params_ref[base + 1]]
        hm = [params_ref[base + 2 + s] for s in range(4)]

        def body(i, acc):
            w, t = acc
            cards = _sample_cards(key, i * DRAWS, dead, 50, 7)
            vm = _masks_of(cards[:2])
            bm = _masks_of(cards[2:])
            vh = eval_masks_cmp_impl(*[b | m for b, m in zip(bm, hm)])
            vv = eval_masks_cmp_impl(*[b | v for b, v in zip(bm, vm)])
            return (w + (vh > vv).astype(I32), t + (vh == vv).astype(I32))

        zero = jnp.zeros((BLOCK,), I32)
        w, t = jax.lax.fori_loop(0, n_iter, body, (zero, zero))
        wins_ref[...] = w
        ties_ref[...] = t

    return kernel


@partial(jax.jit, static_argnames=("n_heroes", "n_programs", "n_iter",
                                   "interpret"))
def sweep_counts(params, n_heroes: int, n_programs: int, n_iter: int,
                 interpret: bool = False):
    """Per-program partials (wins, ties), each [H, n_programs] int32,
    over ``n_programs * BLOCK * n_iter`` rollouts per hero."""
    lanes = jax.ShapeDtypeStruct((n_heroes * n_programs * BLOCK,), I32)
    spec = pl.BlockSpec((BLOCK,), lambda h, i: (h * n_programs + i,))
    w, t = pl.pallas_call(
        _sweep_kernel(n_programs, n_iter),
        grid=(n_heroes, n_programs),
        in_specs=[pl.BlockSpec(params.shape, lambda h, i: (0,))],
        out_specs=[spec, spec],
        out_shape=[lanes, lanes],
        backend="triton",
        compiler_params=_compiler_params(),
        interpret=interpret,
        name="equity_sweep",
    )(params)
    return (w.reshape(n_heroes, n_programs, BLOCK).sum(axis=2),
            t.reshape(n_heroes, n_programs, BLOCK).sum(axis=2))


def sweep_params(seed: int, heroes):
    """Host-side packing of the sweep kernel's inputs: row 0 holds the
    seed and the first-lane offset (0; a sharded caller sets its own),
    row h+1 hero h's ascending hole cards and suit masks."""
    heroes = np.sort(np.asarray(heroes, np.int32).reshape(-1, 2), axis=1)
    H = heroes.shape[0]
    hm = np.stack([np.asarray(m) for m in
                   suit_masks_from_cards(jnp.asarray(heroes))], axis=1)
    rows = np.zeros((H + 1, HERO_SLOTS), np.int32)
    rows[0, 0] = seed & 0x7FFFFFFF
    rows[1:, :2] = heroes
    rows[1:, 2:6] = hm
    flat = rows.reshape(-1)
    return jnp.asarray(np.pad(flat, (0, _pow2(flat.size) - flat.size)))


def sweep_plan(n_rollouts_per_hand: int, n_programs_max: int = 64):
    """(n_programs, n_iter) of one hero's rollouts."""
    return _plan(n_rollouts_per_hand, 1, n_programs_max)


def equity_sweep_pallas(seed: int, heroes, n_rollouts_per_hand: int,
                        interpret: bool = False):
    """Equity-vs-random for [H, 2] hero hands in one launch.

    Returns (equity[H] as float64 numpy, rollouts per hand)."""
    H = np.asarray(heroes).reshape(-1, 2).shape[0]
    n_programs, n_iter = sweep_plan(n_rollouts_per_hand)
    w, t = sweep_counts(sweep_params(seed, heroes), H, n_programs, n_iter,
                        interpret=interpret)
    n = n_programs * BLOCK * n_iter
    w = np.asarray(w, np.int64).sum(axis=1)
    t = np.asarray(t, np.int64).sum(axis=1)
    return (w + 0.5 * t) / n, n
