"""Monte Carlo equity estimation (the batched rollout API).

This is the capability the reference was built to enable but never shipped
("a reasonably performant poker server that can be used to test AIs",
``README.md:9``): given hole cards, estimate win/tie equity by dealing
random boards and ranking both 7-card hands with the bitmask evaluator.

Design notes:

- Sampling 5 (or 7) distinct cards from the live deck uses ordered
  uniform draws with rank-shift correction — O(k^2) scalar ops per rollout,
  no per-rollout sort or gather over the deck, so the whole rollout is a
  fused elementwise XLA program over the batch axis.
- Rollout batches never touch HBM as card arrays: cards become four int32
  suit masks immediately and reduce to two counters (wins, ties).
- Chunks scan inside one jit; counters are int32 (callers chunk above
  ~2^31 rollouts per call — the host wrapper handles it).
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from montecarlo_tpu.cards import NUM_CARDS, make_card
from montecarlo_tpu.ops.evaluator import eval_masks, suit_masks_from_cards

I32 = jnp.int32


class EquityResult(NamedTuple):
    wins: int
    ties: int
    losses: int
    n: int

    @property
    def p_win(self) -> float:
        return self.wins / self.n

    @property
    def equity(self) -> float:
        """Win probability counting ties as half (standard equity)."""
        return (self.wins + 0.5 * self.ties) / self.n

    @property
    def stderr(self) -> float:
        p = self.equity
        return float(np.sqrt(max(p * (1.0 - p), 1e-12) / self.n))

    @property
    def ci95(self) -> Tuple[float, float]:
        p, se = self.equity, self.stderr
        return (p - 1.96 * se, p + 1.96 * se)



def _check_disjoint(*card_groups):
    """Hole cards/boards passed to equity APIs must not share cards —
    overlaps would silently corrupt the dead-card shift mapping."""
    flat = [int(c) for g in card_groups for c in np.asarray(g).reshape(-1)]
    if len(flat) != len(set(flat)):
        raise ValueError(f"cards are not disjoint: {sorted(flat)}")
    if any(c < 0 or c > 51 for c in flat):
        raise ValueError(f"card ids out of range: {sorted(flat)}")


def complement(dead) -> jax.Array:
    """Ascending card ids not in ``dead`` (shape [52 - len(dead)])."""
    dead = jnp.asarray(dead, I32)
    is_dead = jnp.zeros((NUM_CARDS,), jnp.bool_).at[dead].set(True)
    order = jnp.argsort(is_dead, stable=True)
    return order[: NUM_CARDS - dead.shape[0]].astype(I32)


def sample_distinct(key, n_avail: int, k: int, batch: int) -> jax.Array:
    """[batch, k] distinct uniform indices in [0, n_avail).

    Ordered-draw construction: the i-th draw is uniform over the remaining
    ``n_avail - i`` values and rank-shifted past previously-chosen values in
    ascending order — a bijection onto the complement, so the result is an
    exact uniform k-subset (with the per-rollout draw order preserved).
    Purely elementwise over the batch: no sorting of the deck, no rejection.
    """
    keys = jax.random.split(key, k)
    chosen = []          # draw order
    sorted_chosen = []   # ascending
    for i in range(k):
        x = jax.random.randint(keys[i], (batch,), 0, n_avail - i, dtype=I32)
        for c in sorted_chosen:
            x = x + (x >= c)
        # insert x into the ascending list (unrolled bubble insertion:
        # keep the smaller of (carry, c), carry the larger forward)
        new_sorted = []
        carry = x
        for c in sorted_chosen:
            new_sorted.append(jnp.minimum(carry, c))
            carry = jnp.maximum(carry, c)
        new_sorted.append(carry)
        sorted_chosen = new_sorted
        chosen.append(x)
    return jnp.stack(chosen, axis=1)


def slots_to_cards(slots, dead_sorted):
    """Map live-deck slot indices to card ids by rank-shifting past the
    (ascending) dead cards — the order-preserving bijection onto the
    complement, with no gather on the hot path."""
    cards = slots
    for j in range(dead_sorted.shape[0]):
        cards = cards + (cards >= dead_sorted[j])
    return cards


def _versus_counts(key, hero_masks, villain_masks, dead_sorted, batch: int):
    """(wins, ties) over one batch of boards for fixed hero/villain holes."""
    slots = sample_distinct(key, 52 - dead_sorted.shape[0], 5, batch)
    board = slots_to_cards(slots, dead_sorted)  # [batch, 5]
    bm = suit_masks_from_cards(board)
    vh = eval_masks(*[m | h for m, h in zip(bm, hero_masks)])
    vv = eval_masks(*[m | v for m, v in zip(bm, villain_masks)])
    return (jnp.sum((vh > vv).astype(I32)), jnp.sum((vh == vv).astype(I32)))


@partial(jax.jit, static_argnames=("batch", "n_chunks"))
def _equity_vs_hand_device(key, hero, villain, board, batch: int,
                           n_chunks: int):
    """``board``: [K] known community cards (K in {0, 3, 4} static); the
    remaining 5-K are sampled from the live deck each rollout."""
    K = board.shape[0]
    dead = jnp.sort(jnp.concatenate([hero, villain, board]))
    board_masks = suit_masks_from_cards(board) if K else [I32(0)] * 4
    hero_masks = [m | b for m, b in
                  zip(suit_masks_from_cards(hero), board_masks)]
    villain_masks = [m | b for m, b in
                     zip(suit_masks_from_cards(villain), board_masks)]

    def chunk(carry, i):
        w, t = carry
        k = jax.random.fold_in(key, i)
        slots = sample_distinct(k, 52 - dead.shape[0], 5 - K, batch)
        drawn = slots_to_cards(slots, dead)
        bm = suit_masks_from_cards(drawn)
        vh = eval_masks(*[m | h for m, h in zip(bm, hero_masks)])
        vv = eval_masks(*[m | v for m, v in zip(bm, villain_masks)])
        return (w + jnp.sum((vh > vv).astype(I32)),
                t + jnp.sum((vh == vv).astype(I32))), None

    (w, t), _ = jax.lax.scan(
        chunk, (jnp.zeros((), I32), jnp.zeros((), I32)), jnp.arange(n_chunks))
    return w, t


def _chunking(n_rollouts: int, batch_size: int) -> Tuple[int, int]:
    batch = min(batch_size, n_rollouts)
    n_chunks = -(-n_rollouts // batch)
    return batch, n_chunks


def kernel_impl(impl: str = "auto") -> str:
    """Resolve an equity ``impl``: "auto" is the Triton kernels of
    ``ops/pallas_equity.py`` on a GPU (the faster path there, PERF.md)
    and the XLA path anywhere else."""
    if impl == "auto":
        return "triton" if jax.default_backend() == "gpu" else "xla"
    assert impl in ("triton", "xla"), impl
    return impl


def key_to_seed(key) -> int:
    """A 31-bit kernel seed drawn from a JAX PRNG key."""
    return int(jax.random.bits(key, dtype=jnp.uint32)) & 0x7FFFFFFF


def equity_vs_hand(
    key,
    hero: Sequence[int],
    villain: Sequence[int],
    n_rollouts: int,
    board: Sequence[int] = (),
    batch_size: int = 1 << 20,
    impl: str = "auto",
) -> EquityResult:
    """Hero hole cards vs exact villain hole cards (BASELINE config 3),
    optionally on a known partial ``board`` (flop or flop+turn).

    ``n_rollouts`` is rounded up to whole batches (XLA path) or whole
    program blocks (kernel path); ``impl`` as in ``kernel_impl``.
    """
    _check_disjoint(hero, villain, board)
    if kernel_impl(impl) == "triton":
        from montecarlo_tpu.ops.pallas_equity import equity_vs_hand_pallas

        w, t, n = equity_vs_hand_pallas(key_to_seed(key), hero, villain,
                                        n_rollouts, board)
        return EquityResult(wins=w, ties=t, losses=n - w - t, n=n)
    hero = jnp.asarray(hero, I32)
    villain = jnp.asarray(villain, I32)
    board = jnp.asarray(board, I32).reshape(-1)
    batch, n_chunks = _chunking(n_rollouts, batch_size)
    w, t = _equity_vs_hand_device(key, hero, villain, board, batch, n_chunks)
    n = batch * n_chunks
    w, t = int(w), int(t)
    return EquityResult(wins=w, ties=t, losses=n - w - t, n=n)


@partial(jax.jit, static_argnames=("batch", "n_chunks"))
def _equity_vs_random_device(key, hero, batch: int, n_chunks: int):
    dead = jnp.sort(hero)
    hero_masks = suit_masks_from_cards(hero)

    def chunk(carry, i):
        w, t = carry
        slots = sample_distinct(jax.random.fold_in(key, i), 50, 7, batch)
        cards = slots_to_cards(slots, dead)          # [batch, 7]
        villain, board = cards[:, :2], cards[:, 2:]
        bm = suit_masks_from_cards(board)
        vh = eval_masks(*[m | h for m, h in zip(bm, hero_masks)])
        vm = suit_masks_from_cards(villain)
        vv = eval_masks(*[m | v for m, v in zip(bm, vm)])
        return (w + jnp.sum((vh > vv).astype(I32)),
                t + jnp.sum((vh == vv).astype(I32))), None

    (w, t), _ = jax.lax.scan(
        chunk, (jnp.zeros((), I32), jnp.zeros((), I32)), jnp.arange(n_chunks))
    return w, t


def equity_vs_random(
    key,
    hero: Sequence[int],
    n_rollouts: int,
    batch_size: int = 1 << 20,
) -> EquityResult:
    """Hero hole cards vs a uniformly random villain (169-sweep building
    block, BASELINE config 5)."""
    _check_disjoint(hero)
    hero = jnp.asarray(hero, I32)
    batch, n_chunks = _chunking(n_rollouts, batch_size)
    w, t = _equity_vs_random_device(key, hero, batch, n_chunks)
    n = batch * n_chunks
    w, t = int(w), int(t)
    return EquityResult(wins=w, ties=t, losses=n - w - t, n=n)


@partial(jax.jit, static_argnames=("batch", "n_chunks"))
def _equity_multiway_device(key, hands, board, batch: int, n_chunks: int):
    """``hands``: [N, 2] hole cards; returns per-hand equity sums [N] f32
    (ties split fractionally) over batch * n_chunks sampled boards."""
    N = hands.shape[0]
    K = board.shape[0]
    dead = jnp.sort(jnp.concatenate([hands.reshape(-1), board]))
    board_masks = (suit_masks_from_cards(board) if K
                   else [jnp.zeros((), I32)] * 4)
    hm = suit_masks_from_cards(hands)  # each [N]

    def chunk(carry, i):
        eq = carry
        k = jax.random.fold_in(key, i)
        slots = sample_distinct(k, 52 - dead.shape[0], 5 - K, batch)
        drawn = slots_to_cards(slots, dead)
        bm = suit_masks_from_cards(drawn)  # each [batch]
        values = eval_masks(
            *[b[:, None] | h[None, :] | fb
              for b, h, fb in zip(bm, hm, board_masks)])  # [batch, N]
        vmax = jnp.max(values, axis=1, keepdims=True)
        winners = values == vmax
        cnt = jnp.sum(winners, axis=1, keepdims=True)
        share = winners.astype(jnp.float32) / cnt.astype(jnp.float32)
        return eq + jnp.sum(share, axis=0), None

    eq, _ = jax.lax.scan(chunk, jnp.zeros((N,), jnp.float32),
                         jnp.arange(n_chunks))
    return eq


def equity_multiway(
    key,
    hands,
    n_rollouts: int,
    board: Sequence[int] = (),
    batch_size: int = 1 << 19,
) -> Tuple[np.ndarray, int]:
    """Equity of N specified hands against each other (ties split
    fractionally), optionally on a partial board. Returns (equity[N], n).
    """
    _check_disjoint(hands, board)
    hands = jnp.asarray(hands, I32).reshape(-1, 2)
    board = jnp.asarray(board, I32).reshape(-1)
    batch, n_chunks = _chunking(n_rollouts, batch_size)
    eq = _equity_multiway_device(key, hands, board, batch, n_chunks)
    n = batch * n_chunks
    return np.asarray(eq, np.float64) / n, n


def expand_range(labels: Sequence[str]) -> np.ndarray:
    """Expand canonical hand labels ('AA', 'AKs', 'T9o', ...) to all combos.

    Returns an [R, 2] int32 array of hole-card pairs: 6 combos per pair,
    4 per suited label, 12 per offsuit label.
    """
    names = "23456789TJQKA"
    combos = []
    for label in labels:
        r1, r2 = names.index(label[0]) + 2, names.index(label[1]) + 2
        kind = label[2:] or ("pair" if r1 == r2 else None)
        if r1 == r2:
            for s1 in range(4):
                for s2 in range(s1 + 1, 4):
                    combos.append((make_card(s1, r1), make_card(s2, r1)))
        elif kind == "s":
            for s in range(4):
                combos.append((make_card(s, r1), make_card(s, r2)))
        elif kind == "o":
            for s1 in range(4):
                for s2 in range(4):
                    if s1 != s2:
                        combos.append((make_card(s1, r1), make_card(s2, r2)))
        else:
            raise ValueError(f"bad hand label {label!r}")
    return np.array(combos, dtype=np.int32)


def _sort4(a, b, c, d):
    """Ascending sort of four int arrays (5-comparator network)."""
    lo1, hi1 = jnp.minimum(a, b), jnp.maximum(a, b)
    lo2, hi2 = jnp.minimum(c, d), jnp.maximum(c, d)
    x0 = jnp.minimum(lo1, lo2)
    t1 = jnp.maximum(lo1, lo2)
    t2 = jnp.minimum(hi1, hi2)
    x3 = jnp.maximum(hi1, hi2)
    return x0, jnp.minimum(t1, t2), jnp.maximum(t1, t2), x3


@partial(jax.jit, static_argnames=("batch", "n_chunks"))
def _equity_vs_range_device(key, hero, combos, cdf, batch: int, n_chunks: int):
    hero_masks = suit_masks_from_cards(hero)

    def chunk(carry, i):
        w, t = carry
        kv, kb = jax.random.split(jax.random.fold_in(key, i))
        # Weighted villain combo per rollout: inverse-CDF via comparison
        # count, then a one-hot selection (gather-free: a [batch, R] x
        # [R, 2] product of one-hots and card ids < 64, exact at any
        # matmul precision, TF32 included).
        u = jax.random.uniform(kv, (batch, 1))
        idx = jnp.sum((u > cdf[None, :]).astype(I32), axis=1)  # [batch]
        idx = jnp.minimum(idx, combos.shape[0] - 1)
        onehot = (idx[:, None] == jnp.arange(combos.shape[0])[None, :])
        villain = (onehot.astype(jnp.float32)
                   @ combos.astype(jnp.float32)).astype(I32)  # [batch, 2]
        d0, d1, d2, d3 = _sort4(hero[0], hero[1],
                                villain[:, 0], villain[:, 1])
        slots = sample_distinct(kb, 48, 5, batch)
        cards = slots
        for d in (d0, d1, d2, d3):                       # per-rollout dead
            cards = cards + (cards >= d[:, None])
        bm = suit_masks_from_cards(cards)
        vh = eval_masks(*[m | h for m, h in zip(bm, hero_masks)])
        vv = eval_masks(*[m | x for m, x in zip(bm, suit_masks_from_cards(villain))])
        return (w + jnp.sum((vh > vv).astype(I32)),
                t + jnp.sum((vh == vv).astype(I32))), None

    (w, t), _ = jax.lax.scan(
        chunk, (jnp.zeros((), I32), jnp.zeros((), I32)),
        jnp.arange(n_chunks))
    return w, t


def equity_vs_range(
    key,
    hero: Sequence[int],
    villain_range,
    n_rollouts: int,
    weights=None,
    batch_size: int = 1 << 20,
) -> EquityResult:
    """Hero vs a (weighted) villain range.

    ``villain_range``: [R, 2] combos (see ``expand_range``) — combos
    colliding with the hero's cards are dropped (weights renormalize).
    """
    hero_np = np.asarray(hero, np.int32)
    combos = np.asarray(villain_range, np.int32).reshape(-1, 2)
    w = np.ones(combos.shape[0]) if weights is None else np.asarray(weights, float)
    keep = ~np.isin(combos, hero_np).any(axis=1)
    combos, w = combos[keep], w[keep]
    if combos.size == 0:
        raise ValueError("villain range is empty after removing hero cards")
    cdf = np.cumsum(w) / np.sum(w)

    batch, n_chunks = _chunking(n_rollouts, batch_size)
    wins, ties = _equity_vs_range_device(
        key, jnp.asarray(hero_np), jnp.asarray(combos),
        jnp.asarray(cdf, jnp.float32), batch, n_chunks)
    n = batch * n_chunks
    wins, ties = int(wins), int(ties)
    return EquityResult(wins=wins, ties=ties, losses=n - wins - ties, n=n)


def equity_exact(hero: Sequence[int], villain: Sequence[int],
                 board: Sequence[int] = (),
                 chunk: int = 1 << 18) -> EquityResult:
    """EXACT hand-vs-hand equity by enumerating every remaining board
    completion — C(48,5) = 1,712,304 preflop, C(45,2) = 990 on a flop,
    44 on a turn. No Monte Carlo error; ci95 width is zero.

    The reference's naive evaluator would need ~10^9 sequence ops for the
    preflop case; the bitmask evaluator sweeps it in a few device chunks.
    """
    import itertools

    _check_disjoint(hero, villain, board)
    hero = jnp.asarray(hero, I32)
    villain = jnp.asarray(villain, I32)
    fixed = np.asarray(board, np.int32).reshape(-1)
    K = fixed.shape[0]
    live = np.asarray(complement(jnp.concatenate(
        [hero, villain, jnp.asarray(fixed, I32)])))
    n_live = live.shape[0]
    boards = np.fromiter(
        itertools.chain.from_iterable(
            itertools.combinations(range(n_live), 5 - K)),
        dtype=np.int32).reshape(-1, 5 - K)
    boards = live[boards]  # slot -> card id
    if K:
        boards = np.concatenate(
            [np.tile(fixed, (boards.shape[0], 1)), boards], axis=1)
    hm = suit_masks_from_cards(hero)
    vm = suit_masks_from_cards(villain)

    @jax.jit
    def counts(board_chunk, valid):
        bm = suit_masks_from_cards(board_chunk)
        vh = eval_masks(*[m | h for m, h in zip(bm, hm)])
        vv = eval_masks(*[m | v for m, v in zip(bm, vm)])
        return (jnp.sum(((vh > vv) & valid).astype(I32)),
                jnp.sum(((vh == vv) & valid).astype(I32)))

    wins = ties = 0
    n = boards.shape[0]
    # Pad to whole chunks (masked out) so one executable serves every slice.
    pad = (-n) % chunk
    if pad:
        boards = np.concatenate([boards, np.tile(boards[:1], (pad, 1))])
    valid_all = np.arange(boards.shape[0]) < n
    for i in range(0, boards.shape[0], chunk):
        w, t = counts(jnp.asarray(boards[i:i + chunk]),
                      jnp.asarray(valid_all[i:i + chunk]))
        wins += int(w)
        ties += int(t)
    return EquityResult(wins=wins, ties=ties, losses=n - wins - ties, n=n)


def equity_exact_multiway(hands, board: Sequence[int] = (),
                          chunk: int = 1 << 18) -> np.ndarray:
    """EXACT equity of N hands against each other (ties split equally)
    by enumerating every board completion: C(46,5) = 1,370,754 boards for
    three hands preflop. Returns equity float64[N]."""
    import itertools

    hands = np.asarray(hands, np.int32).reshape(-1, 2)
    fixed = np.asarray(board, np.int32).reshape(-1)
    _check_disjoint(hands, fixed)
    K = fixed.shape[0]
    live = np.asarray(complement(jnp.asarray(
        np.concatenate([hands.reshape(-1), fixed]), I32)))
    boards = live[np.fromiter(
        itertools.chain.from_iterable(
            itertools.combinations(range(live.shape[0]), 5 - K)),
        dtype=np.int32).reshape(-1, 5 - K)]
    if K:
        boards = np.concatenate(
            [np.tile(fixed, (boards.shape[0], 1)), boards], axis=1)
    n = boards.shape[0]
    pad = (-n) % chunk
    boards = np.concatenate([boards, np.tile(boards[:1], (pad, 1))])
    valid_all = np.arange(boards.shape[0]) < n
    hm = suit_masks_from_cards(jnp.asarray(hands))  # 4 x [N]
    scale = math.lcm(*range(1, hands.shape[0] + 1))

    @jax.jit
    def shares(board_chunk, valid):
        bm = suit_masks_from_cards(board_chunk)  # 4 x [B]
        values = eval_masks(*[b[:, None] | h[None, :]
                              for b, h in zip(bm, hm)])  # [B, N]
        winners = values == jnp.max(values, axis=1, keepdims=True)
        cnt = jnp.sum(winners, axis=1, keepdims=True)
        # integer shares scaled by lcm(1..N): exact in int32 per chunk
        share = jnp.where(winners & valid[:, None],
                          scale // jnp.maximum(cnt, 1), 0)
        return jnp.sum(share, axis=0)

    total = np.zeros(hands.shape[0], np.int64)
    for i in range(0, boards.shape[0], chunk):
        total += np.asarray(shares(jnp.asarray(boards[i:i + chunk]),
                                   jnp.asarray(valid_all[i:i + chunk])),
                            np.int64)
    return total / (scale * n)


class RangeEquityResult(NamedTuple):
    """Exact weighted range-vs-range equity (no Monte Carlo error).

    ``equity`` is hero's share counting ties as half, averaged over combo
    pairs with card-removal-correct weights (overlapping pairs excluded).
    ``pair_equity[H, V]`` / ``pair_weight[H, V]`` expose the per-combo-pair
    breakdown (weight 0 where combos collide); ``n_boards`` is the exact
    number of board completions enumerated per pair.
    """
    equity: float
    pair_equity: np.ndarray   # [H, V] float64 (NaN where weight == 0)
    pair_weight: np.ndarray   # [H, V] float64
    n_boards: int


@partial(jax.jit, static_argnames=())
def _range_pair_counts(boards3d, valid2d, hmasks, vmasks):
    """Per-combo-pair (wins, ties) over chunked boards: [C, B, 5-ish]
    boards x [H] hero combos x [V] villain combos, the chunk axis scanned
    ON DEVICE (one dispatch for the whole sweep, not one per chunk).

    Everything is broadcast elementwise (no gathers): validity of a
    (combo, board) pairing is an empty suit-mask intersection, so boards
    containing a combo's cards are masked out rather than re-enumerated per
    pair — every pair sees the same exact C(48-K, 5-K) live completions.
    int32 accumulation is safe: any pair's count <= total boards
    <= C(52, 5) = 2,598,960 << 2^31.
    """
    H = hmasks[0].shape[0]
    V = vmasks[0].shape[0]
    hm = [m[None, :] for m in hmasks]                        # 4 x [1, H]
    vm = [m[None, :] for m in vmasks]                        # 4 x [1, V]

    def chunk(carry, xs):
        wins, ties = carry
        board_chunk, valid_chunk = xs
        bm = suit_masks_from_cards(board_chunk)              # 4 x [B]
        b_ = [m[:, None] for m in bm]                        # 4 x [B, 1]

        def _no_overlap(combo_masks):
            inter = jnp.zeros((), I32)
            for b, c in zip(b_, combo_masks):
                inter = inter | (b & c)
            return inter == 0

        ok_h = _no_overlap(hm)                               # [B, H]
        ok_v = _no_overlap(vm)                               # [B, V]
        kh = eval_masks(*[b | h for b, h in zip(b_, hm)])    # [B, H]
        kv = eval_masks(*[b | v for b, v in zip(b_, vm)])    # [B, V]
        val = (ok_h[:, :, None] & ok_v[:, None, :]
               & valid_chunk[:, None, None])                 # [B, H, V]
        gt = kh[:, :, None] > kv[:, None, :]
        eq = kh[:, :, None] == kv[:, None, :]
        wins = wins + jnp.sum((gt & val).astype(I32), axis=0)
        ties = ties + jnp.sum((eq & val).astype(I32), axis=0)
        return (wins, ties), None

    (wins, ties), _ = jax.lax.scan(
        chunk, (jnp.zeros((H, V), I32), jnp.zeros((H, V), I32)),
        (boards3d, valid2d))
    return wins, ties


def _enumerate_boards(fixed: np.ndarray, elem_budget: int, hv: int):
    """All 5-card completions of ``fixed`` from the full remaining deck,
    padded and reshaped for the on-device chunk scan.

    Returns (boards [C, B, 5], valid [C, B]) numpy arrays with
    ``B * hv <= elem_budget`` bounding the broadcast tensor per scan step.
    """
    import itertools

    K = fixed.shape[0]
    live = np.array(sorted(set(range(NUM_CARDS)) - set(fixed.tolist())),
                    dtype=np.int32)
    draws = np.fromiter(
        itertools.chain.from_iterable(
            itertools.combinations(range(live.shape[0]), 5 - K)),
        dtype=np.int32).reshape(-1, 5 - K)
    boards = live[draws]
    if K:
        boards = np.concatenate(
            [np.tile(fixed, (boards.shape[0], 1)), boards], axis=1)
    n = boards.shape[0]
    chunk = max(256, min(n, elem_budget // max(hv, 1)))
    pad = (-n) % chunk
    if pad:
        boards = np.concatenate([boards, np.tile(boards[:1], (pad, 1))])
    valid = np.arange(boards.shape[0]) < n
    C = boards.shape[0] // chunk
    return (boards.reshape(C, chunk, 5), valid.reshape(C, chunk))


def equity_exact_range_vs_range(
    hero_range,
    villain_range,
    hero_weights=None,
    villain_weights=None,
    board: Sequence[int] = (),
    elem_budget: int = 1 << 24,
    progress=None,
) -> RangeEquityResult:
    """EXACT weighted range-vs-range equity by combo-pair enumeration.

    For every (hero combo, villain combo) pair that shares no card (and
    collides with neither the fixed ``board``), every remaining board
    completion is enumerated and both 7-card hands ranked — the
    card-removal-correct generalization of ``equity_exact``, the capability
    the reference's showdown evaluator (``hand_evaluator.clj:162-172``)
    could never reach at scale. Pair weights are ``w_h * w_v`` (weights
    per combo, default 1), zeroed for colliding pairs; the aggregate equity
    renormalizes over surviving pairs.

    Cost: one shared exact board sweep — C(52-K, 5-K) boards x H x V
    comparisons — NOT a per-pair re-enumeration; per-pair validity is a
    suit-mask intersection test.
    """
    hero_range = np.asarray(hero_range, np.int32).reshape(-1, 2)
    villain_range = np.asarray(villain_range, np.int32).reshape(-1, 2)
    fixed = np.asarray(board, np.int32).reshape(-1)
    _check_disjoint(fixed)
    K = fixed.shape[0]
    H, V = hero_range.shape[0], villain_range.shape[0]
    wh = (np.ones(H) if hero_weights is None
          else np.asarray(hero_weights, np.float64))
    wv = (np.ones(V) if villain_weights is None
          else np.asarray(villain_weights, np.float64))
    assert wh.shape == (H,) and wv.shape == (V,)

    # Pair weights: zero where combos collide with each other or the board.
    fx = set(fixed.tolist())
    ok_h = np.array([not (set(h) & fx) for h in hero_range.tolist()])
    ok_v = np.array([not (set(v) & fx) for v in villain_range.tolist()])
    disjoint = np.array(
        [[not (set(h) & set(v)) for v in villain_range.tolist()]
         for h in hero_range.tolist()])
    weight = (wh[:, None] * wv[None, :]) * disjoint \
        * ok_h[:, None] * ok_v[None, :]
    if not np.any(weight > 0):
        raise ValueError("no disjoint combo pairs between the ranges")

    hmasks = [jnp.asarray(m) for m in
              suit_masks_from_cards(jnp.asarray(hero_range, I32))]
    vmasks = [jnp.asarray(m) for m in
              suit_masks_from_cards(jnp.asarray(villain_range, I32))]

    wins = np.zeros((H, V), np.int64)
    ties = np.zeros((H, V), np.int64)
    boards3d, valid2d = _enumerate_boards(fixed, elem_budget, H * V)
    C, B = valid2d.shape
    done = 0
    # A few hundred chunks per dispatch: one device program scans them all;
    # splitting into groups keeps progress observable and transfers small.
    group = max(1, min(C, 256))
    for g in range(0, C, group):
        w, t = _range_pair_counts(jnp.asarray(boards3d[g:g + group]),
                                  jnp.asarray(valid2d[g:g + group]),
                                  hmasks, vmasks)
        wins += np.asarray(w, np.int64)
        ties += np.asarray(t, np.int64)
        done += int(valid2d[g:g + group].sum())
        if progress is not None:
            progress(done)

    n_boards = math.comb(52 - K - 4, 5 - K)  # same for every disjoint pair
    with np.errstate(invalid="ignore"):
        pair_eq = np.where(weight > 0,
                           (wins + 0.5 * ties) / n_boards, np.nan)
    total_w = weight.sum()
    equity = float(np.nansum(pair_eq * weight) / total_w)
    return RangeEquityResult(equity=equity, pair_equity=pair_eq,
                             pair_weight=weight, n_boards=n_boards)


def equity_exact_vs_range(
    hero: Sequence[int],
    villain_range,
    villain_weights=None,
    board: Sequence[int] = (),
) -> RangeEquityResult:
    """EXACT hero-hand-vs-weighted-range equity (card-removal-correct):
    ``equity_exact_range_vs_range`` with a single hero combo."""
    hero = np.asarray(hero, np.int32).reshape(1, 2)
    _check_disjoint(hero, board)
    return equity_exact_range_vs_range(
        hero, villain_range, None, villain_weights, board=board)


def canonical_hands():
    """The 169 canonical starting hands as (label, (card, card)).

    Pairs use hearts+diamonds; suited uses both hearts; offsuit uses
    hearts+diamonds. Order: pairs, then suited, then offsuit, high-first.
    """
    names = "23456789TJQKA"
    out = []
    for i in range(12, -1, -1):  # rank index, A first
        r = i + 2
        out.append((f"{names[i]}{names[i]}",
                    (make_card(0, r), make_card(1, r))))
    for hi in range(12, 0, -1):
        for lo in range(hi - 1, -1, -1):
            r1, r2 = hi + 2, lo + 2
            out.append((f"{names[hi]}{names[lo]}s",
                        (make_card(0, r1), make_card(0, r2))))
    for hi in range(12, 0, -1):
        for lo in range(hi - 1, -1, -1):
            r1, r2 = hi + 2, lo + 2
            out.append((f"{names[hi]}{names[lo]}o",
                        (make_card(0, r1), make_card(1, r2))))
    assert len(out) == 169
    return out
