"""Device-mesh sharded rollouts with collectives.

Design: a 1D mesh over all devices ("tables" axis), every rollout's state
resident on its device, and only the tiny win/tie counters reduced with
``psum`` — the only bytes that cross between devices. The mesh follows the
algorithm alone (the cards of one host reach each other all to all), and
its size is discovered at runtime, so the same code runs on one card, four
cards, or an 8-device CPU test mesh.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from montecarlo_tpu.engine.state import TableConfig
from montecarlo_tpu.ops.evaluator import eval_masks, suit_masks_from_cards
from montecarlo_tpu.rollout.equity import (
    EquityResult,
    sample_distinct,
    slots_to_cards,
)
from montecarlo_tpu.rollout.selfplay import play_hands

I32 = jnp.int32
AXIS = "tables"


def make_mesh(devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """1D mesh over all (or the given) devices."""
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devices), (AXIS,))


def _local_counts(key, hero_masks, villain_masks, dead, batch, n_chunks):
    """Per-device rollout loop (runs inside shard_map)."""

    def chunk(carry, i):
        w, t = carry
        slots = sample_distinct(jax.random.fold_in(key, i),
                                52 - dead.shape[0], 5, batch)
        board = slots_to_cards(slots, dead)
        bm = suit_masks_from_cards(board)
        vh = eval_masks(*[m | h for m, h in zip(bm, hero_masks)])
        vv = eval_masks(*[m | v for m, v in zip(bm, villain_masks)])
        return (w + jnp.sum((vh > vv).astype(I32)),
                t + jnp.sum((vh == vv).astype(I32))), None

    (w, t), _ = jax.lax.scan(
        chunk, (jnp.zeros((), I32), jnp.zeros((), I32)), jnp.arange(n_chunks))
    return w, t


@functools.lru_cache(maxsize=None)
def _vs_hand_program(mesh: Mesh, batch: int, n_chunks: int):
    """Jitted (key, hero, villain) -> psum'd (wins, ties); one per shape,
    so repeated calls reuse the compiled program."""
    def run(key, hero, villain):
        dead = jnp.sort(jnp.concatenate([hero, villain]))
        hm = suit_masks_from_cards(hero)
        vm = suit_masks_from_cards(villain)

        def shard_fn(key):
            dev_key = jax.random.fold_in(key, jax.lax.axis_index(AXIS))
            w, t = _local_counts(dev_key, hm, vm, dead, batch, n_chunks)
            return (jax.lax.psum(w, AXIS), jax.lax.psum(t, AXIS))

        return jax.shard_map(
            shard_fn, mesh=mesh, in_specs=P(), out_specs=P(),
            check_vma=False)(key)

    return jax.jit(run)


def sharded_equity_vs_hand(
    mesh: Mesh,
    key,
    hero,
    villain,
    n_rollouts: int,
    per_device_batch: int = 1 << 19,
    impl: str = "auto",
) -> EquityResult:
    """Hand-vs-hand equity with rollouts sharded over the mesh and the
    win/tie counters psum-reduced over the mesh (BASELINE config 5's
    machinery). ``impl`` as in ``rollout.equity.kernel_impl``: on a GPU
    each device runs the Triton showdown kernel on its own lanes."""
    from montecarlo_tpu.rollout.equity import kernel_impl, key_to_seed

    if kernel_impl(impl) == "triton":
        return _vs_hand_kernel(mesh, key_to_seed(key), hero, villain,
                               n_rollouts)
    n_dev = mesh.devices.size
    hero = jnp.asarray(hero, I32)
    villain = jnp.asarray(villain, I32)
    batch = min(per_device_batch, max(1, n_rollouts // n_dev))
    n_chunks = -(-n_rollouts // (batch * n_dev))

    w, t = _vs_hand_program(mesh, batch, n_chunks)(key, hero, villain)
    n = batch * n_chunks * n_dev
    w, t = int(w), int(t)
    return EquityResult(wins=w, ties=t, losses=n - w - t, n=n)


@functools.lru_cache(maxsize=None)
def _sweep_xla_program(mesh: Mesh, batch: int, n_chunks: int):
    """Jitted (key, heroes) -> psum'd per-hero (wins, ties)."""
    def run(key, heroes):
        def one_hero(hkey, hero):
            dead = jnp.sort(hero)
            hm = suit_masks_from_cards(hero)

            def chunk(carry, i):
                w, t = carry
                slots = sample_distinct(jax.random.fold_in(hkey, i),
                                        50, 7, batch)
                cards = slots_to_cards(slots, dead)
                villain, board = cards[:, :2], cards[:, 2:]
                bm = suit_masks_from_cards(board)
                vh = eval_masks(*[m | h for m, h in zip(bm, hm)])
                vv = eval_masks(*[m | v
                                  for m, v in zip(bm, suit_masks_from_cards(villain))])
                return (w + jnp.sum((vh > vv).astype(I32)),
                        t + jnp.sum((vh == vv).astype(I32))), None

            (w, t), _ = jax.lax.scan(
                chunk, (jnp.zeros((), I32), jnp.zeros((), I32)),
                jnp.arange(n_chunks))
            return w, t

        def shard_fn(key, heroes):
            dev_key = jax.random.fold_in(key, jax.lax.axis_index(AXIS))
            hkeys = jax.random.split(dev_key, heroes.shape[0])
            w, t = jax.vmap(one_hero)(hkeys, heroes)
            return (jax.lax.psum(w, AXIS), jax.lax.psum(t, AXIS))

        return jax.shard_map(
            shard_fn, mesh=mesh, in_specs=(P(), P()), out_specs=P(),
            check_vma=False)(key, heroes)

    return jax.jit(run)


def equity_sweep(
    mesh: Mesh,
    key,
    heroes,
    n_rollouts_per_hand: int,
    per_device_batch: int = 1 << 14,
    impl: str = "auto",
):
    """Equity-vs-random for a batch of hero hands (e.g. the 169 canonical
    starting hands) — every device rolls its share for *all* hands; the
    [H] win/tie counters psum over the mesh. Returns (equity[H],
    n_per_hand). ``impl`` as in ``rollout.equity.kernel_impl``: on a GPU
    each device runs the Triton sweep kernel on its own global lanes."""
    from montecarlo_tpu.rollout.equity import kernel_impl

    if kernel_impl(impl) == "triton":
        return _equity_sweep_kernel(mesh, key, heroes, n_rollouts_per_hand)
    heroes = jnp.asarray(heroes, I32)  # [Hh, 2]
    n_dev = mesh.devices.size
    batch = min(per_device_batch, max(1, n_rollouts_per_hand // n_dev))
    n_chunks = -(-n_rollouts_per_hand // (batch * n_dev))

    w, t = _sweep_xla_program(mesh, batch, n_chunks)(key, heroes)
    n = batch * n_chunks * n_dev
    eq = (np.asarray(w) + 0.5 * np.asarray(t)) / n
    return eq, n


@functools.lru_cache(maxsize=None)
def _sweep_kernel_program(mesh: Mesh, H: int, n_programs: int, n_iter: int,
                          interpret: bool):
    """Jitted params -> psum'd per-program (wins, ties) [H, n_programs]."""
    from montecarlo_tpu.ops.pallas_equity import BLOCK, sweep_counts

    lanes_per_dev = H * n_programs * BLOCK

    def shard_fn(params):
        lane0 = jax.lax.axis_index(AXIS) * lanes_per_dev
        w, t = sweep_counts(params.at[1].set(lane0), H, n_programs, n_iter,
                            interpret=interpret)
        return jax.lax.psum(w, AXIS), jax.lax.psum(t, AXIS)

    return jax.jit(jax.shard_map(shard_fn, mesh=mesh, in_specs=P(),
                                 out_specs=P(), check_vma=False))


def _equity_sweep_kernel(mesh: Mesh, key, heroes, n_rollouts_per_hand: int,
                         interpret: bool = False):
    """The sweep on the Triton kernel, sharded: device d's lanes start at
    d * (lanes per device), so no two devices share a random stream; the
    per-program partials psum over the mesh and sum on the host in int64.
    """
    from montecarlo_tpu.ops.pallas_equity import (
        BLOCK, sweep_params, sweep_plan,
    )
    from montecarlo_tpu.rollout.equity import key_to_seed

    n_dev = mesh.devices.size
    H = np.asarray(heroes).reshape(-1, 2).shape[0]
    n_programs, n_iter = sweep_plan(-(-n_rollouts_per_hand // n_dev))
    w, t = _sweep_kernel_program(mesh, H, n_programs, n_iter, interpret)(
        sweep_params(key_to_seed(key), heroes))
    n = n_programs * BLOCK * n_iter * n_dev
    w = np.asarray(w, np.int64).sum(axis=1)
    t = np.asarray(t, np.int64).sum(axis=1)
    return (w + 0.5 * t) / n, n


@functools.lru_cache(maxsize=None)
def _showdown_program(mesh: Mesh, n_dead: int, n_programs: int, n_iter: int,
                      interpret: bool):
    """Jitted heads-up params -> psum'd per-program partials [3, n]."""
    from montecarlo_tpu.ops.pallas_equity import (
        BLOCK, _lane0_slot, showdown_counts,
    )

    lanes_per_dev = n_programs * BLOCK

    def shard_fn(params):
        lane0 = jax.lax.axis_index(AXIS) * lanes_per_dev
        parts = showdown_counts(params.at[_lane0_slot(2)].set(lane0), 2,
                                n_dead, n_programs, n_iter, 2,
                                interpret=interpret)
        return jax.lax.psum(parts, AXIS)

    return jax.jit(jax.shard_map(shard_fn, mesh=mesh, in_specs=P(),
                                 out_specs=P(), check_vma=False))


def _vs_hand_kernel(
    mesh: Mesh,
    seed: int,
    hero,
    villain,
    n_rollouts: int,
    board=(),
    interpret: bool = False,
) -> EquityResult:
    """Heads-up equity on the Triton showdown kernel over the mesh: each
    device runs its share of programs on its own global lanes, and the
    per-program partials psum over the mesh (summed on the host in
    int64). ``n`` >= ``n_rollouts``."""
    from montecarlo_tpu.ops.pallas_equity import (
        BLOCK, _plan, showdown_params,
    )

    n_dev = mesh.devices.size
    params, _, n_dead = showdown_params(seed, [hero, villain], board)
    n_programs, n_iter = _plan(-(-n_rollouts // n_dev), 2)
    share, _, t = (int(x) for x in
                   np.asarray(_showdown_program(mesh, n_dead, n_programs,
                                                n_iter, interpret)(params),
                              np.int64).sum(axis=1))
    w = (share - t) // 2
    n = n_programs * BLOCK * n_iter * n_dev
    return EquityResult(wins=w, ties=t, losses=n - w - t, n=n)


def sharded_selfplay(
    mesh: Mesh,
    key,
    cfg: TableConfig,
    tables_per_device: int = 1 << 12,
    num_hands: int = 1,
):
    """Random-policy self-play with the tables axis sharded over the mesh
    (BASELINE config 4 at scale). Pure data parallelism: per-table state
    stays device-resident; jit + sharded inputs let XLA place the batch."""
    n_dev = mesh.devices.size
    n_tables = n_dev * tables_per_device
    keys = jax.random.split(key, n_tables)
    sharding = NamedSharding(mesh, P(AXIS))
    keys = jax.device_put(keys, sharding)
    return play_hands(keys, cfg, num_hands=num_hands)


def sharded_selfplay_perpetual(
    mesh: Mesh,
    key,
    cfg: TableConfig,
    tables_per_device: int = 1 << 12,
    n_steps: int = 64,
):
    """Steady-state perpetual tables sharded over the mesh: the production
    throughput shape (config 4 at scale). Returns (final_states,
    total_hands) with the hand count psum-free (the final reduction is a
    plain sum over the sharded hand_idx field, which XLA lowers to an
    all-reduce).
    """
    from montecarlo_tpu.rollout.selfplay import play_hands_perpetual

    n_dev = mesh.devices.size
    keys = jax.random.split(key, n_dev * tables_per_device)
    keys = jax.device_put(keys, NamedSharding(mesh, P(AXIS)))
    return play_hands_perpetual(keys, cfg, n_steps)


def sharded_tournaments(
    mesh: Mesh,
    key,
    cfg: TableConfig,
    tables_per_device: int = 1 << 10,
    max_hands: int = 64,
):
    """Tournaments sharded over the mesh; returns (final, busted_at,
    seat_stacks) exactly like ``play_tournament`` with the tables axis
    distributed."""
    from montecarlo_tpu.rollout.selfplay import play_tournament

    n_dev = mesh.devices.size
    keys = jax.random.split(key, n_dev * tables_per_device)
    keys = jax.device_put(keys, NamedSharding(mesh, P(AXIS)))
    return play_tournament(keys, cfg, max_hands)


def sharded_selfplay_kernel(
    mesh: Mesh,
    seed: int,
    cfg: TableConfig,
    blocks_per_device: int = 64,
    n_steps: int = 256,
):
    """The packed-block engine composed with the mesh: each device runs
    its share of table blocks and the completed-hand counter psum-reduces
    over the mesh. Each shard passes its global block offset, so the
    generator draws for every table exactly what a one-device run of the
    same state draws. Returns (final_packed_state, total_hands)."""
    from montecarlo_tpu.ops.pallas_engine import (
        _field_layout,
        initial_packed_state,
        run_perpetual_prng,
        TABLES_PER_BLOCK,
    )

    n_dev = mesh.devices.size
    n_tables = n_dev * blocks_per_device * TABLES_PER_BLOCK
    seats = cfg.num_seats
    layout, _ = _field_layout(seats, cfg.rules)
    hand_ct_row = layout["hand_ct"][0]

    state0 = jax.device_put(initial_packed_state(seed, cfg, n_tables),
                            NamedSharding(mesh, P(AXIS)))

    @jax.jit
    def run(state):
        def shard_fn(state):
            block0 = jax.lax.axis_index(AXIS) * state.shape[0]
            out = run_perpetual_prng(seed, state, seats, n_steps,
                                     cfg.small_blind, cfg.big_blind,
                                     rules=cfg.rules, block0=block0)
            hands = jnp.sum(out[:, hand_ct_row])
            return out, jax.lax.psum(hands, AXIS)

        return jax.shard_map(shard_fn, mesh=mesh, in_specs=P(AXIS),
                             out_specs=(P(AXIS), P()),
                             check_vma=False)(state)

    final, hands = run(state0)
    return final, int(hands)


def sharded_selfplay_kernel_det(
    mesh: Mesh,
    cfg: TableConfig,
    state,
    actions,
    cards,
    n_steps: int,
):
    """Deterministic-mode packed engine composed with the mesh: table
    blocks, injected action streams, and per-hand deal stashes all shard
    over the tables axis; the completed-hand counter psum-reduces over it.
    Per-device trajectory equality with the XLA engine is pinned in
    tests/test_parallel.py.

    Returns (final packed state [n_blocks, F, 8, 128], total hands)."""
    from montecarlo_tpu.ops.pallas_engine import (
        _field_layout,
        run_perpetual_det,
    )

    layout, _ = _field_layout(cfg.num_seats, cfg.rules)
    hand_ct_row = layout["hand_ct"][0]

    def shard_fn(state, actions, cards):
        out = run_perpetual_det(state, actions, cards, cfg.num_seats,
                                n_steps, cfg.small_blind, cfg.big_blind,
                                rules=cfg.rules)
        hands = jnp.sum(out[:, hand_ct_row])
        return out, jax.lax.psum(hands, AXIS)

    shard = NamedSharding(mesh, P(AXIS))
    state = jax.device_put(jnp.asarray(state, I32), shard)
    actions = jax.device_put(jnp.asarray(actions, I32), shard)
    cards = jax.device_put(jnp.asarray(cards, I32), shard)
    out, hands = jax.jit(jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS), P(AXIS)),
        out_specs=(P(AXIS), P()),
        check_vma=False))(state, actions, cards)
    return out, int(hands)


def sharded_net_kernel_det(
    mesh: Mesh,
    cfg: TableConfig,
    state,
    cards,
    weights,
    n_steps: int,
    n_banks=None,
    seat_to_bank=None,
):
    """Deterministic NET/league engine over the mesh: table blocks and
    deal stashes shard over the tables axis, the banked net weights
    replicate to every device, and the completed-hand counter
    psum-reduces — the multi-device form of the ES/league evaluation
    shape (every seat plays a net, argmax selection, injected deals).
    Per-device equality with the one-device run is pinned in
    tests/test_parallel.py.

    Returns (final packed state [n_blocks, F, 8, 128], total hands)."""
    from montecarlo_tpu.ops.pallas_engine import (
        _field_layout,
        run_net_det,
    )

    layout, _ = _field_layout(cfg.num_seats, cfg.rules)
    hand_ct_row = layout["hand_ct"][0]

    def shard_fn(state, cards, *weights):
        out = run_net_det(state, cards, weights, cfg.num_seats, n_steps,
                          cfg.small_blind, cfg.big_blind,
                          cfg.starting_stack, cfg.rules, n_banks=n_banks,
                          seat_to_bank=seat_to_bank)
        hands = jnp.sum(out[:, hand_ct_row])
        return out, jax.lax.psum(hands, AXIS)

    shard = NamedSharding(mesh, P(AXIS))
    rep = NamedSharding(mesh, P())
    state = jax.device_put(jnp.asarray(state, I32), shard)
    cards = jax.device_put(jnp.asarray(cards, I32), shard)
    weights = tuple(jax.device_put(jnp.asarray(w), rep) for w in weights)
    out, hands = jax.jit(jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(AXIS), P(AXIS)) + (P(),) * len(weights),
        out_specs=(P(AXIS), P()),
        check_vma=False))(state, cards, *weights)
    return out, int(hands)
