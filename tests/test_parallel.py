"""Mesh sharding on the 8-device CPU test mesh (BASELINE config 5 machinery:
shard_map + psum over the tables axis)."""

import jax
import jax.numpy as jnp
import numpy as np

from montecarlo_tpu.cards import make_card
from montecarlo_tpu.engine.state import TableConfig
from montecarlo_tpu.parallel.mesh import (
    equity_sweep,
    make_mesh,
    sharded_equity_vs_hand,
    sharded_selfplay,
)

H, D, S = 0, 1, 2


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8


def test_sharded_equity_matches_textbook():
    mesh = make_mesh()
    hero = [make_card(H, 14), make_card(H, 13)]
    villain = [make_card(D, 12), make_card(S, 12)]
    res = sharded_equity_vs_hand(mesh, jax.random.key(0), hero, villain,
                                 n_rollouts=320_000, per_device_batch=1 << 13)
    assert res.n >= 320_000
    assert abs(res.equity - 0.460) < 0.008, res.equity


def test_equity_sweep_orders_hands():
    mesh = make_mesh()
    heroes = jnp.array([
        [make_card(H, 14), make_card(D, 14)],  # AA
        [make_card(H, 13), make_card(H, 12)],  # KQs
        [make_card(H, 7), make_card(D, 2)],    # 72o
    ], jnp.int32)
    eq, n = equity_sweep(mesh, jax.random.key(1), heroes,
                         n_rollouts_per_hand=64_000,
                         per_device_batch=1 << 12)
    assert n >= 64_000
    assert eq[0] > eq[1] > eq[2], eq


def test_sharded_selfplay_runs():
    mesh = make_mesh()
    cfg = TableConfig(num_seats=6, max_layers=16, max_pot_layers=48)
    final = sharded_selfplay(mesh, jax.random.key(2), cfg,
                             tables_per_device=8, num_hands=1)
    assert bool(jnp.all(final.hand_over))
    assert final.stacks.shape == (64, 6)


def test_graft_entry_dryrun():
    import __graft_entry__ as g

    g.dryrun_multichip(8)
    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert int(out.time.sum()) > 0


def test_graft_entry_dryrun_fresh_subprocess():
    """The driver's real contract: a fresh process WITHOUT conftest's env.

    The entry must self-provision the 8-device virtual CPU mesh even when
    the process's default backend (one device) has already initialized.
    """
    import os
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "JAX_NUM_CPU_DEVICES")}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c",
         "import jax; jax.devices();"  # force default-backend init first
         "import __graft_entry__ as g; g.dryrun_multichip(8); print('OK')"],
        cwd=repo, env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "OK" in proc.stdout


def test_dp_train_step_on_mesh():
    from montecarlo_tpu.models.policy_net import init_params
    from montecarlo_tpu.parallel.train_dp import make_dp_train_step

    mesh = make_mesh()
    cfg = TableConfig(num_seats=2, rules="standard",
                      max_layers=8, max_pot_layers=16)
    params = init_params(jax.random.key(0))
    opt_init, step = make_dp_train_step(mesh, cfg, tables_per_device=16,
                                        max_steps=24)
    opt_state = opt_init(params)
    p1, opt_state, r1 = step(params, opt_state, jax.random.key(1))
    p2, _, r2 = step(p1, opt_state, jax.random.key(2))
    assert bool(jnp.isfinite(r1)) and bool(jnp.isfinite(r2))
    # Params actually moved.
    delta = sum(float(jnp.abs(a - b).sum())
                for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(p2)))
    assert delta > 0


def test_sharded_perpetual_selfplay():
    from montecarlo_tpu.parallel.mesh import sharded_selfplay_perpetual

    mesh = make_mesh()
    cfg = TableConfig(num_seats=6, max_layers=8, max_pot_layers=16)
    final, hands = sharded_selfplay_perpetual(
        mesh, jax.random.key(7), cfg, tables_per_device=16, n_steps=64)
    assert int(hands) > 8 * 16  # every table finishes at least one hand
    assert final.stacks.shape == (128, 6)


def test_sharded_tournaments():
    from montecarlo_tpu.parallel.mesh import sharded_tournaments
    from montecarlo_tpu.rollout.selfplay import tournament_placements

    mesh = make_mesh()
    cfg = TableConfig(num_seats=2, rules="tournament",
                      small_blind=25, big_blind=50,
                      max_layers=8, max_pot_layers=16)
    final, busted, stacks = sharded_tournaments(
        mesh, jax.random.key(8), cfg, tables_per_device=16, max_hands=48)
    s = np.asarray(stacks, np.int64)
    np.testing.assert_array_equal(s.sum(axis=1), np.full(128, 200))
    done = (s > 0).sum(axis=1) == 1
    assert done.mean() > 0.9
    places = tournament_placements(busted, stacks)
    assert places.shape == (128, 2)


def test_sharded_engine_kernel_det_matches_xla_per_device():
    """Multi-device coverage of the packed-block engine: shard_map the
    DETERMINISTIC mode over the 8-device CPU mesh with per-device injected
    streams, and assert each device's trajectory equals the XLA engine
    driven by that device's stream."""
    from montecarlo_tpu.ops.pallas_engine import TILE, pack_state, unpack_field
    from montecarlo_tpu.parallel.mesh import sharded_selfplay_kernel_det
    from tests.test_pallas_engine import (
        CFG, HMAX, N_CARDS, P as SEATS, _bitmask, _decks_from_cards,
        _replica, _streams,
    )

    mesh = make_mesh()
    n_dev = mesh.devices.size
    n_steps = 12

    blocks, all_actions, all_decks = [], [], []
    act_in, cards_in = [], []
    for d in range(n_dev):
        actions, cards = _streams(1000 + d)
        blocks.append(pack_state(CFG, cards[:, 0]))
        all_actions.append(actions)
        all_decks.append(_decks_from_cards(cards))
        act_in.append(actions[:n_steps].reshape(n_steps, *TILE))
        cards_in.append(
            cards.transpose(1, 2, 0).reshape(HMAX, N_CARDS, *TILE))

    state = jnp.concatenate(blocks, axis=0)
    out, total_hands = sharded_selfplay_kernel_det(
        mesh, CFG, state, np.stack(act_in), np.stack(cards_in), n_steps)
    out = np.asarray(out)
    assert total_hands > 0

    for d in range(n_dev):
        ref, _, ref_done, _ = _replica(all_actions[d], all_decks[d],
                                       n_steps, CFG)
        dev = out[d:d + 1]

        def col(name, i=0):
            return np.asarray(unpack_field(dev, CFG, name, i))

        clean = col("overflow") == 0
        assert clean.mean() > 0.9

        def eq(a, b, what):
            assert np.array_equal(a[clean], np.asarray(b)[clean]), (d, what)

        eq(col("hand_ct"), ref_done, "hand counts")
        eq(col("stage"), ref.stage, "stage")
        eq(col("cursor"), ref.cursor, "cursor")
        eq(col("in_hand"), _bitmask(ref.in_hand), "in_hand")
        stacks = np.stack([col("stacks", i) for i in range(SEATS)], axis=-1)
        eq(stacks, np.asarray(ref.stacks).reshape(-1, SEATS).reshape(
            stacks.shape), "stacks")


def test_sharded_net_kernel_det_per_device_equality():
    """Multi-device coverage of the NET/league engine: shard_map the
    deterministic net mode (argmax pick, injected deals) over the 8-device
    CPU mesh with per-device deal stashes, and assert each device's block
    equals the single-device run on the same stash. The single-device det
    net mode is itself trajectory-pinned against the XLA net pipeline in
    tests/test_pallas_engine.py, so equality here chains to the XLA
    pipeline."""
    from montecarlo_tpu.models.bots import panel
    from montecarlo_tpu.ops.pallas_engine import (
        TILE, _stack_weights_league, pack_state, run_net_det,
        unpack_field,
    )
    from montecarlo_tpu.parallel.mesh import sharded_net_kernel_det
    from tests.test_pallas_engine import N_CARDS, P as SEATS, make_cfg

    mesh = make_mesh()
    n_dev = mesh.devices.size
    n_steps, hmax = 10, 8
    cfg = make_cfg("standard")

    bots = panel()
    banks = [bots["jam_tight"], bots["fof_call"]]
    stb = (0,) + (1,) * (SEATS - 1)
    weights = _stack_weights_league(banks)

    rng = np.random.default_rng(71)
    blocks, stashes = [], []
    for d in range(n_dev):
        cards = np.argsort(rng.random((TILE[0] * TILE[1], hmax, 52)),
                           axis=-1)[..., :N_CARDS].astype(np.int32)
        blocks.append(pack_state(cfg, cards[:, 0]))
        stashes.append(
            cards.transpose(1, 2, 0).reshape(hmax, N_CARDS, *TILE))

    state = jnp.concatenate(blocks, axis=0)
    cards_in = np.stack(stashes)
    out, total_hands = sharded_net_kernel_det(
        mesh, cfg, state, cards_in, weights, n_steps, n_banks=2,
        seat_to_bank=stb)
    out = np.asarray(out)
    assert total_hands > 0
    assert int(np.asarray(
        unpack_field(out, cfg, "hand_ct")).sum()) == total_hands

    for d in range(n_dev):
        single = np.asarray(run_net_det(
            blocks[d], jnp.asarray(cards_in[d:d + 1]), weights, SEATS,
            n_steps, cfg.small_blind, cfg.big_blind, cfg.starting_stack,
            cfg.rules, n_banks=2, seat_to_bank=stb))
        assert np.array_equal(out[d:d + 1], single), f"device {d}"


def test_dp_grads_do_not_depend_on_the_mesh():
    """Table keys and seats are indexed globally, so eight devices with
    T tables each compute the gradients of one device with 8T tables,
    up to float summation order."""
    from montecarlo_tpu.models.policy_net import init_params
    from montecarlo_tpu.parallel.train_dp import make_dp_grad_fn

    cfg = TableConfig(num_seats=2, rules="standard",
                      max_layers=8, max_pot_layers=16)
    params = init_params(jax.random.key(0))
    key = jax.random.key(3)
    g8, r8 = make_dp_grad_fn(make_mesh(), cfg, tables_per_device=4,
                             max_steps=24)(params, key)
    g1, r1 = make_dp_grad_fn(make_mesh(jax.devices()[:1]), cfg,
                             tables_per_device=32, max_steps=24)(params, key)
    for a, b in zip(jax.tree.leaves(g8), jax.tree.leaves(g1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-6)
    assert abs(float(r8) - float(r1)) < 1e-5


def test_sharded_generator_engine_matches_one_device():
    """Each shard passes its global block offset, so the sharded
    generator-mode engine draws what one device draws for every table."""
    from montecarlo_tpu.ops.pallas_engine import (
        initial_packed_state, run_perpetual_prng, unpack_field,
    )
    from montecarlo_tpu.parallel.mesh import sharded_selfplay_kernel

    mesh = make_mesh()
    cfg = TableConfig(num_seats=6)
    out, hands = sharded_selfplay_kernel(mesh, 4, cfg, blocks_per_device=1,
                                         n_steps=16)
    one = run_perpetual_prng(4, initial_packed_state(4, cfg, 8 * 1024), 6,
                             16, cfg.small_blind, cfg.big_blind)
    assert np.array_equal(np.asarray(out), np.asarray(one))
    assert hands == int(np.asarray(unpack_field(one, cfg, "hand_ct")).sum())
