"""Smoke test of the whole system on an NVIDIA GPU, at deployment sizes.

    python chip_smoke.py           # every phase, on one card
    python chip_smoke.py --four    # only the paths users run across 4 cards

One process holds the card(s) from start to end: a JAX process reserves
most of a card's memory when it starts, so a second one would fail. The
first line names the card and its power limit (``nvidia-smi``). Each
phase prints one JSON line with its sizes, its compile time (first call
minus warm call), its warm time, and its comparison with the plain
reference. The last line is ``{"ok": true, "device": {...}}``. A failed
phase makes the script exit 1; a process without a GPU exits 2 before any
phase runs. There is no CPU fallback.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import math
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

FULL = dict(
    equity_rollouts=1 << 30, multiway_rollouts=1 << 26,
    sweep_per_hand=10_000_000,
    bet_tables=1 << 20, bet_steps=512,
    det_tables=1 << 16, det_steps=48, det_hmax=12,
    net_tables=1 << 18, net_steps=512,
    es_tables=1 << 14, es_steps=256, es_pop=32,
    rf_tables=4096, rf_steps=3,
    net_det_tables=1 << 16, net_det_steps=48, net_det_hmax=16,
    solver_iterations=20, solver_combo_stride=1,
    server_actions=200,
    four_sweep_per_hand=10_000_000, four_tables=1 << 18,
    four_det_tables=1 << 16, four_rf_tables=4096,
)

# Small sizes: the CPU tests run every phase at these.
SMALL = dict(
    equity_rollouts=1 << 16, multiway_rollouts=1 << 14,
    sweep_per_hand=1 << 13,
    bet_tables=1 << 10, bet_steps=32,
    det_tables=1 << 10, det_steps=24, det_hmax=12,
    net_tables=1 << 10, net_steps=32,
    es_tables=1 << 10, es_steps=32, es_pop=2,
    rf_tables=64, rf_steps=1,
    net_det_tables=1 << 10, net_det_steps=24, net_det_hmax=16,
    solver_iterations=4, solver_combo_stride=8,
    server_actions=8,
    four_sweep_per_hand=1 << 13, four_tables=1 << 12,
    four_det_tables=1 << 12, four_rf_tables=64,
)

SEED = 20261016
P6 = 6
SWEEP_CHECKED = ("AA", "KK", "AKs", "72o", "32o")
ES9 = os.path.join(REPO, "data", "policy_6max_es9.npz")
# Pallas kernels in interpret mode: only for rehearsing the phases on a
# CPU at small sizes (main() refuses to run without a GPU).
INTERPRET = False


def card_line() -> str:
    """``name, power.limit`` of every card, as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or f"nvidia-smi: {out.stderr.strip()}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def _block(x):
    import jax

    return jax.block_until_ready(x)


def timed(fn):
    """(warm result, compile seconds, warm seconds): ``fn`` runs twice;
    compile time is the first call's time less the warm call's."""
    t0 = time.perf_counter()
    _block(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = _block(fn())
    warm = time.perf_counter() - t0
    return out, max(first - warm, 0.0), warm


def z_score(est: float, exact: float, n: int) -> float:
    """Deviation of a Monte Carlo estimate in units of the binomial
    standard error sqrt(p(1-p)/n) at the exact p."""
    sigma = math.sqrt(max(exact * (1.0 - exact), 1e-12) / n)
    return (est - exact) / sigma


def _hands():
    from montecarlo_tpu.cards import make_card as c

    aks = [c(0, 14), c(0, 13)]
    qq = [c(1, 12), c(2, 12)]
    jts = [c(3, 11), c(3, 10)]
    return aks, qq, jts


def _other_impl(main: str) -> str:
    return "xla" if main == "triton" else "triton"


# ---------------------------------------------------------------------------
# Phase 1: equity
# ---------------------------------------------------------------------------

def phase_equity(s):
    """Heads-up equity through ``equity_vs_hand`` on the path it picks
    (the Triton kernel on a GPU), the other path beside it, and the XLA
    3-way equity, each against exact enumeration."""
    import jax

    from montecarlo_tpu.ops.pallas_equity import equity_vs_hand_pallas
    from montecarlo_tpu.rollout.equity import (
        EquityResult, equity_exact, equity_exact_multiway, equity_multiway,
        equity_vs_hand, kernel_impl, key_to_seed,
    )

    aks, qq, jts = _hands()
    n = s["equity_rollouts"]
    key = jax.random.key(SEED)
    t0 = time.perf_counter()
    exact = equity_exact(aks, qq).equity
    out = {"sizes": {"rollouts": n, "multiway_rollouts":
                     s["multiway_rollouts"]},
           "path": kernel_impl(), "exact": exact,
           "exact_s": time.perf_counter() - t0}

    def kernel_path():
        w, t, m = equity_vs_hand_pallas(key_to_seed(key), aks, qq, n,
                                        interpret=INTERPRET)
        return EquityResult(w, t, m - w - t, m)

    runs = {out["path"]: lambda: equity_vs_hand(key, aks, qq, n),
            _other_impl(out["path"]): (
                kernel_path if out["path"] == "xla" else
                lambda: equity_vs_hand(key, aks, qq, n, impl="xla"))}
    ok = True
    for impl, fn in runs.items():
        res, comp, warm = timed(fn)
        z = z_score(res.equity, exact, res.n)
        out[impl] = {"compile_s": comp, "warm_s": warm, "rollouts": res.n,
                     "rollouts_per_s": res.n / warm, "equity": res.equity,
                     "z": z}
        ok &= abs(z) <= 5

    trio = [aks, qq, jts]
    nm = s["multiway_rollouts"]
    (eq3, n3), comp3, warm3 = timed(lambda: equity_multiway(key, trio, nm))
    ex3 = equity_exact_multiway(trio)
    z3 = [z_score(float(e), float(x), n3) for e, x in zip(eq3, ex3)]
    out["multiway_xla"] = {"compile_s": comp3, "warm_s": warm3,
                           "equity": eq3.tolist(), "exact": ex3.tolist(),
                           "z": z3}
    ok &= max(abs(v) for v in z3) <= 5
    out["ok"] = bool(ok)
    return out


# ---------------------------------------------------------------------------
# Phase 2: 169-hand sweep
# ---------------------------------------------------------------------------

def exact_vs_random(labels):
    """Exact equity of each labelled hand against a uniformly random
    villain: ``equity_exact_range_vs_range`` over all 1,326 combos (the
    villain evaluations are shared by the heroes of one call)."""
    import itertools

    from montecarlo_tpu.rollout.equity import (
        canonical_hands, equity_exact_range_vs_range,
    )

    by_label = dict(canonical_hands())
    heroes = np.array([by_label[lab] for lab in labels], np.int32)
    combos = np.array(list(itertools.combinations(range(52), 2)), np.int32)
    r = equity_exact_range_vs_range(heroes, combos)
    w = r.pair_weight
    eq = np.nansum(r.pair_equity * w, axis=1) / w.sum(axis=1)
    return dict(zip(labels, eq.tolist()))


def phase_sweep(s, exact_fn=exact_vs_random):
    """``equity_sweep`` on a one-card mesh on the path it picks, the other
    path beside it, five hands of each against exact enumeration."""
    import jax

    from montecarlo_tpu.parallel.mesh import (
        _equity_sweep_kernel, equity_sweep, make_mesh,
    )
    from montecarlo_tpu.rollout.equity import canonical_hands, kernel_impl

    hands = canonical_hands()
    labels = [lab for lab, _ in hands]
    heroes = np.array([cards for _, cards in hands], np.int32)
    mesh = make_mesh(jax.devices()[:1])
    npr = s["sweep_per_hand"]
    key = jax.random.key(SEED + 1)
    t0 = time.perf_counter()
    exact = exact_fn(SWEEP_CHECKED)
    out = {"sizes": {"hands": len(labels), "rollouts_per_hand": npr},
           "path": kernel_impl(), "exact": exact,
           "exact_s": time.perf_counter() - t0}
    runs = {out["path"]: lambda: equity_sweep(mesh, key, heroes, npr),
            _other_impl(out["path"]): (
                (lambda: _equity_sweep_kernel(mesh, key, heroes, npr,
                                              interpret=INTERPRET))
                if out["path"] == "xla" else
                (lambda: equity_sweep(mesh, key, heroes, npr, impl="xla")))}
    ok = True
    for impl, fn in runs.items():
        (eq, n), comp, warm = timed(fn)
        z = {lab: z_score(float(eq[labels.index(lab)]), exact[lab], n)
             for lab in SWEEP_CHECKED}
        out[impl] = {"compile_s": comp, "warm_s": warm,
                     "rollouts_per_hand": n,
                     "rollouts_per_s": len(labels) * n / warm, "z": z}
        ok &= all(abs(v) <= 5 for v in z.values())
    out["ok"] = bool(ok)
    return out


# ---------------------------------------------------------------------------
# Phase 3: betting, 6-max
# ---------------------------------------------------------------------------

def levels_cfg(rules: str):
    """The XLA engine at the packed engine's capacities (levels street
    form; L = 6 reference / 10 otherwise, pots = 4 street slots)."""
    from montecarlo_tpu.engine.state import TableConfig

    L = 6 if rules == "reference" else 10
    return TableConfig(num_seats=P6, max_layers=L, max_pot_layers=4 * L,
                       rules=rules, bets_impl="levels")


def injected_streams(seed: int, T: int, n_steps: int, hmax: int,
                     raise_p: float = 0.03):
    """Raw actions [n_steps, T] (folds 20%, raises ``raise_p``, else
    calls) and per-hand deals [T, hmax, 2P+5] (distinct per hand)."""
    rng = np.random.default_rng(seed)
    u = rng.random((n_steps, T))
    actions = np.where(u < 0.20, -1, np.where(
        u < 1.0 - raise_p, 0, rng.integers(1, 21, (n_steps, T))))
    keys = rng.random((T, hmax, 52), dtype=np.float32)
    cards = np.argsort(keys, axis=-1)[..., :2 * P6 + 5]
    return actions.astype(np.int32), cards.astype(np.int32)


def _bitmask(bools):
    b = np.asarray(bools, np.int64)
    return (b << np.arange(b.shape[1])[None, :]).sum(axis=1)


def det_mismatches(rules: str, T: int, n_steps: int, hmax: int):
    """Packed deterministic mode vs ``step_table`` on the same injected
    streams. Returns (tables compared, tables differing, overflowed)."""
    from montecarlo_tpu.engine.replay import decks_from_cards, replay_injected
    from montecarlo_tpu.ops.pallas_engine import (
        pack_state, pack_streams, run_perpetual_det, unpack_field,
    )

    cfg = levels_cfg(rules)
    actions, cards = injected_streams(SEED + 7, T, n_steps, hmax)
    act_in, cards_in = pack_streams(actions, cards)
    out = run_perpetual_det(pack_state(cfg, cards[:, 0]), act_in, cards_in,
                            P6, n_steps, cfg.small_blind, cfg.big_blind,
                            rules=rules)
    out = np.asarray(out)
    ref, deltas, done, bust = replay_injected(
        actions, decks_from_cards(cards, P6), n_steps, cfg)

    def col(name, i=0):
        return np.asarray(unpack_field(out, cfg, name, i))

    pairs = [
        (col("hand_ct"), done), (col("stage"), ref.stage),
        (col("cursor"), ref.cursor),
        (col("folded"), _bitmask(ref.folded)),
        (col("in_hand"), _bitmask(ref.in_hand)),
        (col("to_act"), _bitmask(ref.to_act)),
        (col("order"), _bitmask(ref.order_mask)),
        (col("street_raises"), ref.street_raises),
    ]
    for k in range(P6):
        pairs += [(col("stacks", k), ref.stacks[:, k]),
                  (col("contrib", k), ref.bets.contrib[:, k]),
                  (col("delta_sum", k), deltas[:, k])]
        if rules == "tournament":
            pairs.append((col("bust_at", k), bust[:, k]))
    for j in range(cfg.max_layers):
        pairs += [(col("lvl", j), ref.bets.level[:, j]),
                  (col("ln", j), ref.bets.n[:, j])]
    differ = np.zeros(T, bool)
    for a, b in pairs:
        differ |= np.asarray(a) != np.asarray(b)
    clean = col("overflow") == 0
    return int(clean.sum()), int((differ & clean).sum()), int((~clean).sum())


def phase_betting(s):
    import jax
    import jax.numpy as jnp

    from montecarlo_tpu.engine.state import TableConfig
    from montecarlo_tpu.ops.pallas_engine import (
        initial_packed_state, run_perpetual_prng, selfplay_perpetual_kernel,
        unpack_field,
    )
    from montecarlo_tpu.rollout.selfplay import play_hands_perpetual

    T, n_steps = s["bet_tables"], s["bet_steps"]
    out = {"sizes": {"tables": T, "steps": n_steps, "rules": "reference"}}

    cfg_x = TableConfig(num_seats=P6, max_layers=8, max_pot_layers=16)
    keys = jax.random.split(jax.random.key(SEED + 2), T)
    (final, hands), comp, warm = timed(
        lambda: play_hands_perpetual(keys, cfg_x, n_steps))
    hands = int(hands)
    ovf = int(jnp.sum(final.bets.overflow | final.pots.overflow))
    del final
    out["xla_engine"] = {"compile_s": comp, "warm_s": warm,
                         "hands_per_s": hands / warm,
                         "steps_per_hand": T * n_steps / max(hands, 1),
                         "overflow": ovf}
    ok = hands > 0 and ovf == 0

    cfg = TableConfig(num_seats=P6)
    (_, hk, ovk), compk, warmk = timed(
        lambda: selfplay_perpetual_kernel(SEED, cfg, T, n_steps))
    state0 = initial_packed_state(SEED, cfg, T)
    st, compe, warme = timed(lambda: run_perpetual_prng(
        SEED, state0, P6, n_steps, cfg.small_blind, cfg.big_blind))
    he = int(jnp.sum(unpack_field(st, cfg, "hand_ct")))
    del st, state0
    out["packed_engine"] = {
        "compile_s": compk, "warm_s": warmk, "hands_per_s": hk / warmk,
        "steps_per_hand": T * n_steps / max(hk, 1), "overflow": ovk,
        "engine_only": {"compile_s": compe, "warm_s": warme,
                        "hands_per_s": he / warme}}
    ok &= hk > 0 and ovk == 0

    det = {}
    for rules in ("reference", "standard", "tournament"):
        (n_cmp, n_diff, n_ovf), compd, warmd = timed(lambda: det_mismatches(
            rules, s["det_tables"], s["det_steps"], s["det_hmax"]))
        det[rules] = {"compared": n_cmp, "differing": n_diff,
                      "overflowed": n_ovf, "compile_s": compd,
                      "warm_s": warmd}
        ok &= n_diff == 0 and n_cmp >= 0.99 * s["det_tables"]
    out["det_vs_step_table"] = det
    out["det_sizes"] = {"tables": s["det_tables"], "steps": s["det_steps"]}
    out["ok"] = bool(ok)
    return out


# ---------------------------------------------------------------------------
# Phase 4: net evaluation and training
# ---------------------------------------------------------------------------

def _perturbed(params, n: int, scale: float = 0.01):
    import jax

    leaves, tree = jax.tree.flatten(params)
    rng = np.random.default_rng(SEED + 3)
    return [jax.tree.unflatten(tree, [
        np.asarray(x) + scale * rng.standard_normal(np.shape(x))
        .astype(np.float32) for x in leaves]) for _ in range(n)]


def net_det_mismatches(params, T: int, n_steps: int, hmax: int):
    """Deterministic (argmax) packed net mode vs the XLA net pipeline,
    every seat playing ``params``. Returns (tables, differing)."""
    from montecarlo_tpu.engine.replay import (
        decks_from_cards, replay_net_argmax,
    )
    from montecarlo_tpu.ops.pallas_engine import (
        net_weights, pack_state, pack_streams, run_net_det, unpack_field,
    )

    cfg = levels_cfg("standard")
    _, cards = injected_streams(SEED + 11, T, 1, hmax)
    out = np.asarray(run_net_det(
        pack_state(cfg, cards[:, 0]), pack_streams(cards=cards),
        net_weights(params), P6, n_steps, cfg.small_blind, cfg.big_blind,
        cfg.starting_stack, cfg.rules))
    ref, done = replay_net_argmax(cfg, [params] * P6,
                                  decks_from_cards(cards, P6), n_steps)

    def col(name, i=0):
        return np.asarray(unpack_field(out, cfg, name, i))

    differ = (col("hand_ct") != np.asarray(done)) \
        | (col("stage") != np.asarray(ref.stage)) \
        | (col("folded") != _bitmask(ref.folded))
    for k in range(P6):
        differ |= col("stacks", k) != np.asarray(ref.stacks[:, k])
        differ |= col("contrib", k) != np.asarray(ref.bets.contrib[:, k])
    clean = col("overflow") == 0
    return int(clean.sum()), int((differ & clean).sum())


def phase_net(s):
    import jax

    from montecarlo_tpu.engine.state import TableConfig
    from montecarlo_tpu.models.policy_net import MATMUL_PRECISION, load_params
    from montecarlo_tpu.models.train import train_policy
    from montecarlo_tpu.models.train_es import kernel_eval_pop_fn
    from montecarlo_tpu.ops.pallas_engine import selfplay_net_eval_kernel

    cfg = TableConfig(num_seats=P6, rules="standard")
    params = load_params(ES9)
    T, n_steps = s["net_tables"], s["net_steps"]
    out = {"sizes": {"net_tables": T, "net_steps": n_steps,
                     "es_tables": s["es_tables"], "es_steps": s["es_steps"],
                     "es_pop": s["es_pop"], "rf_tables": s["rf_tables"],
                     "rf_steps": s["rf_steps"],
                     "det_tables": s["net_det_tables"]},
           "matmul_precision": str(MATMUL_PRECISION)}

    (means, _, hands), comp, warm = timed(lambda: selfplay_net_eval_kernel(
        SEED, cfg, params, net_seats=1, n_tables=T, n_steps=n_steps))
    out["net_eval"] = {"compile_s": comp, "warm_s": warm,
                       "hands_per_s": hands / warm,
                       "seat0_bb_per_hand": float(means[0])}
    ok = hands > 0 and bool(np.all(np.isfinite(means)))

    eval_pop = kernel_eval_pop_fn(cfg, 1, s["es_tables"], s["es_steps"])
    pop = _perturbed(params, s["es_pop"])
    (fits, hands_g), comp, warm = timed(lambda: eval_pop(pop, SEED))
    out["es_generation"] = {"compile_s": comp, "warm_s": warm,
                            "hands_per_s": int(np.sum(hands_g)) / warm,
                            "fitness_spread": float(np.ptp(fits))}
    ok &= bool(np.all(np.isfinite(fits)))

    res, comp, warm = timed(lambda: train_policy(
        jax.random.key(SEED), cfg=cfg, tables=s["rf_tables"],
        steps=s["rf_steps"]))
    rewards = np.asarray(res.mean_reward_bb)
    out["reinforce"] = {"compile_s": comp, "warm_s": warm,
                        "mean_reward_bb": rewards.tolist()}
    ok &= bool(np.all(np.isfinite(rewards)))

    (n_cmp, n_diff), comp, warm = timed(lambda: net_det_mismatches(
        params, s["net_det_tables"], s["net_det_steps"], s["net_det_hmax"]))
    out["det_vs_xla_net"] = {"compared": n_cmp, "differing": n_diff,
                             "required_agreement": 0.999,
                             "compile_s": comp, "warm_s": warm}
    ok &= n_cmp >= 0.99 * s["net_det_tables"] and n_diff <= 0.001 * n_cmp
    out["ok"] = bool(ok)
    return out


# ---------------------------------------------------------------------------
# Phase 5: two-street solver
# ---------------------------------------------------------------------------

# The bet sizes ``turn_river_node_states`` measures from the engine's own
# pot-raise menu on TURN_BOARD (``scripts/turn_gap.py`` plays them; pinned
# in tests/test_chip_smoke_solver.py, since measuring them costs minutes).
TURN_SIZES = {"pot": 20.0, "bet": 20.0, "river_bets": (20.0, 30.0, 30.0, 30.0)}


def turn_board():
    from montecarlo_tpu.cards import make_card as c

    return [c(2, 13), c(0, 8), c(1, 5), c(3, 2)]


def turn_game(combo_stride: int):
    """The turn+river game ``scripts/turn_gap.py`` solves on its first
    board, at its combo stride."""
    from montecarlo_tpu.models.turn_solver import (
        make_turn_river_game, turn_combos,
    )

    board4 = turn_board()
    sub = turn_combos(board4)[::combo_stride] if combo_stride > 1 else None
    game, combos = make_turn_river_game(
        board4, combos=sub, pot=TURN_SIZES["pot"], bet=TURN_SIZES["bet"],
        river_bets=TURN_SIZES["river_bets"], turn_raise=False,
        river_raise=False)
    return game, len(combos)


def solve(game, iterations: int, mesh=None):
    """``solve_turn_river`` for exactly ``iterations`` (one compiled chunk
    of that length; the sharded solver rounds up to whole chunks)."""
    from montecarlo_tpu.models.turn_solver import solve_turn_river

    return solve_turn_river(game, iterations=iterations,
                            progress_every=iterations, log=lambda d: None,
                            mesh=mesh)


def phase_solver(s):
    from montecarlo_tpu.models.turn_solver import (
        SOLVER_PRECISION, exploitability_gap,
    )

    game, n_combos = turn_game(s["solver_combo_stride"])
    it = s["solver_iterations"]
    nash, comp, warm = timed(lambda: solve(game, it))
    gap = exploitability_gap(game, nash)
    gap1 = exploitability_gap(game, solve(game, 1))
    return {"sizes": {"combos": n_combos, "rivers": int(game.keys.shape[0]),
                      "iterations": it},
            "precision": SOLVER_PRECISION,
            "compile_s": comp, "warm_s": warm,
            "s_per_iteration": warm / it,
            "gap_bb": gap / 10.0, "gap_bb_after_1": gap1 / 10.0,
            "ok": bool(np.isfinite(gap) and 0.0 <= gap < gap1)}


# ---------------------------------------------------------------------------
# Phase 6: server
# ---------------------------------------------------------------------------

async def _client(port):
    r, w = await asyncio.open_connection("127.0.0.1", port)
    return {"r": r, "w": w}


async def _send(c, obj):
    c["w"].write((json.dumps(obj) + "\r\n").encode())
    await c["w"].drain()


async def _recv(c, timeout=300.0):
    line = await asyncio.wait_for(c["r"].readline(), timeout)
    return json.loads(line.decode().rstrip())


async def play_room(port: int, room: str, n_clients: int, n_actions: int,
                    extra: dict, n_warm: int, amt: int = 0):
    """Create ``room`` (``extra`` adds request fields), seat ``n_clients``
    socket clients, and have whichever client heads the play order play
    ``amt`` (0 calls, -1 folds), ``n_warm + n_actions`` times. Latency is
    the client's view: its ``play`` line leaving the socket to the first
    newer board arriving (after a fold, the next hand's first board).
    Returns the latencies of the last ``n_actions`` actions."""
    clients = [await _client(port) for _ in range(n_clients)]
    for c in clients:
        await _send(c, {"type": "whoami"})
        c["pid"] = await _recv(c)
    by_pid = {c["pid"]: c for c in clients}
    n = extra.get("n", n_clients)
    await _send(clients[0], {"type": "new_room", "name": room, "n": n,
                             **extra})
    ack = await _recv(clients[0])
    assert ack.get("status") == 0, ack
    q: asyncio.Queue = asyncio.Queue()

    async def reader(c):
        while True:
            line = await c["r"].readline()
            if not line:
                return
            msg = json.loads(line.decode().rstrip())
            if isinstance(msg, dict) and "play-order" in msg:
                q.put_nowait((time.perf_counter(), msg))

    tasks = [asyncio.ensure_future(reader(c)) for c in clients]
    for c in clients:
        await _send(c, {"type": "join_room", "name": room})

    async def next_board(prev):
        while True:
            t, b = await asyncio.wait_for(q.get(), 120.0)
            if b != prev:
                return t, b

    async def head_board(board):
        # bots act inside the server; wait until a client heads the order
        while board["play-order"][0] not in by_pid:
            _, board = await next_board(board)
        return board

    _, board = await next_board(None)
    board = await head_board(board)
    lat = []
    for i in range(n_warm + n_actions):
        head = by_pid[board["play-order"][0]]
        t0 = time.perf_counter()
        await _send(head, {"type": "play", "name": room, "amt": amt})
        t1, board = await next_board(board)
        if i >= n_warm:
            lat.append(t1 - t0)
        board = await head_board(board)
    for t in tasks:
        t.cancel()
    for c in clients:
        c["w"].close()
    return lat


def _pct(lat, p):
    lat = sorted(lat)
    return lat[min(len(lat) - 1, int(p / 100 * len(lat)))]


async def _serve_rooms(n_actions: int, tag: str):
    from montecarlo_tpu.server.tcp import start_server

    server, _ = await start_server(host="127.0.0.1", port=0)
    port = server.sockets[0].getsockname()[1]
    res = {}
    try:
        # Two clients that always call play forever under reference
        # rules (busted seats are redealt). Against five house bots under
        # standard rules a calling client soon busts and sits out, so it
        # folds: a few dozen hands on its 100 chips of blinds.
        rooms = {
            "reference_2_clients": (2, {}, 0, n_actions),
            "standard_5_bots": (1, {"n": P6, "rules": "standard",
                                    "bots": 5}, -1, min(n_actions, 24)),
        }
        for name, (n_clients, extra, amt, n) in rooms.items():
            lat = await play_room(port, f"{name}-{tag}", n_clients, n,
                                  extra, n_warm=4, amt=amt)
            res[name] = {"actions": len(lat),
                         "p50_ms": _pct(lat, 50) * 1e3,
                         "p99_ms": _pct(lat, 99) * 1e3}
    finally:
        server._mc_sweeper.cancel()
        server.close()
        await server.wait_closed()
    return res


def phase_server(s):
    """Rooms served from this process (which also holds the GPU), once
    with room state on the host CPU and once on the card."""
    import jax

    from montecarlo_tpu.server import backends

    out = {"sizes": {"actions_per_room": s["server_actions"]}}
    default = backends.ROOM_PLATFORM
    ok = True
    try:
        for platform in ("cpu", jax.devices()[0].platform):
            backends.ROOM_PLATFORM = platform
            t0 = time.perf_counter()
            res = asyncio.run(_serve_rooms(s["server_actions"], platform))
            res["wall_s"] = time.perf_counter() - t0
            out[f"rooms_on_{platform}"] = res
            ok &= all(r["actions"] > 0 for k, r in res.items()
                      if k != "wall_s")
    finally:
        backends.ROOM_PLATFORM = default
    out["default_room_platform"] = default
    out["ok"] = bool(ok)
    return out


# ---------------------------------------------------------------------------
# --four: the paths users run across cards, each against one card
# ---------------------------------------------------------------------------

def four_sweep(s, devices):
    import jax

    from montecarlo_tpu.parallel.mesh import equity_sweep, make_mesh
    from montecarlo_tpu.rollout.equity import canonical_hands

    hands = canonical_hands()
    heroes = np.array([cards for _, cards in hands], np.int32)
    npr = s["four_sweep_per_hand"]
    key = jax.random.key(SEED + 5)
    (eq4, n4), comp4, warm4 = timed(
        lambda: equity_sweep(make_mesh(devices), key, heroes, npr))
    (eq1, n1), comp1, warm1 = timed(
        lambda: equity_sweep(make_mesh(devices[:1]), key, heroes, npr))
    # two independent estimates: the difference has sd sqrt(2) sigma
    se = np.sqrt(eq1 * (1 - eq1) * (1 / n1 + 1 / n4))
    z = float(np.max(np.abs(eq4 - eq1) / se))
    return {"hands": len(hands), "rollouts_per_hand": n4,
            "warm_s_4": warm4, "warm_s_1": warm1, "compile_s_4": comp4,
            "max_z": z, "ok": z <= 5}


def four_dp(s, devices):
    import jax

    from montecarlo_tpu.engine.state import TableConfig
    from montecarlo_tpu.models.policy_net import init_params
    from montecarlo_tpu.parallel.mesh import make_mesh
    from montecarlo_tpu.parallel.train_dp import make_dp_grad_fn

    cfg = TableConfig(num_seats=P6, rules="standard")
    params = init_params(jax.random.key(SEED))
    key = jax.random.key(SEED + 6)
    per = s["four_rf_tables"] // len(devices)
    g4fn = make_dp_grad_fn(make_mesh(devices), cfg, tables_per_device=per)
    g1fn = make_dp_grad_fn(make_mesh(devices[:1]), cfg,
                           tables_per_device=per * len(devices))
    (g4, r4), comp4, warm4 = timed(lambda: g4fn(params, key))
    (g1, r1), comp1, warm1 = timed(lambda: g1fn(params, key))
    rel = max(float(np.max(np.abs(np.asarray(a) - np.asarray(b)))
                    / (np.max(np.abs(np.asarray(b))) + 1e-12))
              for a, b in zip(jax.tree.leaves(g4), jax.tree.leaves(g1)))
    return {"global_tables": per * len(devices), "warm_s_4": warm4,
            "warm_s_1": warm1, "compile_s_4": comp4,
            "reward_4": float(r4), "reward_1": float(r1),
            "max_rel_grad_diff": rel, "tolerance": 1e-4,
            "ok": rel <= 1e-4 and abs(float(r4) - float(r1)) <= 1e-5}


def four_perpetual(s, devices):
    import jax
    import jax.numpy as jnp

    from montecarlo_tpu.engine.state import TableConfig
    from montecarlo_tpu.parallel.mesh import (
        make_mesh, sharded_selfplay_perpetual,
    )

    cfg = TableConfig(num_seats=P6, max_layers=8, max_pot_layers=16)
    per = s["four_tables"] // len(devices)
    (final, hands), comp, warm = timed(lambda: sharded_selfplay_perpetual(
        make_mesh(devices), jax.random.key(SEED + 8), cfg,
        tables_per_device=per, n_steps=256))
    ovf = int(jnp.sum(final.bets.overflow | final.pots.overflow))
    hands = int(hands)
    return {"tables": per * len(devices), "steps": 256, "hands": hands,
            "hands_per_s": hands / warm, "compile_s": comp,
            "overflow": ovf, "ok": hands > 0 and ovf == 0}


def four_packed_det(s, devices):
    from montecarlo_tpu.ops.pallas_engine import (
        TABLES_PER_BLOCK, pack_state, pack_streams, run_perpetual_det,
    )
    from montecarlo_tpu.parallel.mesh import (
        make_mesh, sharded_selfplay_kernel_det,
    )

    cfg = levels_cfg("standard")
    T, n_steps, hmax = s["four_det_tables"], 48, 12
    actions, cards = injected_streams(SEED + 9, T, n_steps, hmax)
    act_in, cards_in = pack_streams(actions, cards)
    state = pack_state(cfg, cards[:, 0])
    (out4, hands4), comp, warm = timed(lambda: sharded_selfplay_kernel_det(
        make_mesh(devices), cfg, state, act_in, cards_in, n_steps))
    out1 = run_perpetual_det(state, act_in, cards_in, P6, n_steps,
                             cfg.small_blind, cfg.big_blind, rules=cfg.rules)
    equal = bool(np.array_equal(np.asarray(out4), np.asarray(out1)))
    return {"tables": T, "blocks": T // TABLES_PER_BLOCK, "steps": n_steps,
            "hands": hands4, "compile_s": comp, "warm_s": warm,
            "equal_to_one_card": equal, "ok": equal and hands4 > 0}


def four_solver(s, devices):
    from montecarlo_tpu.models.turn_solver import exploitability_gap
    from montecarlo_tpu.parallel.mesh import make_mesh

    game, n_combos = turn_game(s["solver_combo_stride"])
    it = s["solver_iterations"]
    nash4, comp, warm4 = timed(lambda: solve(game, it,
                                             mesh=make_mesh(devices)))
    nash1, _, warm1 = timed(lambda: solve(game, it))
    g4 = exploitability_gap(game, nash4)
    g1 = exploitability_gap(game, nash1)
    return {"combos": n_combos, "iterations": it, "warm_s_4": warm4,
            "warm_s_1": warm1, "compile_s_4": comp, "gap_bb_4": g4 / 10.0,
            "gap_bb_1": g1 / 10.0, "tolerance_bb": 1e-3,
            "ok": abs(g4 - g1) / 10.0 <= 1e-3}


PHASES = (("equity", phase_equity), ("sweep169", phase_sweep),
          ("betting", phase_betting), ("net", phase_net),
          ("solver", phase_solver), ("server", phase_server))

FOUR = (("sweep169_mesh", four_sweep), ("dp_grads", four_dp),
        ("perpetual_mesh", four_perpetual),
        ("packed_det_mesh", four_packed_det),
        ("solver_mesh", four_solver))


def run_phase(name, fn, *args):
    """Run one phase; print its JSON line. Returns True if it passed."""
    t0 = time.perf_counter()
    try:
        res = fn(*args)
    except Exception as e:  # a failed phase is reported, never hidden
        traceback.print_exc(file=sys.stderr)
        res = {"ok": False, "error": f"{type(e).__name__}: {e}"}
    res = {"phase": name, **res, "phase_s": time.perf_counter() - t0}
    print(json.dumps(res), flush=True)
    return bool(res["ok"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card paths")
    args = ap.parse_args(argv)

    import jax

    from montecarlo_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    enable_compile_cache()
    sizes = FULL
    devices = jax.devices()
    print(card_line(), flush=True)  # as nvidia-smi prints it
    print(json.dumps({"jax": jax.__version__,
                      "device_kind": dev.device_kind,
                      "count": len(devices)}), flush=True)
    ok = True
    if args.four:
        if len(devices) < 4:
            print("chip_smoke --four: needs 4 cards", file=sys.stderr)
            return 2
        for name, fn in FOUR:
            ok &= run_phase(name, fn, sizes, devices[:4])
        count = 4
    else:
        for name, fn in PHASES:
            ok &= run_phase(name, fn, sizes)
        count = 1
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
