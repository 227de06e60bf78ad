"""Run the five BASELINE.json conformance configs end to end.

Usage: python scripts/run_configs.py [--quick]

1. Heads-up seeded hand (blinds 5/5, 100 stacks): full betting + showdown
   trace of public states.
2. 3-player all-in -> side-pot split and remaining-players elimination.
3. AKs vs QQ preflop equity, 1e6 rollouts with 95% CI.
4. Parallel 6-player random-policy tables, full hands to showdown
   (1e6 tables at full scale).
5. 169 canonical hands x 1e7 rollouts sharded over the device mesh with
   psum (scaled down with --quick).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from montecarlo_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from montecarlo_tpu.cards import make_card  # noqa: E402
from montecarlo_tpu.engine import (  # noqa: E402
    TableConfig, clamp_action, init_state, public_board, redeal,
    settle_showdown, step_action,
)
from montecarlo_tpu.parallel.mesh import equity_sweep, make_mesh  # noqa: E402
from montecarlo_tpu.rollout.equity import canonical_hands, equity_vs_hand  # noqa: E402
from montecarlo_tpu.rollout.selfplay import play_hands, selfplay_stats  # noqa: E402

H, D, S, C = 0, 1, 2, 3


def banner(n, title):
    print(f"\n=== Config {n}: {title} " + "=" * max(0, 40 - len(title)))


def config1():
    banner(1, "heads-up seeded hand trace (blinds 5/5)")
    cfg = TableConfig(num_seats=2, small_blind=5, big_blind=5)
    st = init_state(jax.random.key(2024), cfg)
    ids = ["hero", "villain"]
    print(json.dumps(public_board(st, ids)))
    # Scripted: SB calls (completes), BB checks -> flop; check-check x3 -> showdown.
    script = [0, 0] + [0, 0] * 3
    for a in script:
        st = step_action(st, clamp_action(st, jnp.asarray(a, jnp.int32)))
        print(json.dumps(public_board(st, ids)))
    st = settle_showdown(st)
    print("final stacks:", dict(zip(ids, np.asarray(st.stacks).tolist())))


def config2():
    banner(2, "3-player all-in side pot")
    cfg = TableConfig(num_seats=3)
    st = init_state(jax.random.key(7), cfg)
    st = st._replace(stacks=jnp.array([95, 90, 40], jnp.int32))  # short stack p3
    ids = ["p1", "p2", "p3"]
    for a in [30, 0, 0]:  # p3 raise-all-in 40 total; p1, p2 call
        st = step_action(st, clamp_action(st, jnp.asarray(a, jnp.int32)))
    print("after all-in street:", json.dumps(public_board(st, ids)))
    for a in [0, 0, 0, 0, 0, 0]:  # check down
        st = step_action(st, clamp_action(st, jnp.asarray(a, jnp.int32)))
    st = settle_showdown(st)
    print("pots:", json.dumps(public_board(st, ids)["pots"]))
    print("final stacks:", dict(zip(ids, np.asarray(st.stacks).tolist())))
    print("all-in seat excluded from showdown (reference board.clj:80-89):",
          bool(~np.asarray(st.in_hand)[2]))


def config3(quick):
    banner(3, "AKs vs QQ equity, 1e6 rollouts, 95% CI")
    n = 1_000_000
    t0 = time.perf_counter()
    res = equity_vs_hand(jax.random.key(3),
                         [make_card(H, 14), make_card(H, 13)],
                         [make_card(D, 12), make_card(S, 12)],
                         n, batch_size=1 << 17 if quick else 1 << 20)
    dt = time.perf_counter() - t0
    lo, hi = res.ci95
    print(f"equity={res.equity:.5f}  95% CI [{lo:.5f}, {hi:.5f}] "
          f"(width {hi - lo:.5f})  n={res.n:,}  {dt:.2f}s")


def config4(quick):
    banner(4, "parallel 6-player random-policy tables to showdown")
    n_tables = 1 << (12 if quick else 20)
    cfg = TableConfig(num_seats=6)  # default L=12/PL=24; overflow flags monitored
    keys = jax.random.split(jax.random.key(4), n_tables)
    t0 = time.perf_counter()
    final = play_hands(keys, cfg, num_hands=1)
    done = float(jnp.mean(final.hand_over.astype(jnp.float32)))
    dt = time.perf_counter() - t0
    stats = {k: float(v) if hasattr(v, "dtype") else v
             for k, v in selfplay_stats(final).items()}
    print(f"tables={n_tables:,} completed={done:.3f} "
          f"rate={n_tables / dt:,.0f} hands/s (incl. compile)  {dt:.2f}s")
    print("stats:", json.dumps(stats))


def config5(quick):
    banner(5, "169 canonical hands equity sweep")
    mesh = make_mesh()
    hands = canonical_hands()
    heroes = jnp.array([list(cards) for _, cards in hands], jnp.int32)
    n_per = 100_000 if quick else 10_000_000
    t0 = time.perf_counter()
    # shard_map + psum over the device mesh; on a GPU each device runs the
    # Triton sweep kernel (rollout.equity.kernel_impl)
    eq, n = equity_sweep(mesh, jax.random.key(5), heroes, n_per,
                         per_device_batch=1 << (12 if quick else 16))
    dt = time.perf_counter() - t0
    order = np.argsort(-eq)
    top = [(hands[i][0], round(float(eq[i]), 4)) for i in order[:5]]
    bottom = [(hands[i][0], round(float(eq[i]), 4)) for i in order[-3:]]
    print(f"devices={mesh.devices.size} rollouts/hand={n:,} total={169 * n:,} "
          f"{dt:.1f}s ({169 * n / dt:,.0f}/s)")
    print("top:", top, " bottom:", bottom)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    config1()
    config2()
    config3(args.quick)
    config4(args.quick)
    config5(args.quick)
