"""Benchmark: Monte Carlo rollout + betting-engine throughput on one card.

Prints ONE JSON line on stdout: {"metric", "value", "unit", "device", ...}.

The headline metric is equity rollouts/sec (one rollout = deal a random
5-card board from the live deck, rank both 7-card hands with the bitmask
evaluator, compare, reduce — the hot path of the equity API, BASELINE
configs 3/5). The same line reports ``betting_hands_per_sec``: full
betting hands (blinds -> betting rounds -> showdown -> payout) through the
packed-block engine (``ops/pallas_engine.py``), the 169-hand sweep time,
and the net-evaluation and ES-training rates. Every number is a warm
time on the device named in ``device``, ended by ``block_until_ready``.
An axis that fails is named on stderr and makes the script exit 1; there
is no fallback to another path or device.
"""

import json
import sys
import time

import jax
import jax.numpy as jnp

from montecarlo_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

from montecarlo_tpu.cards import make_card  # noqa: E402


class AxisFailed(RuntimeError):
    """One benchmark axis failed; its name leads the message."""


def _best(fn, reps):
    """Warm call, then the best of ``reps`` timed calls: (seconds, out)."""
    jax.block_until_ready(fn(0))
    best = None
    for i in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(i + 1))
        dt = time.perf_counter() - t0
        if best is None or dt < best[0]:
            best = (dt, out)
    return best


def equity_axis(n=1 << 30):
    """AKs vs QQ preflop, ``n`` rollouts through ``equity_vs_hand`` on the
    path it picks (the Triton kernel on a GPU), and on the XLA path."""
    from montecarlo_tpu.rollout.equity import (
        _equity_vs_hand_device, equity_vs_hand, kernel_impl,
    )

    aks = [make_card(0, 14), make_card(0, 13)]
    qq = [make_card(1, 12), make_card(2, 12)]
    key = jax.random.key(0)
    dt, res = _best(lambda i: equity_vs_hand(
        jax.random.fold_in(key, i), aks, qq, n), reps=3)
    out = {"equity_rollouts_per_sec": res.n / dt, "equity_rollouts": res.n,
           "equity_path": kernel_impl(), "equity_AKs_vs_QQ": res.equity}
    batch = 1 << 20
    n_chunks = max(1, n // batch)
    hero, villain = jnp.array(aks), jnp.array(qq)
    board = jnp.zeros((0,), jnp.int32)
    dt, _ = _best(lambda i: _equity_vs_hand_device(
        jax.random.fold_in(key, i), hero, villain, board, batch, n_chunks),
        reps=3)
    out["equity_xla_rollouts_per_sec"] = batch * n_chunks / dt
    return out


def betting_axis(n_tables=1 << 20, n_steps=512):
    """Random-policy perpetual 6-max tables on the packed-block engine,
    reference rules; the first deal is set-up, outside the timed region.
    The overflow latch must stay zero (no side pot silently dropped)."""
    from montecarlo_tpu.engine.state import TableConfig
    from montecarlo_tpu.ops.pallas_engine import (
        initial_packed_state, run_perpetual_prng, unpack_field,
    )

    cfg = TableConfig(num_seats=6)
    state0 = initial_packed_state(0, cfg, n_tables)
    dt, out = _best(lambda i: run_perpetual_prng(
        i, state0, cfg.num_seats, n_steps, cfg.small_blind, cfg.big_blind),
        reps=3)
    hands = int(jnp.sum(unpack_field(out, cfg, "hand_ct")))
    if int(jnp.sum(unpack_field(out, cfg, "overflow"))) or hands <= 0:
        raise AxisFailed("betting: overflow latch set or no hands")
    return {"betting_hands_per_sec": hands / dt, "betting_rules": cfg.rules,
            "betting_tables": n_tables,
            "betting_steps_per_hand": n_tables * n_steps / hands,
            "betting_ns_per_table_step": dt / (n_tables * n_steps) * 1e9}


def sweep_axis(n_per_hand=10_000_000):
    """BASELINE config 5: 169 canonical hands x 1e7 vs-random rollouts."""
    from montecarlo_tpu.parallel.mesh import equity_sweep, make_mesh
    from montecarlo_tpu.rollout.equity import canonical_hands

    heroes = jnp.array([list(cards) for _, cards in canonical_hands()],
                       jnp.int32)
    mesh = make_mesh(jax.devices()[:1])
    dt, (_, n) = _best(lambda i: equity_sweep(
        mesh, jax.random.key(5 + i), heroes, n_per_hand), reps=2)
    return {"sweep169_seconds_warm": dt, "sweep169_rollouts": 169 * n}


def net_axis(tables=1 << 18, steps=512, train_tables=1 << 14,
             train_steps=256, pop=16):
    """Net-eval hands/s and end-to-end ES-generation hands/s."""
    from montecarlo_tpu.engine.state import TableConfig
    from montecarlo_tpu.models.policy_net import load_params
    from scripts.bench_net_throughput import (
        bench_es_generation, bench_net_eval,
    )

    cfg = TableConfig(num_seats=6, rules="standard")
    params = load_params("data/policy_6max_es9.npz")
    r = bench_net_eval(cfg, params, tables, steps, reps=2)
    out = {"net_eval_hands_per_sec": r["net_eval_hands_per_sec"],
           "net_eval_tables": tables}
    r = bench_es_generation(cfg, params, train_tables, train_steps,
                            pop=pop, reps=2)
    out["train_hands_per_sec"] = r["train_hands_per_sec"]
    out["train_pop"] = r["train_pop"]
    return out


AXES = (("equity", equity_axis), ("betting", betting_axis),
        ("sweep169", sweep_axis), ("net", net_axis))


def main():
    dev = jax.devices()[0]
    out = {"metric": "equity_rollouts_per_sec", "unit": "rollouts/s",
           "device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())}}
    failed = []
    for name, fn in AXES:
        try:
            out.update(fn())
        except Exception as e:  # reported by name; the run then fails
            failed.append(name)
            print(f"bench axis {name!r} failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
    out["value"] = out.get("equity_rollouts_per_sec")
    out["failed_axes"] = failed
    print(json.dumps(out))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
