"""Net-eval and ES-training throughput on the packed engine (GPU).

The full-grid net-evaluation rate and the end-to-end ES generation rate
on the population-batched engine — the two figures bench.py carries as
``net_eval_hands_per_sec`` / ``train_hands_per_sec``.

    python scripts/bench_net_throughput.py

Timing: warm first (persistent compile cache), the meters read back to
the host end each timed call, initial-state packing outside the timed
region.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from montecarlo_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from montecarlo_tpu.engine.state import TableConfig  # noqa: E402
from montecarlo_tpu.models.policy_net import load_params  # noqa: E402
from montecarlo_tpu.ops.pallas_engine import (  # noqa: E402
    initial_packed_state, selfplay_net_eval_kernel, selfplay_net_eval_pop,
)


def bench_net_eval(cfg, params, n_tables, n_steps, seed=11, reps=3):
    state0 = initial_packed_state(seed, cfg, n_tables)

    def once(s):
        t0 = time.perf_counter()
        _, _, hands = selfplay_net_eval_kernel(
            s, cfg, params, net_seats=1, n_tables=n_tables,
            n_steps=n_steps, state0=state0)
        return time.perf_counter() - t0, hands

    once(seed)  # warmup/compile
    best, hands = min(once(seed + i + 1) for i in range(reps))
    return {"net_eval_hands_per_sec": hands / best,
            "net_eval_tables": n_tables, "net_eval_steps": n_steps,
            "net_eval_hands": hands, "net_eval_seconds": best,
            "net_eval_ns_per_table_step":
                best / (n_tables * n_steps) * 1e9}


def bench_es_generation(cfg, params, n_tables, n_steps, pop=16, seed=13,
                        reps=3):
    """One ES generation = 2*pop candidates in one pop-kernel launch
    per 256-step chunk: the steady-state training rate (compiles and the
    per-seed initial state are amortized across a run — PERF.md)."""
    import numpy as np

    state0 = initial_packed_state(seed, cfg, n_tables)
    rng = np.random.default_rng(0)
    cands = []
    for _ in range(2 * pop):
        p = jax.tree.map(lambda x: x + 0.05 * rng.standard_normal(
            x.shape).astype(np.float32), params)
        cands.append(p)

    def once(s):
        t0 = time.perf_counter()
        _, _, hands = selfplay_net_eval_pop(
            s, cfg, cands, net_seats=1, n_tables=n_tables,
            n_steps=n_steps, state0=state0)
        return time.perf_counter() - t0, int(np.sum(hands))

    once(seed)  # warmup/compile
    best, hands = min(once(seed + i + 1) for i in range(reps))
    return {"train_hands_per_sec": hands / best,
            "train_pop": 2 * pop, "train_tables": n_tables,
            "train_steps": n_steps, "train_hands": hands,
            "train_seconds": best}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tables", type=int, default=1 << 20)
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--train-tables", type=int, default=1 << 14)
    ap.add_argument("--train-steps", type=int, default=256)
    ap.add_argument("--pop", type=int, default=16)
    ap.add_argument("--artifact", default="data/policy_6max_es3.npz")
    args = ap.parse_args()

    cfg = TableConfig(num_seats=6, rules="standard")
    params = load_params(args.artifact)

    out = bench_net_eval(cfg, params, args.tables, args.steps)
    print(json.dumps(out), flush=True)
    out2 = bench_es_generation(cfg, params, args.train_tables,
                               args.train_steps, pop=args.pop)
    print(json.dumps(out2), flush=True)


if __name__ == "__main__":
    main()
