"""Seat-pinned policy-net evaluation on the whole-step engine kernel.

Runs the trained 6-max policy artifact at seat 0 against five random
seats (standard rules, independent hands from full stacks) entirely
in-kernel, and the untrained net as a baseline. Prints per-seat bb/hand
with clustered standard errors and throughput.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from montecarlo_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from montecarlo_tpu.engine.state import TableConfig  # noqa: E402
from montecarlo_tpu.models.policy_net import init_params, load_params  # noqa: E402
from montecarlo_tpu.ops.pallas_engine import selfplay_net_eval_kernel  # noqa: E402


def main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--tables", type=int, default=1 << 16)
    ap.add_argument("--steps", type=int, default=512)
    args = ap.parse_args()

    cfg = TableConfig(num_seats=6, rules="standard")
    trained = load_params("data/policy_6max_200.npz")
    untrained = init_params(jax.random.key(0))

    for name, params in [("trained", trained), ("untrained", untrained)]:
        t0 = time.perf_counter()
        means, errs, hands = selfplay_net_eval_kernel(
            11, cfg, params, net_seats=0b000001,
            n_tables=args.tables, n_steps=args.steps)
        dt = time.perf_counter() - t0
        print(json.dumps({
            "net": name, "seat0_bb_per_hand": round(means[0], 4),
            "seat0_stderr": round(errs[0], 4),
            "other_seats_mean": round(float(means[1:].mean()), 4),
            "hands": hands, "hands_per_sec": hands / dt,
            "seconds": dt,
        }), flush=True)


if __name__ == "__main__":
    main()
