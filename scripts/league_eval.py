"""Net-vs-net head-to-head on the packed league engine (GPU).

    python scripts/league_eval.py [--a data/policy_6max_es2.npz]
        [--b data/policy_6max_200.npz] [--tables 65536] [--steps 512]

Seats alternate A,B,A,B,... — the button rotates so each net cycles
through every position; per-seat bb/hand (in-kernel meters) gives the
paired comparison. Also self-checks the banked kernel: a league whose
P banks are all the same artifact must reproduce the single-net kernel
(net_seats = all) EXACTLY — same PRNG stream, one-hot bank selection.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from montecarlo_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from montecarlo_tpu.engine.state import TableConfig  # noqa: E402
from montecarlo_tpu.models.policy_net import load_params  # noqa: E402
from montecarlo_tpu.ops.pallas_engine import (  # noqa: E402
    initial_packed_state, selfplay_net_eval_kernel, selfplay_net_league,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--a", default="data/policy_6max_es2.npz")
    ap.add_argument("--b", default="data/policy_6max_200.npz")
    ap.add_argument("--tables", type=int, default=1 << 16)
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--seed", type=int, default=2718)
    ap.add_argument("--skip-selfcheck", action="store_true")
    args = ap.parse_args()

    cfg = TableConfig(num_seats=6, rules="standard")
    P = cfg.num_seats
    pa = load_params(args.a)
    pb = load_params(args.b)

    parity = tuple(k % 2 for k in range(P))
    if not args.skip_selfcheck:
        n_t, n_s = 4096, 256
        state0 = initial_packed_state(args.seed, cfg, n_t)
        m1, _, h1 = selfplay_net_eval_kernel(
            args.seed, cfg, pb, net_seats=(1 << P) - 1, n_tables=n_t,
            n_steps=n_s, state0=state0)
        m2, _, h2 = selfplay_net_league(
            args.seed, cfg, [pb, pb], parity, n_tables=n_t, n_steps=n_s,
            state0=state0)
        exact = bool(np.all(m1 == m2) and h1 == h2)
        print(json.dumps({"selfcheck_exact": exact,
                          "hands": [h1, h2]}), flush=True)
        if not exact:
            sys.exit(1)

    m, e, h = selfplay_net_league(args.seed + 1, cfg, [pa, pb], parity,
                                  n_tables=args.tables,
                                  n_steps=args.steps)
    a_seats = [k for k in range(P) if k % 2 == 0]
    b_seats = [k for k in range(P) if k % 2 == 1]
    a_bb = float(np.mean([m[k] for k in a_seats]))
    b_bb = float(np.mean([m[k] for k in b_seats]))
    a_err = float(np.sqrt(np.mean([e[k] ** 2 for k in a_seats])
                          / len(a_seats)))
    b_err = float(np.sqrt(np.mean([e[k] ** 2 for k in b_seats])
                          / len(b_seats)))
    print(json.dumps({
        "per_seat_bb_per_hand": [round(float(x), 4) for x in m],
        "per_seat_stderr": [round(float(x), 4) for x in e],
        "hands": h,
        "A": args.a, "B": args.b,
        "A_mean_bb": round(a_bb, 4), "A_stderr": round(a_err, 4),
        "B_mean_bb": round(b_bb, 4), "B_stderr": round(b_err, 4),
        "edge_A_minus_B": round(a_bb - b_bb, 4),
    }), flush=True)


if __name__ == "__main__":
    main()
