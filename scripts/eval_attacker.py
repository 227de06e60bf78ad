"""Full-game evaluation of a NET attacker vs a subject artifact.

Same quantity and geometry as the other exploitability families
(scripts/exploitability_report.py): attacker bb/hand at seat 0, button
rotating, vs P-1 copies of the subject, fresh evaluation seed, on the
B-bank league kernel. Used for the solver-BR family (verdict r4 #7):
an attacker net distilled from the exact subgame best response
(scripts/distill_nash.py --mode br) — machinery independent of both the
CMA rule family and the REINFORCE exploiter.

Run on the GPU:
    python scripts/eval_attacker.py \
        --attacker data/br_solver_vs_es7.npz \
        --subject es7=data/policy_6max_es7.npz \
        --family solver_br --save data/solver_br_vs_es7.result.json
"""

import argparse
import json
import time

from montecarlo_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402

from montecarlo_tpu.engine.state import TableConfig  # noqa: E402
from montecarlo_tpu.models.policy_net import load_params  # noqa: E402
from montecarlo_tpu.ops.pallas_engine import (  # noqa: E402
    initial_packed_state, selfplay_net_league,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--attacker", required=True, help="attacker .npz")
    ap.add_argument("--subject", required=True, help="name=artifact.npz")
    ap.add_argument("--family", default="solver_br")
    ap.add_argument("--tables", type=int, default=1 << 16)
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--seed", type=int, default=733)
    ap.add_argument("--seats", type=int, default=6)
    ap.add_argument("--save", required=True)
    args = ap.parse_args()

    name, path = args.subject.split("=", 1)
    cfg = TableConfig(num_seats=args.seats, rules="standard")
    P = cfg.num_seats
    attacker = load_params(args.attacker)
    subject = load_params(path)

    t0 = time.perf_counter()
    state0 = initial_packed_state(args.seed, cfg, args.tables)
    m, e, h = selfplay_net_league(
        args.seed, cfg, [attacker, subject], (0,) + (1,) * (P - 1),
        n_tables=args.tables, n_steps=args.steps, state0=state0)
    out = {
        "opponent": name, "artifact": path,
        "attacker_artifact": args.attacker, "family": args.family,
        f"{args.family}_bb_per_hand": round(float(m[0]), 4),
        "stderr": round(float(e[0]), 4),
        "subject_seats_mean_bb": round(float(np.mean(m[1:])), 4),
        "hands": int(h), "tables": args.tables, "steps": args.steps,
        "seed": args.seed, "rules": cfg.rules,
        "elapsed_s": round(time.perf_counter() - t0, 1),
    }
    print(json.dumps(out), flush=True)
    with open(args.save, "w") as f:
        json.dump(out, f, indent=1)
    print(f"saved {args.save}")


if __name__ == "__main__":
    main()
