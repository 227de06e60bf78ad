"""Nash-gap meter: trained artifacts vs the exact river subgame solution.

Solves the HU river subgame (models/river_solver.py — CFR+ over all
C(47,2) combos, uniform ranges, the net's own pot-raise sizes) and
measures each policy artifact's exploitability inside it: extract the
net's strategy at every decision node for every combo (the exact
feature/logit pipeline the net plays with), then compute the best
response against it. Gap = br1 + br2 - pot, in big blinds per hand of
subgame reached; the solver's own gap is the convergence control.

This converts "the net beats bots by X" into an absolute statement:
"in this solved subgame the net can be exploited for at most/at least
Y bb" — the repo's first postflop equilibrium anchor (VERDICT r3 #4).

    python scripts/river_gap.py [--iterations 6000] \
        [--subjects es3=data/policy_6max_es3.npz ...]

CPU-friendly ([1081,1081] matmuls); runs anywhere.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if not os.environ.get("RIVER_GAP_GPU"):
    jax.config.update("jax_platforms", "cpu")
from montecarlo_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402

from montecarlo_tpu.cards import make_card  # noqa: E402
from montecarlo_tpu.models.policy_net import init_params, load_params  # noqa: E402
from montecarlo_tpu.models.river_solver import (  # noqa: E402
    RiverGame, best_response_values, exploitability_gap, make_river_game,
    net_river_strategy, river_node_states, solve_cfr_plus,
    strategy_values,
)

BOARDS = {
    # dry king-high
    "Ks8h5d2cQs": [make_card(2, 13), make_card(0, 8), make_card(1, 5),
                   make_card(3, 2), make_card(2, 12)],
    # wet, paired, flushy
    "9h8h7s9dJh": [make_card(0, 9), make_card(0, 8), make_card(2, 7),
                   make_card(1, 9), make_card(0, 11)],
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=6000)
    ap.add_argument("--subjects", nargs="+", default=[
        "es3=data/policy_6max_es3.npz",
        "es2=data/policy_6max_es2.npz",
        "reinforce=data/policy_6max_200.npz",
        "hu=data/policy_hu_300.npz",
        "untrained=INIT",
    ])
    ap.add_argument("--save", default="data/river_gap.json")
    args = ap.parse_args()

    out = {"iterations": args.iterations, "boards": {}}
    for bname, board in BOARDS.items():
        t0 = time.perf_counter()
        states, sizes = river_node_states(board)
        bb = 10.0
        game, hc, vc = make_river_game(
            board, pot=sizes["pot"], bet=sizes["bet"],
            raise_=sizes["raise_"])
        nash = solve_cfr_plus(game, iterations=args.iterations)
        ev1, ev2 = strategy_values(game, nash)
        solver_gap = exploitability_gap(game, nash)
        row = {
            "sizes": sizes, "combos": len(hc),
            "solver_gap_bb": round(solver_gap / bb, 4),
            "nash_ev_p1_bb": round(ev1 / bb, 4),
            "nash_ev_p2_bb": round(ev2 / bb, 4),
            "solve_seconds": round(time.perf_counter() - t0, 1),
            "subjects": {},
        }
        print(json.dumps({"board": bname,
                          **{k: v for k, v in row.items()
                             if k != "subjects"}}), flush=True)

        for spec in args.subjects:
            name, path = spec.split("=", 1)
            params = (init_params(jax.random.key(0)) if path == "INIT"
                      else load_params(path))
            strat = net_river_strategy(params, states, hc, vc)
            br1, br2 = best_response_values(game, strat)
            gap = br1 + br2 - game.pot
            # head-to-head vs the equilibrium: the net as P1 vs Nash P2,
            # and Nash P1 vs the net as P2
            from montecarlo_tpu.models.river_solver import RiverStrategy

            net_p1 = RiverStrategy(strat.s0, nash.s1, strat.s2, nash.s3,
                                   strat.s4)
            net_p2 = RiverStrategy(nash.s0, strat.s1, nash.s2, strat.s3,
                                   nash.s4)
            evn1, _ = strategy_values(game, net_p1)
            _, evn2 = strategy_values(game, net_p2)
            srow = {
                "gap_bb": round(gap / bb, 4),
                "br_vs_net_p1_bb": round((game.pot - br2) / bb, 4),
                "br_vs_net_p2_bb": round((game.pot - br1) / bb, 4),
                "net_p1_vs_nash_bb": round(evn1 / bb, 4),
                "net_p2_vs_nash_bb": round(evn2 / bb, 4),
            }
            row["subjects"][name] = srow
            print(json.dumps({"board": bname, "subject": name, **srow}),
                  flush=True)
        out["boards"][bname] = row

    if args.save:
        with open(args.save, "w") as f:
            json.dump(out, f, indent=1)
        print(f"saved {args.save}")


if __name__ == "__main__":
    main()
