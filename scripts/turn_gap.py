"""Two-street Nash-gap meter: artifacts vs the exact TURN+RIVER solve.

Solves the HU turn+river subgame exactly (models/turn_solver.py — CFR+
across the river chance node, all C(48,2) combos x every river card,
the no-raise tree at the nets' own measured menu sizes) and measures
each policy artifact's exploitability inside it, extending the
one-street anchor (scripts/river_gap.py) across a street boundary:
turn bets change the river pot, ranges condition on the betting line,
and the river strategy is per-card.

Gap = br1 + br2 - pot in bb per subgame hand; the solver's own gap is
the convergence control.

    python scripts/turn_gap.py [--iterations 1000] \
        [--subjects es3=data/policy_6max_es3.npz ...]

CPU by default (pure XLA array work; set TURN_GAP_GPU=1 to run on the
GPU).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if not os.environ.get("TURN_GAP_GPU"):
    jax.config.update("jax_platforms", "cpu")
from montecarlo_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from montecarlo_tpu.cards import make_card  # noqa: E402
from montecarlo_tpu.models.policy_net import (  # noqa: E402
    init_params, load_params,
)
from montecarlo_tpu.models.turn_solver import (  # noqa: E402
    TurnRiverStrategy, best_response_values, exploitability_gap,
    make_turn_river_game, net_turn_river_strategy, solve_turn_river,
    strategy_values, turn_river_node_states,
)

BOARDS = {
    # dry king-high (the river_gap board minus its river)
    "Ks8h5d2c": [make_card(2, 13), make_card(0, 8), make_card(1, 5),
                 make_card(3, 2)],
    # wet, paired, flushy
    "9h8h7s9d": [make_card(0, 9), make_card(0, 8), make_card(2, 7),
                 make_card(1, 9)],
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=1000)
    ap.add_argument("--boards", nargs="+", default=list(BOARDS))
    ap.add_argument("--subjects", nargs="+", default=[
        "es3=data/policy_6max_es3.npz",
        "es2=data/policy_6max_es2.npz",
        "reinforce=data/policy_6max_200.npz",
        "hu=data/policy_hu_300.npz",
        "untrained=INIT",
    ])
    ap.add_argument("--save", default="data/turn_gap.json")
    ap.add_argument("--combo-stride", type=int, default=1,
                    help="subsample the 1081-combo range (the solve is "
                         "O(C^2) per river; the post-rebuild 1-core "
                         "host needs stride>=2 — gaps are then "
                         "measured inside the strided-range game and "
                         "comparable only to same-stride runs)")
    args = ap.parse_args()

    bb = 10.0
    out = {"iterations": args.iterations,
           "combo_stride": args.combo_stride, "boards": {}}

    def save():
        if args.save:
            with open(args.save, "w") as f:
                json.dump(out, f, indent=1)

    for bname in args.boards:
        board4 = BOARDS[bname]
        t0 = time.perf_counter()
        turn_states, river_states, sizes = turn_river_node_states(
            board4, rivers=[c for c in range(52)
                            if c not in [int(x) for x in board4]])
        from montecarlo_tpu.models.turn_solver import turn_combos
        sub = (turn_combos(board4)[::args.combo_stride]
               if args.combo_stride > 1 else None)
        game, combos = make_turn_river_game(
            board4, combos=sub, pot=sizes["pot"], bet=sizes["bet"],
            river_bets=sizes["river_bets"],
            turn_raise=False, river_raise=False)
        nash = solve_turn_river(
            game, iterations=args.iterations, progress_every=200,
            log=lambda d: print(json.dumps({"board": bname, **d}),
                                flush=True))
        ev1, ev2 = strategy_values(game, nash)
        solver_gap = exploitability_gap(game, nash)
        row = {
            "sizes": sizes, "combos": int(len(combos)),
            "rivers": int(game.keys.shape[0]),
            "solver_gap_bb": round(solver_gap / bb, 4),
            "nash_ev_p1_bb": round(ev1 / bb, 4),
            "nash_ev_p2_bb": round(ev2 / bb, 4),
            "solve_seconds": round(time.perf_counter() - t0, 1),
            "subjects": {},
        }
        out["boards"][bname] = row
        print(json.dumps({"board": bname,
                          **{k: v for k, v in row.items()
                             if k != "subjects"}}), flush=True)
        save()

        for spec in args.subjects:
            name, path = spec.split("=", 1)
            params = (init_params(jax.random.key(0)) if path == "INIT"
                      else load_params(path))
            t1 = time.perf_counter()
            strat = net_turn_river_strategy(params, turn_states,
                                            river_states, combos)
            br1, br2 = best_response_values(game, strat)
            gap = br1 + br2 - game.pot
            # head-to-head vs the equilibrium (net on one side only)
            net_p1 = TurnRiverStrategy(
                strat.t0, nash.t1, strat.t2, nash.t3, strat.t4,
                strat.s0, nash.s1, strat.s2, nash.s3, strat.s4)
            net_p2 = TurnRiverStrategy(
                nash.t0, strat.t1, nash.t2, strat.t3, nash.t4,
                nash.s0, strat.s1, nash.s2, strat.s3, nash.s4)
            evn1, _ = strategy_values(game, net_p1)
            _, evn2 = strategy_values(game, net_p2)
            srow = {
                "gap_bb": round(gap / bb, 4),
                "br_vs_net_p1_bb": round((game.pot - br2) / bb, 4),
                "br_vs_net_p2_bb": round((game.pot - br1) / bb, 4),
                "net_p1_vs_nash_bb": round(evn1 / bb, 4),
                "net_p2_vs_nash_bb": round(evn2 / bb, 4),
                "eval_seconds": round(time.perf_counter() - t1, 1),
            }
            row["subjects"][name] = srow
            print(json.dumps({"board": bname, "subject": name, **srow}),
                  flush=True)
            save()

    if args.save:
        print(f"saved {args.save}")


if __name__ == "__main__":
    main()
