"""Distill exact-subgame solver strategies into a policy-net artifact.

Two modes (models/distill.py — round-4 verdict #7/#8 machinery):

- ``--mode nash``: imitate the CFR+ equilibrium of the anchored
  turn+river subgames (the turn_gap boards). The output is an init for
  pool ES whose two-street play starts at the solver's equilibrium —
  the first training lever that injects absolute ground truth instead
  of relative fitness (verdict #8).

- ``--mode br --subject <artifact>``: imitate the exact best response
  to a SUBJECT artifact inside the solved subgames — a third,
  structurally independent attacker family for the exploitability
  summary (verdict #7). Evaluate the saved net vs the subject on the
  league kernel (scripts/league_eval.py) for the full-game number.

Both modes anchor early-street behavior to the --start artifact's own
play at the scripted preflop/flop prelude nodes, and re-measure the
anchored-subgame Nash gap (the scripts/turn_gap.py metric) before and
after distillation as the built-in success check.

CPU by default — pure [N, 24] x MLP supervised learning (set
DISTILL_GPU=1 to run on the GPU).

    python scripts/distill_nash.py --mode nash \
        --start data/policy_6max_es7.npz --save data/policy_6max_distill.npz
    python scripts/distill_nash.py --mode br \
        --subject data/policy_6max_es7.npz --start data/policy_6max_es7.npz \
        --save data/br_solver_vs_es7.npz
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if not os.environ.get("DISTILL_GPU"):
    jax.config.update("jax_platforms", "cpu")
from montecarlo_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402

from montecarlo_tpu.cards import make_card  # noqa: E402
from montecarlo_tpu.models.distill import (  # noqa: E402
    prelude_examples, stack_examples, distill, turn_river_examples,
)
from montecarlo_tpu.models.policy_net import (  # noqa: E402
    init_params, load_params, save_params,
)
from montecarlo_tpu.models.turn_solver import (  # noqa: E402
    best_response_strategy, best_response_values, exploitability_gap,
    make_turn_river_game, mix_strategies, net_turn_river_strategy,
    solve_turn_river, strategy_values, turn_river_node_states,
)

BOARDS = {
    # the turn_gap anchor boards (dry king-high; wet paired flushy)
    "Ks8h5d2c": [make_card(2, 13), make_card(0, 8), make_card(1, 5),
                 make_card(3, 2)],
    "9h8h7s9d": [make_card(0, 9), make_card(0, 8), make_card(2, 7),
                 make_card(1, 9)],
}
BB = 10.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["nash", "br"], default="nash")
    ap.add_argument("--subject", default=None,
                    help="artifact to best-respond to (br mode)")
    ap.add_argument("--start", default="INIT",
                    help="init params + early-street anchor source")
    ap.add_argument("--boards", nargs="+", default=list(BOARDS))
    ap.add_argument("--iterations", type=int, default=2000)
    ap.add_argument("--progress-every", type=int, default=200)
    ap.add_argument("--combo-stride", type=int, default=1,
                    help="subsample the 1081-combo hero/villain range "
                         "by this stride. The solve is O(C^2) per "
                         "river; the post-rebuild 1-core host needs "
                         "stride>=4 to finish in minutes. Targets "
                         "become the equilibrium of the strided-range "
                         "game — a fine abstraction, standard for "
                         "distillation-quality targets.")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--anchor-weight", type=float, default=1.0)
    ap.add_argument("--l2-init", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", required=True)
    args = ap.parse_args()
    assert args.mode != "br" or args.subject, "--mode br needs --subject"

    params0 = (init_params(jax.random.key(0)) if args.start == "INIT"
               else load_params(args.start))
    subject = load_params(args.subject) if args.subject else None

    per_board = {}   # board -> (game, combos, turn_states, river_states)
    data_sets, anchor_sets = [], []
    t0 = time.perf_counter()
    def mark(stage):
        print(json.dumps({"stage": stage,
                          "elapsed_s": round(time.perf_counter() - t0, 1)}),
              flush=True)

    for bname in args.boards:
        board4 = BOARDS[bname]
        turn_states, river_states, sizes, prelude = turn_river_node_states(
            board4, rivers=[c for c in range(52)
                            if c not in [int(x) for x in board4]],
            with_prelude=True)
        mark(f"{bname}: node states")
        from montecarlo_tpu.models.turn_solver import turn_combos
        sub = (turn_combos(board4)[::args.combo_stride]
               if args.combo_stride > 1 else None)
        game, combos = make_turn_river_game(
            board4, combos=sub, pot=sizes["pot"], bet=sizes["bet"],
            river_bets=sizes["river_bets"],
            turn_raise=False, river_raise=False)
        mark(f"{bname}: game built")
        per_board[bname] = (game, combos, turn_states, river_states)

        if args.mode == "nash":
            targets = solve_turn_river(
                game, iterations=args.iterations,
                progress_every=args.progress_every,
                log=lambda d: print(json.dumps({"board": bname, **d}),
                                    flush=True))
            prof_p1 = prof_p2 = targets
            per_board[bname] += (targets,)
        else:
            sub_strat = net_turn_river_strategy(
                subject, turn_states, river_states, combos)
            targets = best_response_strategy(game, sub_strat)
            # training mass where the attacker-vs-subject matchup plays
            prof_p1 = mix_strategies(targets, sub_strat)
            prof_p2 = mix_strategies(sub_strat, targets)
            per_board[bname] += (targets, sub_strat)

        mark(f"{bname}: targets ready")
        sets = turn_river_examples(game, combos, turn_states,
                                   river_states, targets, prof_p1,
                                   prof_p2)
        mark(f"{bname}: examples assembled")
        # street balance: the ~600k river rows must not drown the 4.5k
        # turn rows — equalize total street mass per board
        wt = sum(float(np.asarray(s.weight).sum()) for s in sets[:4])
        wr = sum(float(np.asarray(s.weight).sum()) for s in sets[4:])
        sets = [s._replace(weight=s.weight * (wr / max(wt, 1e-9)))
                if i < 4 else s for i, s in enumerate(sets)]
        data_sets += sets
        anchor_sets += prelude_examples(params0, prelude, combos)
        print(json.dumps({"board": bname, "examples_built": True,
                          "elapsed_s": round(time.perf_counter() - t0, 1)}),
              flush=True)

    data = stack_examples(data_sets)
    anchor = stack_examples(anchor_sets)
    print(json.dumps({"dataset_rows": int(data.feats.shape[0]),
                      "anchor_rows": int(anchor.feats.shape[0])}),
          flush=True)

    params = distill(params0, data, anchor=anchor, steps=args.steps,
                     batch=args.batch, lr=args.lr,
                     anchor_weight=args.anchor_weight,
                     l2_init=args.l2_init, seed=args.seed,
                     log=lambda d: print(json.dumps(d), flush=True))
    save_params(args.save, params)

    # ---- built-in success check: anchored-subgame metrics ----
    result = {"mode": args.mode, "start": args.start,
              "subject": args.subject, "iterations": args.iterations,
              "steps": args.steps, "dataset_rows": int(data.feats.shape[0]),
              "boards": {}}
    for bname, entry in per_board.items():
        game, combos, turn_states, river_states = entry[:4]
        strat_new = net_turn_river_strategy(params, turn_states,
                                            river_states, combos)
        strat_old = net_turn_river_strategy(params0, turn_states,
                                            river_states, combos)
        row = {}
        if args.mode == "nash":
            row["gap_bb_start"] = round(
                exploitability_gap(game, strat_old) / BB, 4)
            row["gap_bb_distilled"] = round(
                exploitability_gap(game, strat_new) / BB, 4)
            nash = entry[4]
            row["gap_bb_solver"] = round(
                exploitability_gap(game, nash) / BB, 4)
        else:
            br, sub_strat = entry[4], entry[5]
            br1, _ = best_response_values(game, sub_strat)
            ev_exact = br1 - game.pot / 2.0
            ev_new, _ = strategy_values(
                game, mix_strategies(strat_new, sub_strat))
            ev_old, _ = strategy_values(
                game, mix_strategies(strat_old, sub_strat))
            row["exact_br_edge_bb"] = round(ev_exact / BB, 4)
            row["distilled_edge_bb"] = round(
                (ev_new - game.pot / 2.0) / BB, 4)
            row["start_edge_bb"] = round(
                (ev_old - game.pot / 2.0) / BB, 4)
            row["captured_frac"] = round(
                (ev_new - game.pot / 2.0) / max(ev_exact, 1e-9), 4)
        result["boards"][bname] = row
        print(json.dumps({"board": bname, **row}), flush=True)

    result["elapsed_s"] = round(time.perf_counter() - t0, 1)
    with open(args.save + ".result.json", "w") as f:
        json.dump(result, f, indent=1)
    print(f"saved {args.save} (+.result.json)")


if __name__ == "__main__":
    main()
