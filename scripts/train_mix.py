"""Gradient hardening vs a MIXED opponent pool (min-slack selection).

The round-4 HU hardening attempts with pool-ES (output-layer kicks,
sigma 0.4) never beat the start center on holdout — the fof_raise hole
(bot extracts 0.12 bb/hand from policy_hu_300) sits below the ES noise
floor at affordable eval sizes, so the population ranking collapses
(spread_bb 0.0) and the noise-floor guard zeroes every update. This
script attacks the same goal with per-hand gradient signal instead:
REINFORCE updates (models/train.py) CYCLE through the opponent pool
(one compiled update per opponent), so the subject is trained
simultaneously against the hole (bot:fof_raise), its own frozen start
('self' — the self-play anchor), and 'random' (the vs-random edge).

Holdout selection is MIN-SLACK: every --eval-every updates the
candidate is league-evaluated (fixed seed, winner's-curse guard) vs
each pool entry and scored min_i(edge_i - floor_i); floors encode the
anchors ('bot:fof_raise%0' = don't lose to the bot, 'self%-0.03' =
keep the self-play tie, 'random%1.8' = keep the vs-random edge).
Maximizing the min pushes the binding constraint — initially the bot
hole — without trading away an anchor.

Reference purpose this serves: "test AIs" (the reference's README.md:9)
— the artifact under test must survive its own probe panel
(scripts/exploit_probe.py) after hardening.

    python scripts/train_mix.py \
        --seats 2 --start data/policy_hu_300.npz \
        --opponents 'bot:fof_raise%0,self%-0.03,random%1.8' \
        --updates 300 --save data/policy_hu_mix.npz
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

import numpy as np  # noqa: E402

from montecarlo_tpu.engine.state import TableConfig  # noqa: E402
from montecarlo_tpu.models.policy_net import (  # noqa: E402
    init_params, load_params, net_policy, save_params,
)
from montecarlo_tpu.models.train import (  # noqa: E402
    make_update_step, random_policy,
)
from montecarlo_tpu.ops.pallas_engine import (  # noqa: E402
    selfplay_net_eval_kernel, selfplay_net_league,
)


def parse_pool(spec_csv, start_params):
    """'spec[%floor],...' -> [(name, params_or_None, floor)].

    params None = random seats (kernel PRNG policy in evals,
    models.train.random_policy in updates). 'self' = a frozen copy of
    the start params (the self-play anchor). Other specs go through
    train_es_kernel.resolve_opponent ('bot:NAME', 'optbot:...', path).
    """
    from scripts.train_es_kernel import resolve_opponent
    pool = []
    for item in spec_csv.split(","):
        item = item.strip()
        floor = 0.0
        if "%" in item:
            item, f = item.rsplit("%", 1)
            floor = float(f)
        if item == "self":
            pool.append(("self", start_params, floor))
        else:
            tag, params, _geom = resolve_opponent(item)
            pool.append((tag, params, floor))
    return pool


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seats", type=int, default=2)
    ap.add_argument("--start", default="data/policy_hu_300.npz")
    ap.add_argument("--opponents",
                    default="bot:fof_raise%0,self%-0.03,random%1.8")
    ap.add_argument("--updates", type=int, default=300)
    ap.add_argument("--tables", type=int, default=8192)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--max-steps", type=int, default=48)
    ap.add_argument("--seed", type=int, default=59)
    ap.add_argument("--eval-every", type=int, default=25)
    ap.add_argument("--eval-tables", type=int, default=1 << 16)
    ap.add_argument("--save", default="data/policy_hu_mix.npz")
    ap.add_argument("--resume", action="store_true",
                    help="continue from --save + its .progress.json "
                         "(same pattern as train_es_kernel --resume)")
    ap.add_argument("--soften", type=float, default=0.0,
                    help="divide the START's w3,b3 by K before training "
                    "(argmax-preserving margin shrink). The leak-anatomy "
                    "diagnostic (PERF.md) measured hu300 behaviorally "
                    "FROZEN: margins p50=15.4, P(non-argmax)=1.5e-6, so "
                    "REINFORCE has no exploration signal. K=8 restores "
                    "~22%% exploration. The 'self' anchor stays the "
                    "ORIGINAL hard params.")
    args = ap.parse_args()

    cfg = TableConfig(num_seats=args.seats, rules="standard",
                      max_layers=8, max_pot_layers=16)
    cfg_eval = TableConfig(num_seats=args.seats, rules="standard")

    start = (init_params(jax.random.key(args.seed))
             if args.start == "INIT" else load_params(args.start))
    pool = parse_pool(args.opponents, start)  # 'self' = ORIGINAL params
    if args.soften > 1.0:
        start = start._replace(w3=start.w3 / args.soften,
                               b3=start.b3 / args.soften)
        print(json.dumps({"softened": args.soften}), flush=True)

    def eval_vs(p, opp, seed, n_tables):
        """net p alone at seat 0 vs P-1 copies of opp -> (bb, se)."""
        P = cfg_eval.num_seats
        if opp is None:
            m, e, _ = selfplay_net_eval_kernel(
                seed, cfg_eval, p, net_seats=1, n_tables=n_tables,
                n_steps=256)
        else:
            m, e, _ = selfplay_net_league(
                seed, cfg_eval, [p, opp], (0,) + (1,) * (P - 1),
                n_tables=n_tables, n_steps=256)
        return float(m[0]), float(e[0])

    def score(p, seed, n_tables):
        per = {}
        slack = np.inf
        for name, opp, floor in pool:
            bb, se = eval_vs(p, opp, seed, n_tables)
            per[name] = (bb, se)
            slack = min(slack, bb - floor)
        return slack, per

    # one compiled update per pool entry; adam state is shared (same
    # optimizer/pytree shapes), so momentum carries across opponents
    updates = []
    opt_init = None
    for name, opp, _floor in pool:
        policy = random_policy if opp is None else net_policy(opp)
        opt_init, upd = make_update_step(
            cfg, opponent=policy, tables=args.tables, lr=args.lr,
            max_steps=args.max_steps)
        updates.append((name, upd))

    side = args.save + ".progress.json" if args.save else ""
    done = 0
    params = start
    if args.resume and args.save and os.path.exists(args.save) \
            and side and os.path.exists(side):
        with open(side) as f:
            done = json.load(f).get("updates_done", 0)
        params = load_params(args.save)
        print(json.dumps({"resumed_at": done}), flush=True)

    opt_state = opt_init(params)
    key = jax.random.key(args.seed)
    t0 = time.perf_counter()

    HOLDOUT = 777
    best_slack, best_params = -np.inf, params
    s0, per0 = score(start, HOLDOUT, args.eval_tables)
    print(json.dumps({"start_slack_bb": round(s0, 4),
                      **{f"start_{n}": round(v[0], 4)
                         for n, v in per0.items()}}), flush=True)
    best_slack, best_params = s0, start

    for i in range(done, args.updates):
        name, upd = updates[i % len(updates)]
        params, opt_state, mean_r = upd(
            params, opt_state, jax.random.fold_in(key, 1000 + i))
        if (i + 1) % 10 == 0:
            print(json.dumps({
                "update": i + 1, "opp": name,
                "train_bb": round(float(mean_r), 4),
                "elapsed_s": round(time.perf_counter() - t0, 1)}),
                flush=True)
        if (i + 1) % args.eval_every == 0 or i == args.updates - 1:
            slack, per = score(params, HOLDOUT, args.eval_tables)
            print(json.dumps({
                "update": i + 1, "holdout_slack_bb": round(slack, 4),
                **{f"holdout_{n}": round(v[0], 4)
                   for n, v in per.items()}}), flush=True)
            if slack > best_slack:
                best_slack, best_params = slack, params
                if args.save:
                    save_params(args.save, params)
            if side:
                with open(side, "w") as f:
                    json.dump({"updates_done": i + 1,
                               "best_slack": round(best_slack, 4)}, f)

    # honest final number: best-by-holdout params, fresh seed, big eval
    slack, per = score(best_params, 991, args.eval_tables * 2)
    out = {"start": args.start, "opponents": args.opponents,
           "final_slack_bb": round(slack, 4),
           "per_opponent": {n: {"bb": round(v[0], 4),
                                "stderr": round(v[1], 4)}
                            for n, v in per.items()},
           "updates": args.updates, "tables": args.tables,
           "train_seconds": round(time.perf_counter() - t0, 1),
           "improved_over_start": bool(best_slack > s0)}
    print(json.dumps(out), flush=True)
    if args.save:
        save_params(args.save, best_params)
        with open(args.save + ".result.json", "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
