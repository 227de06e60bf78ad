"""Learned best response: REINFORCE exploiter vs a FROZEN artifact.

The round-3 league-fitness ES null ("no exploit of es2 at this budget")
was a false negative — a one-line rule bot extracted 0.63 bb/hand. This
script attacks frozen artifacts with the full-power gradient machinery
instead: the learner plays every position (rotating across the batch)
against N-1 copies of the frozen net (models/train.py REINFORCE — the
opponent slot takes any policy, here ``net_policy(frozen)``), then the
trained exploiter's edge is measured honestly on the league kernel
(seat 0 vs five frozen copies, button rotating, fresh seed, CI) — the
same geometry as the probe panel, so the numbers compose into
max(panel, bot-optimizer, learned-BR) per artifact.

    python scripts/train_br.py \
        --opponent es3=data/policy_6max_es3.npz [--updates 300]
        [--tables 4096] [--save data/br_vs_es3.npz]

GPU (the XLA training pipeline + the packed league engine for evals).
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
from montecarlo_tpu.models.train import make_update_step  # noqa: E402
from montecarlo_tpu.ops.pallas_engine import selfplay_net_league  # noqa: E402


def league_eval(cfg, cand, frozen, seed=991, n_tables=1 << 16,
                n_steps=512):
    stb = (0,) + (1,) * (cfg.num_seats - 1)
    m, e, h = selfplay_net_league(seed, cfg, [cand, frozen], stb,
                                  n_tables=n_tables, n_steps=n_steps)
    return float(m[0]), float(e[0]), int(h)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--opponent", default="es3=data/policy_6max_es3.npz",
                    help="name=artifact.npz (frozen)")
    ap.add_argument("--updates", type=int, default=300)
    ap.add_argument("--tables", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--max-steps", type=int, default=72)
    ap.add_argument("--seats", type=int, default=6)
    ap.add_argument("--seed", type=int, default=41)
    ap.add_argument("--start", default="data/policy_6max_200.npz",
                    help="learner init: artifact path, 'INIT' (random), "
                         "or 'optbot:PATH.json:SUBJECT[:T-M-B]' (CMA "
                         "attacker warm start)")
    ap.add_argument("--soften", type=float, default=1.0,
                    help="divide the start's output layer by this "
                         "(rule-bot warm starts are near-deterministic; "
                         "REINFORCE needs sampling entropy to see a "
                         "gradient)")
    ap.add_argument("--save", default="data/br_vs_es3.npz")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--eval-every", type=int, default=50)
    args = ap.parse_args()

    name, path = args.opponent.split("=", 1)
    frozen = load_params(path)
    cfg = TableConfig(num_seats=args.seats, rules="standard",
                      max_layers=8, max_pot_layers=16)
    cfg_eval = TableConfig(num_seats=args.seats, rules="standard")

    side = args.save + ".progress.json" if args.save else ""
    done = 0
    if args.resume and args.save and os.path.exists(args.save) \
            and side and os.path.exists(side):
        with open(side) as f:
            done = json.load(f).get("updates_done", 0)
        params = load_params(args.save)
        print(json.dumps({"resumed_at": done}), flush=True)
    elif args.start == "INIT":
        params = init_params(jax.random.key(args.seed))
    elif args.start.startswith("optbot:"):
        # Warm-start from the CMA-discovered attacker (packed rule bot,
        # scripts/opt_bot.py): REINFORCE then ascends from an already
        # ~1.2 bb/hand exploit instead of the flat pretrained start the
        # round-4 first run showed going nowhere (+0.01 bb after 300
        # updates). The spec reuses train_es_kernel's resolver.
        from scripts.train_es_kernel import resolve_opponent
        _, params, _ = resolve_opponent(args.start)
    else:
        params = load_params(args.start)
    if args.soften != 1.0:
        import jax.numpy as jnp
        params = params._replace(w3=params.w3 / args.soften,
                                 b3=jnp.asarray(params.b3) / args.soften)

    opt_init, update = make_update_step(
        cfg, opponent=net_policy(frozen), tables=args.tables,
        lr=args.lr, max_steps=args.max_steps)
    opt_state = opt_init(params)

    t0 = time.perf_counter()
    key = jax.random.key(args.seed)
    best_eval, best_params = -np.inf, params
    for i in range(done, args.updates):
        params, opt_state, mean_r = update(
            params, opt_state, jax.random.fold_in(key, 1000 + i))
        if (i + 1) % 10 == 0:
            print(json.dumps({
                "update": i + 1, "train_bb": round(float(mean_r), 4),
                "elapsed_s": round(time.perf_counter() - t0, 1)}),
                flush=True)
        if args.save and ((i + 1) % args.eval_every == 0
                          or i == args.updates - 1):
            # holdout league eval on a FIXED seed (winner's-curse guard)
            bb, se, _ = league_eval(cfg_eval, params, frozen, seed=777)
            print(json.dumps({"update": i + 1,
                              "holdout_league_bb": round(bb, 4),
                              "stderr": round(se, 4)}), flush=True)
            if bb > best_eval:
                best_eval = bb
                best_params = params
                save_params(args.save, params)
            with open(side, "w") as f:
                json.dump({"updates_done": i + 1,
                           "best_eval": best_eval}, f)

    # honest final number: best-by-holdout params, fresh seed, big eval
    bb, se, h = league_eval(cfg_eval, best_params, frozen, seed=991)
    out = {"opponent": name, "artifact": path,
           "learned_br_bb_per_hand": round(bb, 4),
           "stderr": round(se, 4), "hands": h,
           "updates": args.updates, "tables": args.tables,
           "train_seconds": round(time.perf_counter() - t0, 1)}
    print(json.dumps(out), flush=True)
    if args.save:
        with open(args.save + ".result.json", "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
