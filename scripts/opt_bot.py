"""Adaptive rule-bot exploitability: CMA-ES over the linear-bot family.

The round-3 panel probe (scripts/exploit_probe.py) measures what 8
FIXED hand-written bots extract from a trained artifact — a provably
weak attacker class (league-fitness ES certified es2 "clean" while the
hand-written jam_loose took +0.63 bb/hand; PERF.md). This script makes
the attacker ADAPTIVE: CMA-ES (models/cma.py) searches the continuous
rule families — ``vector_bot(score_vec[20], threshold, hi, lo)`` (every
linear decision rule over the policy features, per discrete (hi, lo)
action pair, 21 dims) and ``ladder_bot(score1, t1, score2, t2,
top, mid, bot)`` (three-way "raise strong / call medium / fold weak"
ladders, per discrete action triple, 42 dims) — maximizing the bot's
seat-0 bb/hand against five copies of the subject net (the B-bank
league kernel's probe geometry, one population launch per CMA
generation). A ``--pairs`` entry with two fields (``3:0``) selects the
linear family; three fields (``3:1:0``) selects the ladder family.

Protocol (winner's-curse-safe, per PERF.md): per-generation fitness uses
a fresh seed (common random numbers across candidates by kernel
construction); the running answer is the CMA mean evaluated on a FIXED
holdout seed every ``--holdout-every`` generations; the reported number
is a large fresh-seed evaluation of the best-by-holdout bot, with CI.

    python scripts/opt_bot.py \
        --subjects es3=data/policy_6max_es3.npz [--pairs 3:0,3:1,1:0,2:0]

Reference tie-in: the subject nets and the bots both drive the engine
whose hot loop is ``board.clj:122-138``/``gameplay.clj:122-150``; the
probe itself is rebuild-added AI-testing machinery (README.md:9).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from montecarlo_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402

from montecarlo_tpu.engine.state import TableConfig  # noqa: E402
from montecarlo_tpu.models.bots import (  # noqa: E402
    _HOLE, ladder_bot, vector_bot,
)
from montecarlo_tpu.models.cma import CMAES  # noqa: E402
from montecarlo_tpu.models.features import NUM_FEATURES  # noqa: E402
from montecarlo_tpu.models.policy_net import load_params  # noqa: E402
from montecarlo_tpu.ops.pallas_engine import (  # noqa: E402
    initial_packed_state, selfplay_net_league, selfplay_net_league_pop,
)

HOLDOUT = 777
FINAL_SEED = 991

# jam_loose's hole-strength score as a warm start for jam-family pairs
# (models/bots.py _HOLE): indices 16/17 hole ranks, 19 paired, 18 suited.
_HOLE_VEC = np.zeros(NUM_FEATURES, np.float32)
for _i, _w in _HOLE.items():
    _HOLE_VEC[_i] = _w
_JAM_X0 = np.concatenate([_HOLE_VEC, [0.85]])  # [score, threshold]
# nit_ladder-style warm start for ladder triples: hole score for both
# rules, thresholds 1.15 (top) / 0.95 (mid).
_LADDER_X0 = np.concatenate([_HOLE_VEC, [1.15], _HOLE_VEC, [0.95]])


def spec_dim(acts) -> int:
    """Search-space dimension: linear pair 21, ladder triple 42."""
    return (NUM_FEATURES + 1) * (len(acts) - 1)


def _norm_rule(v, t):
    """Scale (score, threshold) jointly into ladder_bot's bf16-safe range
    (|slope*(s-t)| <= 32 for |features| <= 2 — bots.py docstring). The
    decision s > t is scale-invariant; only the mixing band widens, and
    CMA controls the weight scale so it can trade band for range."""
    c = max(1.0, (2.0 * float(np.abs(v).sum()) + abs(t)) / 4.0)
    return v / c, t / c


def make_bot(x, acts):
    x = np.asarray(x, np.float32)
    n_rules = len(acts) - 1
    old_nf = len(x) // n_rules - 1
    if old_nf < NUM_FEATURES:
        # Saved attacker from an older (shorter) feature set: pad each
        # rule's score vector with zeros — features are only appended
        # (models/features.py), so the rule is unchanged.
        assert len(x) == n_rules * (old_nf + 1), (len(x), acts)
        rules = x.reshape(n_rules, old_nf + 1)
        pad = np.zeros((n_rules, NUM_FEATURES - old_nf), np.float32)
        x = np.concatenate(
            [rules[:, :old_nf], pad, rules[:, old_nf:]], axis=1).reshape(-1)
    if len(acts) == 2:
        return vector_bot(x[:NUM_FEATURES], float(x[NUM_FEATURES]),
                          acts[0], acts[1])
    k = NUM_FEATURES + 1
    v1, t1 = _norm_rule(x[:NUM_FEATURES], float(x[NUM_FEATURES]))
    v2, t2 = _norm_rule(x[k:k + NUM_FEATURES], float(x[k + NUM_FEATURES]))
    return ladder_bot(v1, t1, v2, t2,
                      top=acts[0], mid=acts[1], bot=acts[2])


def quick_attack(subject, cfg, acts=(3, 0), generations=10,
                 popsize=16, tables=1 << 12, steps=256, seed=23,
                 sigma0=0.5, x0=None):
    """Short CMA attack for IN-TRAINING-LOOP probing: ~90% of the full
    optimizer's final extraction lands inside 10 generations (PERF.md
    "Adaptive exploitability"), which at these shapes is ~15-30 s of
    chip time — cheap enough to re-run against the training center
    every few ES generations (`train_es_kernel.py --adapt-every`).

    Returns ``(x, bot_params, attacker_bb)`` where ``attacker_bb`` is
    one league evaluation of the CMA mean on a seed the optimizer never
    saw (an honest point for the per-refresh exploitability
    trajectory, not the optimizer's own inflated ask/tell fitness).
    ``x0`` warm-starts from the previous refresh's solution.
    """
    P = cfg.num_seats
    stb = (0,) + (1,) * (P - 1)
    if x0 is None:
        if len(acts) == 3:
            x0 = _LADDER_X0
        elif acts == (3, 0):
            x0 = _JAM_X0
        else:
            x0 = np.zeros(spec_dim(acts))
    bound = 3.0
    es = CMAES(np.asarray(x0, np.float64), sigma0=sigma0,
               popsize=popsize, seed=seed,
               lower=np.full(spec_dim(acts), -bound),
               upper=np.full(spec_dim(acts), bound))
    for g in range(generations):
        seed_g = seed * 1_000_003 + g
        state0 = initial_packed_state(seed_g, cfg, tables)
        xs = es.ask()
        bots = [make_bot(x, acts) for x in xs]
        m, _, _ = selfplay_net_league_pop(
            seed_g, cfg, bots, subject, n_tables=tables,
            n_steps=steps, seat_to_bank=stb, state0=state0)
        es.tell(np.asarray(m)[:, 0])
    x = es.mean.copy()
    bot = make_bot(x, acts)
    m, _, _ = selfplay_net_league(
        seed * 7919 + 991, cfg, [bot, subject], stb,
        n_tables=tables * 2, n_steps=steps)
    return x, bot, float(m[0])


def optimize_pair(subject, cfg, acts, args, log):
    P = cfg.num_seats
    stb = (0,) + (1,) * (P - 1)
    pair_tag = ":".join(str(a) for a in acts)
    # arity term keeps e.g. (3,1) and (3,1,0) on distinct seed streams
    pair_key = 1000 * len(acts) + sum(13 ** i * a
                                      for i, a in enumerate(acts))
    if len(acts) == 3:
        x0 = _LADDER_X0
    elif acts == (3, 0):
        x0 = _JAM_X0
    else:
        x0 = np.zeros(spec_dim(acts))
    bound = 3.0
    es = CMAES(x0, sigma0=args.sigma0, popsize=args.popsize,
               seed=args.seed + pair_key,
               lower=np.full(spec_dim(acts), -bound),
               upper=np.full(spec_dim(acts), bound))
    holdout_state = initial_packed_state(HOLDOUT, cfg, args.eval_tables)

    def holdout_eval(x):
        m, e, _ = selfplay_net_league(
            HOLDOUT, cfg, [make_bot(x, acts), subject], stb,
            n_tables=args.eval_tables, n_steps=args.eval_steps,
            state0=holdout_state)
        return float(m[0]), float(e[0])

    best_x, best_hold = x0, -np.inf
    t0 = time.perf_counter()
    for g in range(args.generations):
        seed_g = args.seed * 1_000_003 + 7919 * pair_key + g
        state0 = initial_packed_state(seed_g, cfg, args.tables)
        xs = es.ask()
        bots = [make_bot(x, acts) for x in xs]
        m, _, _ = selfplay_net_league_pop(
            seed_g, cfg, bots, subject, n_tables=args.tables,
            n_steps=args.steps, seat_to_bank=stb, state0=state0)
        fits = np.asarray(m)[:, 0]
        es.tell(fits)
        if g % args.holdout_every == args.holdout_every - 1 \
                or g == args.generations - 1:
            hb, he = holdout_eval(es.mean)
            if hb > best_hold:
                best_hold, best_x = hb, es.mean.copy()
            log({"pair": pair_tag, "gen": g,
                 "gen_best_bb": round(float(fits.max()), 4),
                 "gen_mean_bb": round(float(fits.mean()), 4),
                 "holdout_mean_bb": round(hb, 4),
                 "cma_sigma": round(es.sigma, 4),
                 "elapsed_s": round(time.perf_counter() - t0, 1)})
        else:
            log({"pair": pair_tag, "gen": g,
                 "gen_best_bb": round(float(fits.max()), 4),
                 "gen_mean_bb": round(float(fits.mean()), 4),
                 "elapsed_s": round(time.perf_counter() - t0, 1)})

    # honest final: fresh seed, large evaluation, never seen in training
    final_state = initial_packed_state(FINAL_SEED, cfg, args.eval_tables)
    m, e, h = selfplay_net_league(
        FINAL_SEED, cfg, [make_bot(best_x, acts), subject], stb,
        n_tables=args.eval_tables, n_steps=args.eval_steps,
        state0=final_state)
    return {"bot_bb_per_hand": round(float(m[0]), 4),
            "stderr": round(float(e[0]), 4), "hands": int(h),
            "holdout_bb": round(best_hold, 4),
            "x": [round(float(v), 4) for v in best_x]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--subjects", nargs="+", default=[
        "es3=data/policy_6max_es3.npz"], help="name=artifact.npz")
    # Menu ordered by round-3 extraction (3:0 jam +0.46, 1:0 fof +0.35;
    # 2:0/3:1 were noise-level) so a queue timeout loses the weakest
    # searches; the 3:1:0 ladder triple is the widened attacker class.
    ap.add_argument("--pairs", default="3:0,1:0,3:1:0,3:1",
                    help="comma-separated action specs: hi:lo (linear "
                         "family) or top:mid:bot (ladder family)")
    ap.add_argument("--generations", type=int, default=50)
    ap.add_argument("--popsize", type=int, default=24)
    ap.add_argument("--sigma0", type=float, default=0.5)
    ap.add_argument("--tables", type=int, default=1 << 14)
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--eval-tables", type=int, default=1 << 16)
    ap.add_argument("--eval-steps", type=int, default=512)
    ap.add_argument("--holdout-every", type=int, default=10)
    ap.add_argument("--seats", type=int, default=6)
    ap.add_argument("--seed", type=int, default=23)
    ap.add_argument("--save", default="data/exploitability_opt.json")
    args = ap.parse_args()

    cfg = TableConfig(num_seats=args.seats, rules="standard")
    pairs = [tuple(int(v) for v in p.split(":"))
             for p in args.pairs.split(",")]

    def log(d):
        print(json.dumps(d), flush=True)

    out = {"tables": args.tables, "steps": args.steps,
           "generations": args.generations, "popsize": args.popsize,
           "seats": args.seats, "rules": cfg.rules, "subjects": {}}
    def save():
        if args.save:
            with open(args.save, "w") as f:
                json.dump(out, f, indent=1)

    for spec in args.subjects:
        name, path = spec.split("=", 1)
        subject = load_params(path)
        rows = {}
        out["subjects"][name] = {"artifact": path, "per_pair": rows}
        for acts in pairs:
            tag = ":".join(str(a) for a in acts)
            log({"subject": name, "start_pair": tag})
            rows[tag] = optimize_pair(subject, cfg, acts, args, log)
            log({"subject": name, "pair": tag,
                 **{k: v for k, v in rows[tag].items() if k != "x"}})
            best = max(rows, key=lambda k: rows[k]["bot_bb_per_hand"])
            out["subjects"][name].update(
                adaptive_bot_lb_bb=rows[best]["bot_bb_per_hand"],
                best_pair=best)
            save()  # partial results survive a queue timeout
        log({"subject": name,
             "best_pair": out["subjects"][name]["best_pair"],
             "adaptive_bot_lb_bb":
                 out["subjects"][name]["adaptive_bot_lb_bb"]})

    if args.save:
        print(f"saved {args.save}")


if __name__ == "__main__":
    main()
