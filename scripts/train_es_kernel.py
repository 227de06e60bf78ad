"""ES fine-tuning of the 6-max policy at packed-engine speed (GPU).

    python scripts/train_es_kernel.py [--generations 120] [--pop 8]
        [--sigma 0.05] [--lr 0.1] [--tables 16384] [--steps 256]
        [--mask w3,b3] [--save data/policy_6max_es.npz]

Starts from the REINFORCE artifact (data/policy_6max_200.npz), evaluates
every perturbed candidate with the whole-step kernel's in-kernel seat
meters (seat 0 vs five randoms, independent full-stack hands), ascends
the antithetic ES direction, then reports a final high-precision
evaluation (64k tables) of start vs trained with CI.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from montecarlo_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from montecarlo_tpu.engine.state import TableConfig  # noqa: E402
from montecarlo_tpu.models.leash import make_anchor_score  # noqa: E402
from montecarlo_tpu.models.policy_net import (  # noqa: E402
    load_params, save_params,
)
from montecarlo_tpu.models.train_es import (  # noqa: E402
    kernel_eval_fn, kernel_eval_pop_fn, kernel_league_eval_pop_fn,
    kernel_pool_eval_pop_fn, layer_mask, train_es,
)
from montecarlo_tpu.ops.pallas_engine import (  # noqa: E402
    selfplay_net_eval_kernel, selfplay_net_league,
)


def resolve_opponent(spec):
    """Parse one --opponents pool entry -> (tag, params_or_None, geometry).

    "NAME@lone" = the opponent sits ALONE at seat 0 against P-1
    candidate copies (the probe's one-vs-five geometry — round 3
    measured it differing from five-vs-one by 0.7 bb on the jam
    matchup). Default geometry: candidate alone at seat 0. Specs:
    'random', 'bot:NAME' (models/bots.py panel), an artifact path, or
    'optbot:PATH.json:SUBJECT[:T-M-B]' — the CMA-found adaptive
    attacker (scripts/opt_bot.py), rebuilt from its saved parameter
    vector (best_pair unless an explicit dash-separated action spec is
    given), so the probe->retrain loop can train directly against the
    strongest discovered bot."""
    geom = "five"
    if spec.endswith("@lone"):
        spec, geom = spec[:-5], "lone"
    if spec == "random":
        return spec, None, geom
    if spec.startswith("adaptive:"):
        # 'adaptive:T-M[-B]' — a pool slot REFRESHED during training by
        # a short CMA attack on the current center (--adapt-every;
        # scripts/opt_bot.quick_attack). params None is a placeholder:
        # the first refresh runs at generation 0, before any fitness
        # evaluation touches the slot.
        return spec, None, geom
    if spec.startswith("bot:"):
        from montecarlo_tpu.models.bots import panel
        return spec, panel()[spec[4:]], geom
    if spec.startswith("optbot:"):
        from scripts.opt_bot import make_bot
        parts = spec.split(":")
        path, subj = parts[1], parts[2]
        with open(path) as f:
            sub = json.load(f)["subjects"][subj]
        pair = (parts[3].replace("-", ":") if len(parts) > 3
                else sub["best_pair"])
        acts = tuple(int(v) for v in pair.split(":"))
        x = np.asarray(sub["per_pair"][pair]["x"], np.float32)
        return spec, make_bot(x, acts), geom
    return spec, load_params(spec), geom


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--generations", type=int, default=120)
    ap.add_argument("--pop", type=int, default=8)
    ap.add_argument("--sigma", type=float, default=0.05)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--tables", type=int, default=1 << 14)
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--noise-floor", type=float, default=0.003,
                    help="bb/hand spread floor for fitness "
                         "standardization (damps updates when policy "
                         "saturation kills the perturbation signal)")
    ap.add_argument("--start", default="data/policy_6max_200.npz")
    ap.add_argument("--mask", default="",
                    help="comma-separated MLPParams fields to perturb "
                         "(empty = all)")
    ap.add_argument("--save", default="data/policy_6max_es.npz")
    ap.add_argument("--opponent", default="",
                    help="artifact path: use league fitness vs this net "
                         "at seats 1..P-1 instead of random opponents")
    ap.add_argument("--opponents", default="",
                    help="comma-separated opponent POOL; each spec is "
                         "'random', 'bot:NAME' (models/bots.py panel), "
                         "'optbot:PATH.json:SUBJECT[:T-M-B]' (CMA "
                         "attacker from scripts/opt_bot.py output), "
                         "or an artifact path. Fitness = mean over the "
                         "pool of seat-0 bb/hand (attacks the measured "
                         "static exploitability while anchoring the "
                         "other components)")
    ap.add_argument("--adapt-every", type=int, default=0,
                    help="with 'adaptive:T-M[-B]' pool slots: every N "
                         "ES generations, re-run a short CMA attack "
                         "(opt_bot.quick_attack) against the CURRENT "
                         "center and swap the found attacker into "
                         "those slots — closes the probe->retrain "
                         "whack-a-mole loop inside one training run "
                         "and logs a per-refresh exploitability "
                         "trajectory")
    ap.add_argument("--adapt-gens", type=int, default=10)
    ap.add_argument("--adapt-popsize", type=int, default=16)
    ap.add_argument("--adapt-tables", type=int, default=1 << 12)
    ap.add_argument("--per-candidate", action="store_true",
                    help="one launch per candidate (the pre-pop-batched "
                         "path; default is one launch per generation)")
    ap.add_argument("--seats", type=int, default=6,
                    help="table size (2 = heads-up hardening runs)")
    ap.add_argument("--soften", type=float, default=0.0,
                    help="divide the start's w3,b3 by K before training "
                    "(argmax-preserving margin shrink; PERF.md fold-gate "
                    "diagnostic: K~6-8 moves the never-sampled fold "
                    "action into the exploration band so ES fitness can "
                    "finally see conditional folds). Ignored on --resume "
                    "from a checkpoint (already-softened lineage).")
    ap.add_argument("--resume", action="store_true",
                    help="continue from <save>.ckpt.npz/<save>."
                         "progress.json if present (at most "
                         "center_eval_every generations are lost when a "
                         "long run is killed)")
    ap.add_argument("--fold-anchor", default="",
                    help="fold-preservation leash (es9): .npz with "
                         "feats rows where the distilled net folds "
                         "(scripts/make_fold_anchor.py). Shaped fitness "
                         "= bb/hand + lambda * mean(clipped log P(fold)) "
                         "over the batch — es8 measured that unleashed "
                         "ES erases distilled folding within 150 gens "
                         "(fold-incorrectly leaks 5.56 bb, never-fold "
                         "only 1.13, and ES shortcuts downhill)")
    ap.add_argument("--fold-lambda", type=float, default=0.15,
                    help="leash weight: buried fold (log P ~ -8 clip) "
                         "costs lambda*8 bb of fitness; healthy fold "
                         "(~log 0.4) costs lambda*0.9")
    args = ap.parse_args()

    cfg = TableConfig(num_seats=args.seats, rules="standard")

    # Durable progress: when --save is set, every center eval also
    # persists (a) the current center to <save>.ckpt.npz, (b) attempt
    # progress to <save>.progress.json, and (c) the best-by-holdout
    # params to <save> itself whenever the holdout quality improves —
    # so a killed run leaves a usable artifact and --resume continues.
    ckpt_path = args.save + ".ckpt.npz" if args.save else ""
    side_path = args.save + ".progress.json" if args.save else ""
    prog = {"gens_done": 0, "best_bb": -1e30}
    start_path = args.start
    if args.resume and ckpt_path and os.path.exists(ckpt_path) \
            and os.path.exists(side_path):
        with open(side_path) as f:
            prog.update(json.load(f))
        start_path = ckpt_path
        print(json.dumps({"resumed_at_gen": prog["gens_done"],
                          "best_bb": prog["best_bb"]}), flush=True)
    base_done = int(prog["gens_done"])
    gens_left = max(0, args.generations - base_done)
    params0 = load_params(start_path)
    if args.soften > 1.0 and start_path != ckpt_path:
        params0 = params0._replace(w3=params0.w3 / args.soften,
                                   b3=params0.b3 / args.soften)
        print(json.dumps({"softened": args.soften}), flush=True)

    def checkpoint(g, center, best, best_quality):
        save_params(ckpt_path, center)
        if float(best_quality) > prog["best_bb"]:
            prog["best_bb"] = float(best_quality)
            save_params(args.save, best)
        prog["gens_done"] = base_done + g + 1
        with open(side_path, "w") as f:
            json.dump(prog, f)

    pool = ([resolve_opponent(s)
             for s in args.opponents.split(",") if s]
            if args.opponents else [])
    adapt_kw = {}
    if pool:
        # opp_entries is shared MUTABLE state: the pool evaluator
        # re-reads it every call (train_es.kernel_pool_eval_pop_fn
        # docstring), so the adaptive-attacker hook below can swap
        # slot weights in place between generations.
        opp_entries = [(p, g) for _, p, g in pool]
        eval_kw = {"eval_pop_fn": kernel_pool_eval_pop_fn(
            cfg, opp_entries, n_tables=args.tables,
            n_steps=args.steps)}
        adaptive = [(i, tag) for i, (tag, _p, _g) in enumerate(pool)
                    if tag.startswith("adaptive:")]
        if adaptive:
            assert args.adapt_every > 0, \
                "adaptive: pool slots need --adapt-every N"
            from scripts.opt_bot import quick_attack
            # group slots by attacker family: ONE attack per family
            # per refresh, applied to every slot (geometries differ)
            fams = {}
            for i, tag in adaptive:
                acts = tuple(int(v)
                             for v in tag.split(":")[1].split("-"))
                fams.setdefault(acts, []).append(i)
            warm = {}

            def adapt_fn(g, center):
                for acts, slots in fams.items():
                    x, bot, bb = quick_attack(
                        center, cfg, acts,
                        generations=args.adapt_gens,
                        popsize=args.adapt_popsize,
                        tables=args.adapt_tables, steps=args.steps,
                        seed=args.seed * 31 + 1009 * (base_done + g),
                        x0=warm.get(acts))
                    warm[acts] = x
                    for i in slots:
                        opp_entries[i] = (bot, pool[i][2])
                    print(json.dumps({
                        "adapt_at_gen": base_done + g,
                        "pair": ":".join(str(a) for a in acts),
                        "attacker_bb": round(bb, 4),
                        "slots": slots}), flush=True)

            adapt_kw = {"adapt_fn": adapt_fn,
                        "adapt_every": args.adapt_every}
    elif args.per_candidate:
        eval_kw = {"eval_fn": kernel_eval_fn(
            cfg, net_seats=1, n_tables=args.tables, n_steps=args.steps)}
    elif args.opponent:
        # league fitness: candidate at seat 0 vs the opponent net at
        # every other seat (vs-random gains don't transfer - PERF.md)
        eval_kw = {"eval_pop_fn": kernel_league_eval_pop_fn(
            cfg, load_params(args.opponent), n_tables=args.tables,
            n_steps=args.steps)}
    else:
        # population-batched: the whole generation in one launch/chunk
        eval_kw = {"eval_pop_fn": kernel_eval_pop_fn(
            cfg, net_seats=1, n_tables=args.tables, n_steps=args.steps)}
    mask = None
    if args.mask:
        mask = layer_mask(params0, set(args.mask.split(",")))

    anchor_score = None
    if args.fold_anchor:
        # mean clipped log P(fold) on the anchor (models/leash.py —
        # host-side NumPy mirror of policy_logits, pinned by
        # tests/test_leash.py)
        anchor_score, anc_feats = make_anchor_score(args.fold_anchor)
        lam = args.fold_lambda

        print(json.dumps({"fold_anchor": args.fold_anchor,
                          "rows": int(len(anc_feats)),
                          "lambda": lam,
                          "start_anchor_logp": round(
                              anchor_score(params0), 4)}), flush=True)

        if "eval_pop_fn" in eval_kw:
            base_pop = eval_kw["eval_pop_fn"]

            def leashed_pop(params_list, eval_seed):
                f, h = base_pop(params_list, eval_seed)
                pen = np.asarray([anchor_score(p) for p in params_list])
                return np.asarray(f) + lam * pen, h

            eval_kw["eval_pop_fn"] = leashed_pop
        else:
            base_one = eval_kw["eval_fn"]

            def leashed_one(p, eval_seed):
                f, h = base_one(p, eval_seed)
                return f + lam * anchor_score(p), h

            eval_kw["eval_fn"] = leashed_one

    t0 = time.perf_counter()

    def progress(g, mean_fit, best_fit, spread):
        dt = time.perf_counter() - t0
        print(json.dumps({"gen": g, "mean_bb": round(mean_fit, 4),
                          "best_bb": round(best_fit, 4),
                          "spread_bb": round(spread, 5),
                          "elapsed_s": round(dt, 1)}), flush=True)

    # Center quality on a FIXED holdout seed (common random numbers
    # across the whole run): per-generation means carry ~±0.06 bb of
    # fresh-seed deal noise, so argmaxing them snapshots seed luck, not
    # policy quality (winner's curse — measured in PERF.md). Same call
    # shapes as the final evals below, so no extra kernel compiles.
    HOLDOUT = 777

    def eval_vs(p, opp, seed, n_tables=1 << 16, geom="five"):
        """(bb/hand, stderr, hands) of net ``p`` vs one opponent spec
        (None = random seats). geom="five": p alone at seat 0 vs P-1
        opponents; "lone": the opponent alone at seat 0 vs P-1 copies
        of p — reported as the SUM over p's seats (= minus the
        opponent's extraction under exact conservation; same scale as
        the fitness and the probe, so holdout selection matches what
        training optimizes). stderr for "lone" is the conservative
        fully-correlated bound (sum of per-seat stderrs)."""
        P = cfg.num_seats
        cand_seats = [0] if geom == "five" else list(range(1, P))
        if opp is None:
            net_seats = sum(1 << k for k in cand_seats)
            m, e, h = selfplay_net_eval_kernel(
                seed, cfg, p, net_seats=net_seats, n_tables=n_tables,
                n_steps=256)
        else:
            stb = tuple(0 if k in cand_seats else 1 for k in range(P))
            m, e, h = selfplay_net_league(
                seed, cfg, [p, opp], stb, n_tables=n_tables,
                n_steps=256)
        import numpy as _np
        red = _np.sum if geom == "lone" else _np.mean
        return (float(red(m[cand_seats])),
                float(red(e[cand_seats])), int(h))

    def center_eval(p):
        if pool:
            # adaptive: slots are excluded — the attacker moves between
            # refreshes, so "center vs current attacker" is not a
            # comparable fixed-holdout quality across the run. Anchor
            # selection on the FIXED entries (add an 'optbot:' spec to
            # hold the line against a known attacker).
            per = {f"{name}@{geom}" if geom != "five" else name:
                   eval_vs(p, opp, HOLDOUT, geom=geom)[0]
                   for name, opp, geom in pool
                   if not name.startswith("adaptive:")}
            if not per:
                return 0.0
            mean = sum(per.values()) / len(per)
            extra = {}
            if anchor_score is not None:
                # best-center selection must honor the leash too, or the
                # snapshot argmax quietly picks a defected (never-fold)
                # center off the leashed trajectory
                alp = anchor_score(p)
                extra = {"anchor_logp": round(alp, 4)}
                mean = mean + args.fold_lambda * alp
            print(json.dumps({"center_bb": round(mean, 4),
                              **{f"center_{n}": round(v, 4)
                                 for n, v in per.items()},
                              **extra,
                              "elapsed_s": round(
                                  time.perf_counter() - t0, 1)}),
                  flush=True)
            return mean
        opp = load_params(args.opponent) if args.opponent else None
        bb, _, _ = eval_vs(p, opp, HOLDOUT)
        print(json.dumps({"center_bb": round(bb, 4),
                          "elapsed_s": round(time.perf_counter() - t0,
                                             1)}), flush=True)
        return bb

    out = train_es(args.seed + base_done, params0,
                   generations=gens_left, pop=args.pop,
                   sigma=args.sigma, lr=args.lr, momentum=args.momentum,
                   mask=mask, progress=progress,
                   noise_floor=args.noise_floor,
                   center_eval_fn=center_eval,
                   checkpoint_fn=checkpoint if args.save else None,
                   **eval_kw, **adapt_kw)
    dt = time.perf_counter() - t0
    print(json.dumps({
        "training_seconds": round(dt, 1),
        "training_hands": out.hands_total,
        "training_hands_per_sec": round(out.hands_total / dt),
    }), flush=True)

    # High-precision final: start vs trained on a fresh seed, on the
    # SAME opponent distribution the run trained against (per-member
    # breakdown for pools). With checkpointing, <save> holds the
    # best-by-holdout across ALL attempts — evaluate that.
    es_params = out.params
    if args.save and os.path.exists(args.save):
        es_params = load_params(args.save)
    for name, p in (("start", params0), ("es", es_params)):
        if pool:
            rows = {}
            for oname, opp, geom in pool:
                bb, se, h = eval_vs(p, opp, 991, geom=geom)
                key = f"{oname}@{geom}" if geom != "five" else oname
                rows[key] = {"bb": round(bb, 4),
                             "stderr": round(se, 4), "hands": h}
            mean = sum(r["bb"] for r in rows.values()) / len(rows)
            print(json.dumps({"final_eval": name,
                              "pool_mean_bb": round(mean, 4),
                              "per_opponent": rows}), flush=True)
            continue
        opp = load_params(args.opponent) if args.opponent else None
        bb, se, h = eval_vs(p, opp, 991)
        print(json.dumps({"final_eval": name,
                          "bb_per_hand_seat0": round(bb, 4),
                          "stderr": round(se, 4),
                          "hands": h}), flush=True)

    if args.save:
        if not os.path.exists(args.save):
            save_params(args.save, out.params)
        print(f"saved {args.save} (best holdout "
              f"{max(prog['best_bb'], -999.0):.4f})")


if __name__ == "__main__":
    main()
