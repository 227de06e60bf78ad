"""Why does every 6-max artifact leak ~1.2 bb/hand to fold-capable rule
bots, and why did two HU hardening attempts (ES and REINFORCE) not move
the fof_raise hole at all?

Two CPU-runnable diagnostics on the XLA path (no Pallas PRNG needed):

1. **Margin freeze** — collect the subject's actual decision points from
   self-play, then measure the logit-margin distribution (top1 - top2 of
   the masked action logits) and the fraction of decisions a training
   perturbation can flip: ES noise at the production recipe
   (sigma=0.05 on w2,b2,w3,b3 — train_es_kernel --mask), and the
   sampling stochasticity (categorical over logits: a margin above ~4.6
   makes the non-argmax probability < 1%). If the margins dwarf the
   perturbations, the artifact is *behaviorally frozen*: ES/gradient
   steps change fitness only through a tiny near-threshold subset, and
   "trained" artifacts that select best-by-holdout keep re-saving
   behavioral clones (measured: policy_6max_es5 == es4 bit-identical;
   policy_hu_mix differs in weights by up to 0.087 yet plays
   bit-identically to policy_hu_300 in 2M-hand probes).

2. **Attacker anatomy** — decode the winning CMA vectors
   (data/exploitability_opt*.json) into named-feature weight tables,
   and replay subject-vs-attacker on the XLA engine to get per-street
   action histograms for both sides: WHAT the 1.2 bb exploit actually
   does, and WHERE the subject puts its chips in against it.

Reference tie-in: the decision loop being diagnosed is the rebuild of
``board.clj:122-138``/``gameplay.clj:122-150``; the subjects/attackers
are rebuild-added AI-testing machinery (reference README.md:9).

    python scripts/exp_leak_anatomy.py            # CPU, ~2-4 min
"""

import argparse
import json
import os
import sys
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
from montecarlo_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from montecarlo_tpu.engine.state import TableConfig, init_state  # noqa: E402
from montecarlo_tpu.engine.step import clamp_action, head_info, step_table  # noqa: E402
from montecarlo_tpu.engine.street import bets_needed  # noqa: E402
from montecarlo_tpu.models.features import NUM_FEATURES, state_features  # noqa: E402
from montecarlo_tpu.models.policy_net import (  # noqa: E402
    MLPParams, action_from_index, load_params, policy_logits,
)

I32 = jnp.int32

FEATURE_NAMES = [
    "stage_preflop", "stage_flop", "stage_turn", "stage_river",
    "n_community/5", "pot/(100P)", "needed/100", "stack/100",
    "free_to_check", "in_hand/P", "to_act/P", "seat/P",
    "pot_odds", "needed/bb/10", "hand_category/8", "top_rank/14",
    "hole_rank0/14", "hole_rank1/14", "suited", "paired",
    # feature-set v2 (betting history)
    "street_raises/4", "has_aggressor", "raiser_relpos", "re_raised",
]
ACTION_NAMES = ["fold", "check/call", "min-raise", "pot-raise"]


@partial(jax.jit, static_argnames=("cfg", "n_steps"))
def collect(keys, cfg, n_steps, seat0_params, rest_params):
    """Perpetual self-play (rollout/selfplay.py pattern) that RECORDS
    every decision: features, acting seat, free-to-check flag, stage,
    and the sampled menu index. Seat 0 plays ``seat0_params``, all other
    seats ``rest_params`` (pass the same params for pure self-play)."""

    def one_table(key):
        st = init_state(key, cfg)

        def body(carry, k):
            st, street_raises = carry
            feats = state_features(st)
            seat, _, _ = head_info(st)
            la = policy_logits(seat0_params, feats)
            lb = policy_logits(rest_params, feats)
            logits = jnp.where(seat == 0, la, lb)
            free = bets_needed(st.bets, seat) == 0
            logits = logits + jnp.where(
                (jnp.arange(4) == 0) & free, -1e9, 0.0)
            idx = jax.random.categorical(k, logits)
            action = clamp_action(st, action_from_index(idx, st))
            prev_stage, prev_idx = st.stage, st.hand_idx
            nxt = step_table(st, action, rules=cfg.rules)
            applied = (action > 0) & ~st.hand_over
            street_raises = jnp.where(
                (nxt.stage != prev_stage) | (nxt.hand_idx != prev_idx),
                0, street_raises + applied)
            rec = (feats, seat.astype(I32), free,
                   st.stage.astype(I32), idx.astype(I32))
            return (nxt, street_raises), rec

        ks = jax.random.split(jax.random.fold_in(key, 0x5CAD), n_steps)
        (final, _), recs = jax.lax.scan(
            body, (st, jnp.zeros((), I32)), ks)
        return final, recs

    finals, recs = jax.vmap(one_table)(keys)
    return finals, recs


def flatten_recs(recs):
    feats, seat, free, stage, idx = recs
    n = feats.shape[0] * feats.shape[1]
    return (np.asarray(feats).reshape(n, NUM_FEATURES),
            np.asarray(seat).reshape(n), np.asarray(free).reshape(n),
            np.asarray(stage).reshape(n), np.asarray(idx).reshape(n))


def np_logits(params, feats):
    p = {k: np.asarray(getattr(params, k)) for k in
         ("w1", "b1", "w2", "b2", "w3", "b3")}
    h = np.maximum(feats @ p["w1"] + p["b1"], 0.0)
    h = np.maximum(h @ p["w2"] + p["b2"], 0.0)
    return h @ p["w3"] + p["b3"]


def masked_argmax(logits, free):
    lg = logits.copy()
    lg[free, 0] = -1e9
    return lg.argmax(axis=1), lg


def margin_stats(params, feats, free):
    """Margin distribution + sampling stochasticity on real decisions."""
    idx, lg = masked_argmax(np_logits(params, feats), free)
    srt = np.sort(lg, axis=1)
    margin = srt[:, -1] - srt[:, -2]
    # categorical sampling: P(non-argmax) = 1 - softmax_top
    z = lg - lg.max(axis=1, keepdims=True)
    p_top = 1.0 / np.exp(z).sum(axis=1)
    return idx, margin, {
        "margin_p10": float(np.percentile(margin, 10)),
        "margin_p50": float(np.percentile(margin, 50)),
        "margin_p90": float(np.percentile(margin, 90)),
        "frac_margin_lt_4.6": float((margin < 4.6).mean()),
        "frac_sample_nonargmax_gt_1pct": float((p_top < 0.99).mean()),
        "mean_p_nonargmax": float((1 - p_top).mean()),
    }


def fold_gate(params, feats, free):
    """Among FACING-A-BET decisions (fold legal): does the artifact ever
    fold, and how much probability mass does fold carry? A near-zero
    fold gate + value-caller attacker = the measured 1.2 bb leak."""
    facing = ~free
    idx, lg = masked_argmax(np_logits(params, feats), free)
    lgf = lg[facing]
    z = lgf - lgf.max(axis=1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(axis=1, keepdims=True)
    rank = (lgf > lgf[:, [0]]).sum(axis=1)  # actions above fold
    return {
        "facing_bet_decisions": int(facing.sum()),
        "fold_argmax_frac": float((idx[facing] == 0).mean()),
        "mean_p_fold": float(p[:, 0].mean()),
        "frac_p_fold_gt_1pct": float((p[:, 0] > 0.01).mean()),
        "fold_logit_rank_hist": [float((rank == r).mean())
                                 for r in range(4)],
    }


def es_flip_fraction(params, feats, free, sigma=0.05,
                     layers=("w2", "b2", "w3", "b3"), draws=16, seed=0):
    """Fraction of real decisions flipped by one ES perturbation at the
    production recipe (train_es_kernel: sigma on w2,b2,w3,b3 only)."""
    rng = np.random.default_rng(seed)
    base_idx, _ = masked_argmax(np_logits(params, feats), free)
    per_draw = []
    flipped_any = np.zeros(len(feats), bool)
    for _ in range(draws):
        d = {k: np.asarray(getattr(params, k)).copy() for k in
             ("w1", "b1", "w2", "b2", "w3", "b3")}
        for k in layers:
            d[k] = d[k] + sigma * rng.standard_normal(
                d[k].shape).astype(np.float32)
        pert = MLPParams(**{k: jnp.asarray(v) for k, v in d.items()})
        idx, _ = masked_argmax(np_logits(pert, feats), free)
        flip = idx != base_idx
        per_draw.append(float(flip.mean()))
        flipped_any |= flip
    return {"sigma": sigma, "draws": draws,
            "mean_flip_frac": float(np.mean(per_draw)),
            "max_flip_frac": float(np.max(per_draw)),
            "flipped_by_any_draw": float(flipped_any.mean())}


def behavior_hist(stage, idx, sel):
    """Per-street action histogram over selected decisions."""
    out = {}
    for s, sname in enumerate(["preflop", "flop", "turn", "river"]):
        m = sel & (stage == s)
        n = int(m.sum())
        row = {"decisions": n}
        if n:
            for a, aname in enumerate(ACTION_NAMES):
                row[aname] = round(float((idx[m] == a).mean()), 4)
        out[sname] = row
    return out


def decode_attacker(path, subject_key):
    """Named-weight table for the winning CMA vector(s) in an opt_bot
    artifact (linear pairs only: x = [score_vec[20], threshold])."""
    with open(path) as f:
        d = json.load(f)
    sub = d["subjects"][subject_key]
    out = {}
    for pair, row in sub["per_pair"].items():
        x = np.asarray(row["x"], np.float64)
        if len(x) != NUM_FEATURES + 1:     # ladder family: skip decode
            out[pair] = {"bot_bb_per_hand": row["bot_bb_per_hand"],
                         "family": "ladder", "dims": len(x)}
            continue
        w = {FEATURE_NAMES[i]: round(float(x[i]), 3)
             for i in np.argsort(-np.abs(x[:NUM_FEATURES]))
             if abs(x[i]) > 0.05}
        out[pair] = {"bot_bb_per_hand": row["bot_bb_per_hand"],
                     "threshold": round(float(x[NUM_FEATURES]), 3),
                     "weights_by_magnitude": w}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tables", type=int, default=128)
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--save", default="data/leak_anatomy.json")
    args = ap.parse_args()

    out = {"tables": args.tables, "steps": args.steps, "seed": args.seed}

    # ---------- 6-max artifacts ----------
    cfg6 = TableConfig(num_seats=6, rules="standard")
    es3 = load_params("data/policy_6max_es3.npz")
    es4 = load_params("data/policy_6max_es4.npz")
    keys = jax.random.split(jax.random.key(args.seed), args.tables)

    _, recs = collect(keys, cfg6, args.steps, es3, es3)
    feats, seat, free, stage, idx = flatten_recs(recs)
    print(json.dumps({"collected_6max_selfplay": len(feats)}), flush=True)

    sub = {}
    for name, p in [("es3", es3), ("es4", es4)]:
        aidx, margin, ms = margin_stats(p, feats, free)
        ms["es_flip"] = es_flip_fraction(p, feats, free)
        ms["fold_gate"] = fold_gate(p, feats, free)
        sub[name] = ms
    # behavioral identity across the lineage on es3's state distribution
    i3, _ = masked_argmax(np_logits(es3, feats), free)
    i4, _ = masked_argmax(np_logits(es4, feats), free)
    sub["es3_vs_es4_argmax_disagree"] = float((i3 != i4).mean())
    out["sixmax"] = sub

    # subject-vs-attacker behavior: the es3 call/fold killer (pair 1:0)
    from scripts.opt_bot import make_bot
    with open("data/exploitability_opt.json") as f:
        opt = json.load(f)
    row = opt["subjects"]["es3"]["per_pair"]["1:0"]
    bot = make_bot(np.asarray(row["x"], np.float32), (1, 0))
    _, recs_b = collect(keys, cfg6, args.steps, bot, es3)
    fb, sb, frb, stb, ib = flatten_recs(recs_b)
    out["vs_attacker"] = {
        "attacker_pair": "1:0",
        "attacker_bb_per_hand_bf16": row["bot_bb_per_hand"],
        "attacker_behavior": behavior_hist(stb, ib, sb == 0),
        "subject_behavior": behavior_hist(stb, ib, sb != 0),
        "subject_selfplay_behavior": behavior_hist(stage, idx, seat >= 0),
    }
    out["attacker_decode"] = {
        "es3": decode_attacker("data/exploitability_opt.json", "es3"),
    }
    if os.path.exists("data/exploitability_opt_es5.json"):
        out["attacker_decode"]["es5"] = decode_attacker(
            "data/exploitability_opt_es5.json", "es5")

    # ---------- HU artifacts ----------
    cfg2 = TableConfig(num_seats=2, rules="standard")
    hu = load_params("data/policy_hu_300.npz")
    hu_mix = load_params("data/policy_hu_mix.npz")
    keys2 = jax.random.split(jax.random.key(args.seed + 1), args.tables)
    _, recs2 = collect(keys2, cfg2, args.steps, hu, hu)
    f2, s2, fr2, st2, i2 = flatten_recs(recs2)
    print(json.dumps({"collected_hu_selfplay": len(f2)}), flush=True)

    huo = {}
    for name, p in [("hu300", hu), ("hu_mix", hu_mix)]:
        _, _, ms = margin_stats(p, f2, fr2)
        ms["es_flip"] = es_flip_fraction(p, f2, fr2)
        ms["fold_gate"] = fold_gate(p, f2, fr2)
        huo[name] = ms
    ia, _ = masked_argmax(np_logits(hu, f2), fr2)
    ib2, _ = masked_argmax(np_logits(hu_mix, f2), fr2)
    huo["hu300_vs_hu_mix_argmax_disagree"] = float((ia != ib2).mean())
    out["hu"] = huo

    with open(args.save, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"saved": args.save}))
    for k in ("sixmax", "hu"):
        print(json.dumps({k: out[k]}, default=float), flush=True)


if __name__ == "__main__":
    main()
