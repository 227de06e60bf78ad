"""Build the fold-preservation anchor batch for leashed ES (es9).

Round-5 finding (PERF.md "es8"): pool-ES from the Nash-distilled init
erased the distilled folding entirely within 150 generations — the
fitness path from "fold at subgame-Nash frequencies" (5.56 bb leak to
jam-everything attackers) to "fold correctly" passes through
never-fold (1.13 bb leak), and ES takes the downhill shortcut every
time. The leash makes never-fold expensive: shaped fitness =
bb/hand + lambda * mean(log P(fold)) over a FIXED batch of states
where the DISTILLED net folds.

This script builds that batch: 6-max self-play decisions collected
under two reach profiles (the distilled net's own play, and the
subject artifact's play — the states ES training actually visits),
filtered to facing-a-bet spots where the distilled net's argmax is
fold. Saved: features [N, 24], the distill net's P(fold) as reference,
and provenance counts.

    python scripts/make_fold_anchor.py \
        --distill data/policy_6max_distill.npz \
        --subject data/policy_6max_es8.npz --save data/fold_anchor.npz
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")
from montecarlo_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from exp_leak_anatomy import (  # noqa: E402
    collect, flatten_recs, masked_argmax, np_logits,
)
from montecarlo_tpu.engine.state import TableConfig  # noqa: E402
from montecarlo_tpu.models.policy_net import load_params  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--distill", default="data/policy_6max_distill.npz",
                    help="the fold-capable net whose folds define the "
                         "anchor")
    ap.add_argument("--subject", default=None,
                    help="optional second reach profile (e.g. the es8 "
                         "artifact) so the anchor covers states the ES "
                         "run actually visits")
    ap.add_argument("--tables", type=int, default=192)
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--max-rows", type=int, default=16384)
    ap.add_argument("--save", default="data/fold_anchor.npz")
    args = ap.parse_args()

    cfg = TableConfig(num_seats=6, rules="standard")
    distill = load_params(args.distill)

    profiles = [("distill", distill, distill)]
    if args.subject:
        subj = load_params(args.subject)
        profiles.append(("subject", subj, subj))

    feats_all, prov = [], {}
    for name, p0, prest in profiles:
        keys = jax.random.split(
            jax.random.key(args.seed + hash(name) % 1000),
            args.tables)
        _, recs = collect(keys, cfg, args.steps, p0, prest)
        feats, seat, free, stage, idx = flatten_recs(recs)
        am, _ = masked_argmax(np_logits(distill, feats), free)
        keep = (~free) & (am == 0)          # facing a bet, distill folds
        feats_all.append(feats[keep])
        prov[name] = {"decisions": int(len(feats)),
                      "facing_bet": int((~free).sum()),
                      "fold_rows": int(keep.sum())}
        print(json.dumps({"profile": name, **prov[name]}), flush=True)

    feats = np.concatenate(feats_all)
    if len(feats) > args.max_rows:
        rng = np.random.default_rng(args.seed)
        feats = feats[rng.choice(len(feats), args.max_rows,
                                 replace=False)]

    # reference: the distill net's own P(fold) on the kept rows
    lg = np_logits(distill, feats)
    z = lg - lg.max(axis=1, keepdims=True)
    p = np.exp(z)
    p_fold = p[:, 0] / p.sum(axis=1)

    np.savez(args.save, feats=feats.astype(np.float32),
             p_fold_ref=p_fold.astype(np.float32))
    meta = {"rows": int(len(feats)),
            "distill": args.distill, "subject": args.subject,
            "p_fold_ref_mean": round(float(p_fold.mean()), 4),
            "provenance": prov}
    with open(args.save + ".json", "w") as f:
        json.dump(meta, f, indent=1)
    print(json.dumps(meta), flush=True)
    print(f"saved {args.save}")


if __name__ == "__main__":
    main()
