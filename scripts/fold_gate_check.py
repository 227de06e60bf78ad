"""Per-artifact fold-gate + v2-feature-usage diagnostic (CPU, XLA path).

The focused, parameterized follow-up to scripts/exp_leak_anatomy.py:
for each subject artifact, collect real self-play decision points and
report (a) the fold-gate stats that predicted the stage-g/h plateau —
fold=argmax fraction, mean P(fold), margin percentiles — and (b) how
much the policy actually USES the v2 betting-history features
(indices 20-23): the argmax flip fraction when they are zeroed, and the
logit sensitivity per new feature. (b) is the direct check that a
v2-trained artifact (es7/mix7) learned to read aggression rather than
leaving the appended w1 rows at zero.

    python scripts/fold_gate_check.py \
        --subjects es6=data/policy_6max_es6.npz,es7=data/policy_6max_es7.npz \
        --save data/fold_gate_es7.json
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
from montecarlo_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np  # noqa: E402

from montecarlo_tpu.engine import TableConfig  # noqa: E402
from montecarlo_tpu.models.features import NUM_FEATURES  # noqa: E402
from montecarlo_tpu.models.policy_net import load_params  # noqa: E402
from scripts.exp_leak_anatomy import (  # noqa: E402
    FEATURE_NAMES,
    collect,
    flatten_recs,
    fold_gate,
    margin_stats,
    masked_argmax,
    np_logits,
)

V2_START = 20


def v2_usage(params, feats, free):
    """How much the net reads features 20-23 on real decisions."""
    idx, _ = masked_argmax(np_logits(params, feats), free)
    feats0 = feats.copy()
    feats0[:, V2_START:] = 0.0
    idx0, _ = masked_argmax(np_logits(params, feats0), free)
    w1 = np.asarray(params.w1)
    sens = {}
    for k in range(V2_START, NUM_FEATURES):
        live = feats[:, k] != 0
        sens[FEATURE_NAMES[k]] = {
            "w1_row_l2": round(float(np.linalg.norm(w1[k])), 4),
            "nonzero_frac": round(float(live.mean()), 4),
        }
    return {
        "argmax_flip_when_v2_zeroed": round(float((idx != idx0).mean()), 5),
        "per_feature": sens,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--subjects", required=True,
                    help="name=path,... policy artifacts (6-max assumed "
                         "unless the name contains 'hu')")
    ap.add_argument("--tables", type=int, default=128)
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--save", default="data/fold_gate_check.json")
    args = ap.parse_args()

    out = {"tables": args.tables, "steps": args.steps, "seed": args.seed,
           "subjects": {}}
    for spec in args.subjects.split(","):
        name, path = spec.split("=")
        params = load_params(path)
        seats = 2 if "hu" in name else 6
        cfg = TableConfig(num_seats=seats, rules="standard")
        keys = jax.random.split(jax.random.key(args.seed), args.tables)
        _, recs = collect(keys, cfg, args.steps, params, params)
        feats, seat, free, stage, idx = flatten_recs(recs)
        _, _, ms = margin_stats(params, feats, free)
        ms["fold_gate"] = fold_gate(params, feats, free)
        ms["v2_usage"] = v2_usage(params, feats, free)
        ms["artifact"] = path
        ms["decisions"] = int(len(feats))
        out["subjects"][name] = ms
        print(json.dumps({name: ms["v2_usage"]
                          ["argmax_flip_when_v2_zeroed"],
                          "fold_argmax": ms["fold_gate"]
                          .get("fold_argmax_frac")}), flush=True)

    with open(args.save, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"saved": args.save}), flush=True)


if __name__ == "__main__":
    main()
