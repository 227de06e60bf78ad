"""Behavioral diff between two policy artifacts (CPU, XLA path).

Generic version of the pairwise argmax-disagreement probes that were
inlined in scripts/exp_leak_anatomy.py (es3-vs-es4, hu300-vs-hu_mix):
collect each subject's self-play decision points, then measure how
often the OTHER artifact's masked argmax differs on the same states —
the direct "did training change behavior, and where?" meter
(round-4's HU retirement and round-5's es9-lineage analyses both hang
on this number). Symmetric: disagreement is reported on BOTH state
distributions, per street, with fold-gate stats for each artifact on
each distribution.

Reference tie-in: the decision loop under diff is the actor's
act-on-your-turn hot path (player.clj:31-38 -> board.clj:122); the
reference tests AIs by watching these decisions over the wire, this
script diffs two AIs' decisions directly on-device.

Usage:
    python scripts/policy_diff.py \
        --a es10=data/policy_6max_es10.npz \
        --b es9=data/policy_6max_es9.npz --save data/diff_es10_es9.json
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

from montecarlo_tpu.engine.state import TableConfig  # noqa: E402
from montecarlo_tpu.models.policy_net import load_params  # noqa: E402
from scripts.exp_leak_anatomy import (  # noqa: E402
    ACTION_NAMES, collect, flatten_recs, fold_gate, masked_argmax,
    np_logits,
)

STAGE_NAMES = ["preflop", "flop", "turn", "river"]


def parse_subject(spec):
    name, path = spec.split("=", 1)
    return name, load_params(path)


def diff_on(feats, free, stage, pa, pb):
    """Argmax disagreement of pb vs pa on pa-or-pb-generated states."""
    ia, _ = masked_argmax(np_logits(pa, feats), free)
    ib, _ = masked_argmax(np_logits(pb, feats), free)
    dis = ia != ib
    out = {
        "decisions": int(len(feats)),
        "argmax_disagree": float(dis.mean()),
        "per_street": {
            STAGE_NAMES[s]: float(dis[stage == s].mean())
            for s in range(4) if int((stage == s).sum())
        },
    }
    # where they disagree, what does each pick? (a_action -> b_action)
    flows = {}
    for s in np.flatnonzero(dis)[:200000]:
        k = f"{ACTION_NAMES[ia[s]]}->{ACTION_NAMES[ib[s]]}"
        flows[k] = flows.get(k, 0) + 1
    total = max(1, sum(flows.values()))
    out["disagree_flows"] = {
        k: round(v / total, 4)
        for k, v in sorted(flows.items(), key=lambda kv: -kv[1])
    }
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--a", required=True, help="name=artifact.npz")
    ap.add_argument("--b", required=True, help="name=artifact.npz")
    ap.add_argument("--seats", type=int, default=6)
    ap.add_argument("--tables", type=int, default=128)
    ap.add_argument("--steps", type=int, default=512)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--save", default="data/policy_diff.json")
    args = ap.parse_args()

    na, pa = parse_subject(args.a)
    nb, pb = parse_subject(args.b)
    cfg = TableConfig(num_seats=args.seats, rules="standard")
    keys = jax.random.split(jax.random.key(args.seed), args.tables)

    out = {"a": args.a, "b": args.b, "seats": args.seats,
           "tables": args.tables, "steps": args.steps, "seed": args.seed}
    for tag, params in ((na, pa), (nb, pb)):
        _, recs = collect(keys, cfg, args.steps, params, params)
        feats, _, free, stage, _ = flatten_recs(recs)
        blk = diff_on(feats, free, stage, pa, pb)
        blk["fold_gate"] = {na: fold_gate(pa, feats, free),
                            nb: fold_gate(pb, feats, free)}
        out[f"on_{tag}_selfplay"] = blk
        print(json.dumps({f"on_{tag}_selfplay":
                          blk["argmax_disagree"]}), flush=True)

    with open(args.save, "w") as f:
        json.dump(out, f, indent=1)
    print(f"saved {args.save}")


if __name__ == "__main__":
    main()
