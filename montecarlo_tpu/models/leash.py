"""Fold-preservation leash for ES training (round-5 es9 machinery).

Measured motivation (PERF.md "Distillation opens the fold gate" /
"es9: the leash holds"): pool-ES from the Nash-distilled init erased
the distilled folding within 150 generations — between "fold at the
wrong frequencies" (-5.5 bb to jam-everything attackers) and "fold at
the right frequencies" sits "never fold" (-1.1 bb), and a
relative-fitness learner rolls downhill to it every time (es8). The
leash reshapes fitness to

    bb/hand + lambda * mean(clip(log P(fold), CLIP_LOG_P))

over a FIXED batch of facing-a-bet states where the distilled net's
argmax is fold (scripts/make_fold_anchor.py), making the never-fold
defection cost ~2 bb where it only buys back ~1.1. With lambda=0.25
the leashed run (es9) kept 70.8% fold=argmax facing a bet and priced
at adaptive-CMA LB 0.349 bb/hand — the first artifact below the
es2..es8 ~1.2 bb plateau.

Host-side NumPy by design: the leash is evaluated per ES candidate
between packed-engine calls (scripts/train_es_kernel.py), so it
must not trace/compile per candidate. The forward chain mirrors
models.policy_net.policy_logits exactly (action 0 = fold);
tests/test_leash.py pins the two paths against each other.

Reference tie-in: rebuild-added AI-training machinery in service of
the reference's stated purpose ("test AIs", the reference's README.md:9).
"""

import numpy as np

# Clip for log P(fold): below e^-8 ~ 3e-4 the net has defected anyway
# and an unbounded log would let one -inf state dominate the mean.
CLIP_LOG_P = -8.0


def anchor_log_pfold(params, feats, clip=CLIP_LOG_P):
    """Mean clipped log P(fold) of ``params`` over anchor features.

    ``feats``: float32 [N, NUM_FEATURES] decision-state features
    (models/features.py layout) at anchored fold states.
    ``params``: an MLPParams pytree (attrs w1,b1,w2,b2,w3,b3); arrays
    may be jax or numpy — they are pulled to host.
    """
    h = np.maximum(feats @ np.asarray(params.w1)
                   + np.asarray(params.b1), 0.0)
    h = np.maximum(h @ np.asarray(params.w2) + np.asarray(params.b2), 0.0)
    lg = h @ np.asarray(params.w3) + np.asarray(params.b3)
    z = lg - lg.max(axis=1, keepdims=True)
    logp = z[:, 0] - np.log(np.exp(z).sum(axis=1))
    return float(np.maximum(logp, clip).mean())


def load_anchor(path):
    """Load a fold-anchor .npz (scripts/make_fold_anchor.py) -> feats."""
    anc = np.load(path)
    return np.asarray(anc["feats"], np.float32)


def make_anchor_score(path, clip=CLIP_LOG_P):
    """Bind an anchor file into a per-candidate scoring closure."""
    feats = load_anchor(path)

    def score(params):
        return anchor_log_pfold(params, feats, clip)

    return score, feats
