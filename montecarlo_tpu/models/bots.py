"""Handcrafted deterministic baseline bots, packed as policy-net weights.

Each bot is an ``MLPParams`` whose forward pass
(``models/policy_net.py:policy_logits`` — and its in-kernel twin
``ops/pallas_engine._mlp_logits``) produces logits with a dominant gap
implementing a fixed decision rule. Packing the rule into net weights
means every evaluation path that accepts a net (the XLA ``net_policy``,
the net-eval kernel, the B-bank league kernel, server house-bot rooms)
can play the bot with zero new code paths.

Used by ``scripts/exploit_probe.py`` to measure a *static-exploitability
lower bound* for trained artifacts: the best bb/hand any bot in a fixed
panel of simple strategies extracts from the trained net. The reference
has no bots — its stated purpose is "a poker server to test AIs"
(README.md:9); this is evaluation machinery the rebuild adds on top.

Construction notes
------------------
Action menu (policy_net.py): 0=fold, 1=check/call, 2=min-raise (2bb),
3=pot-raise. The fold logit is masked to -1e9 when nothing is owed
(both paths), so "always fold" degenerates to check-when-free.

The threshold bots compute one linear score ``s = v . feats`` and route
it through the ReLU layers as a *rectified pair*: hidden unit 0 carries
``relu(s - t)`` and unit 1 carries ``relu(t - s)`` (b1 = -/+ t), and the
output layer scales them by ``gain`` onto the hi/lo action logits, with
all other logits pushed to -300. ``gain`` = 200 makes the Gumbel sample
deterministic outside a ~2.5/gain band around the threshold (inside it
the bot plays a mix — still a valid fixed strategy for a lower-bound
probe).

**Why the rectified pair, not an affine offset:** a matrix unit may
round its *inputs* to fewer mantissa bits than float32: bf16 (8 bits)
under XLA's default precision on some accelerators, TF32 (10 bits) for a
float32 product on a GPU unless a precision is named. An offset
construction ``h = s + C`` with C=50 feeds the next layer a value whose
bf16 ulp is 0.25 — which silently erases any score term smaller than
that (measured: a made-hand-category bot, s in {0, 0.125}, degenerated
to its lo action everywhere under bf16 input rounding while exact on
CPU). The rectified pair keeps the carried values near zero, where the
rounding is relative (~0.4% in bf16), so the rule survives every
precision at or finer than bf16. TF32 rounds finer than bf16, so every
bf16-safe bound below also holds there; the policy-net products of
this repo run at ``policy_net.MATMUL_PRECISION`` (full float32) in any
case. Trained nets saw the same bf16 rounding of their hidden
activations when they were trained and evaluated (ROADMAP R2).

Feature indices (models/features.py:state_features): 14 = made-hand
category / 8, 16/17 = hole ranks / 14, 18 = suited, 19 = paired.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from montecarlo_tpu.models.features import NUM_FEATURES
from montecarlo_tpu.models.policy_net import MLPParams, NUM_ACTIONS

HIDDEN = 64  # init_params default — the kernels' stacked-weight shape


def _zeros() -> dict:
    return dict(
        w1=np.zeros((NUM_FEATURES, HIDDEN), np.float32),
        b1=np.zeros((HIDDEN,), np.float32),
        w2=np.zeros((HIDDEN, HIDDEN), np.float32),
        b2=np.zeros((HIDDEN,), np.float32),
        w3=np.zeros((HIDDEN, NUM_ACTIONS), np.float32),
        b3=np.zeros((NUM_ACTIONS,), np.float32),
    )


def _params(d: dict) -> MLPParams:
    return MLPParams(**{k: jnp.asarray(v) for k, v in d.items()})


def action_bot(action: int, strength: float = 100.0) -> MLPParams:
    """Always play menu index ``action`` (modulo the free-fold mask)."""
    assert 0 <= action < NUM_ACTIONS
    d = _zeros()
    d["b3"][action] = strength
    return _params(d)


def vector_bot(score_vec, threshold: float, hi: int, lo: int,
               gain: float = 200.0) -> MLPParams:
    """Play ``hi`` when ``score_vec . feats > threshold``, else ``lo``.

    The fully-parametric form of ``threshold_bot``: ``score_vec`` is a
    length-``NUM_FEATURES`` weight vector (any linear rule over the
    policy features). This is the continuous family
    ``scripts/opt_bot.py`` optimizes with CMA-ES to turn the static
    panel's exploitability lower bound into an *adaptive* one.
    """
    assert hi != lo and 0 <= hi < NUM_ACTIONS and 0 <= lo < NUM_ACTIONS
    score_vec = np.asarray(score_vec, np.float32)
    assert score_vec.shape == (NUM_FEATURES,)
    d = _zeros()
    d["w1"][:, 0] = score_vec
    d["w1"][:, 1] = -score_vec
    d["b1"][0] = -threshold   # h1[0] = relu(s - t)
    d["b1"][1] = threshold    # h1[1] = relu(t - s)
    d["w2"][0, 0] = 1.0
    d["w2"][1, 1] = 1.0
    d["w3"][0, hi] = gain     # logits[hi] = gain * relu(s - t)
    d["w3"][1, lo] = gain     # logits[lo] = gain * relu(t - s)
    d["b3"][:] = -300.0
    d["b3"][hi] = 0.0
    d["b3"][lo] = 0.0
    return _params(d)


def ladder_bot(score1, t1: float, score2, t2: float,
               top: int, mid: int, bot: int,
               slope: float = 4.0, cap: float = 0.25) -> MLPParams:
    """Three-way decision ladder: play ``top`` when ``score1.feats > t1``,
    else ``mid`` when ``score2.feats > t2``, else ``bot``.

    The archetype the single-threshold family cannot express: value-raise
    strong / call medium / fold weak ("ABC" poker). Each rule is a
    rectified CAPPED ramp built from a relu pair,
    ``u = relu(slope*(s-t)) - relu(slope*(s-t) - cap)`` = min(relu(.), cap),
    scaled onto its action logit with separated gains (120/60 over a
    constant 30 on ``bot``), so rule 1 strictly dominates rule 2 which
    strictly dominates the fallback once a ramp saturates.

    bf16 safety (see module docstring; TF32 and float32 round finer, so
    the bound holds there too): the ramps saturate at ``cap`` =
    0.25 and the pre-cap hidden values stay O(1) for feature-scale
    scores, so matmul-input rounding (~0.4% relative) perturbs logits by
    <<  the 30+ logit margins. The transition band has width cap/slope
    (~1/16 in score units, about two rank steps of feature 16/17) where
    the bot plays a mix — a valid fixed strategy for a lower-bound probe,
    same caveat as ``vector_bot``'s band.

    SAFE INPUT RANGE: the cap subtraction happens at the w3 matmul
    boundary, whose bf16 input rounding is *absolute* ulp(x) =
    2^(floor(log2 x) - 8). The pair difference stays accurate only while
    ulp(slope*(s-t)) <= cap/4, i.e. |slope*(s-t)| <= 32 — beyond that
    both pair members round together and u collapses toward 0 (the
    ladder would play ``bot`` on its *strongest* hands). The guard below
    bounds the worst case conservatively (features |f| <= 2); large
    searched weights must be pre-normalized — the rule ``s_k > t_k`` is
    invariant under joint (score, threshold) scaling, which only widens
    the mixing band (scripts/opt_bot.py:make_bot does this).
    """
    acts = (top, mid, bot)
    assert len(set(acts)) == 3 and all(0 <= a < NUM_ACTIONS for a in acts)
    d = _zeros()
    for vec, t in ((score1, t1), (score2, t2)):
        vals = (vec.values() if isinstance(vec, dict) else vec)
        smax = 2.0 * float(np.sum(np.abs(np.asarray(list(vals),
                                                    np.float64)))) + abs(t)
        assert slope * smax <= 32.0 + 1e-6, (
            f"ladder rule leaves the bf16-safe range "
            f"(slope*|s-t| bound {slope * smax:.1f} > 32); normalize "
            f"(score, threshold) jointly first — see docstring")
    for k, (vec, t) in enumerate(((score1, t1), (score2, t2))):
        v = np.zeros((NUM_FEATURES,), np.float32)
        items = vec.items() if isinstance(vec, dict) else enumerate(vec)
        for i, w in items:
            v[int(i)] = w
        d["w1"][:, 2 * k] = slope * v
        d["w1"][:, 2 * k + 1] = slope * v
        d["b1"][2 * k] = -slope * t
        d["b1"][2 * k + 1] = -slope * t - cap
    for k in range(4):
        d["w2"][k, k] = 1.0
    for k, (act, gain) in enumerate(((top, 120.0), (mid, 60.0))):
        d["w3"][2 * k, act] = gain / cap
        d["w3"][2 * k + 1, act] = -gain / cap
    d["b3"][:] = -300.0
    d["b3"][top] = 0.0
    d["b3"][mid] = 0.0
    d["b3"][bot] = 30.0
    return _params(d)


def threshold_bot(score: dict[int, float], threshold: float,
                  hi: int, lo: int, gain: float = 200.0) -> MLPParams:
    """Play ``hi`` when ``sum(score[i] * feats[i]) > threshold``, else ``lo``.

    ``score`` maps feature indices to weights; ``hi``/``lo`` are menu
    indices. Other actions get logit -300 (never played).
    """
    vec = np.zeros((NUM_FEATURES,), np.float32)
    for i, w in score.items():
        vec[i] = w
    return vector_bot(vec, threshold, hi, lo, gain)


# Hole-strength score: 0.5*(r0 + r1) + 0.35*paired + 0.08*suited, with
# ranks normalized /14. AA=1.35, QQ=1.21, 88=1.06, 77=0.99, AKs=1.04,
# AKo=0.96, AQs=1.01.
_HOLE = {16: 0.5, 17: 0.5, 19: 0.35, 18: 0.08}
# Made-hand score: category/8 (0=high card, 1/8=pair, 2/8=two pair...).
_MADE = {14: 1.0}
_PAIRPLUS = 0.0625  # between high card (0) and pair (0.125)


def panel() -> dict[str, MLPParams]:
    """The fixed probe panel for static-exploitability measurement."""
    return {
        # pure actions
        "foldbot": action_bot(0),        # folds to any bet, checks free
        "callbot": action_bot(1),        # calling station
        "minraisebot": action_bot(2),    # min-raise every turn
        "potraisebot": action_bot(3),    # pot-raise/jam every turn
        # preflop-strength jam-or-fold (postflop: same hole score)
        "jam_tight": threshold_bot(_HOLE, 1.00, hi=3, lo=0),   # ~88+/AQs+/AKo
        "jam_loose": threshold_bot(_HOLE, 0.85, hi=3, lo=0),
        # fit-or-fold on made-hand category
        "fof_call": threshold_bot(_MADE, _PAIRPLUS, hi=1, lo=0),
        "fof_raise": threshold_bot(_MADE, _PAIRPLUS, hi=3, lo=1),
        # three-way ladders (raise strong / call medium / fold weak —
        # the "ABC" archetype a single threshold cannot express)
        "nit_ladder": ladder_bot(_HOLE, 1.15, _HOLE, 0.95,
                                 top=3, mid=1, bot=0),
        "made_ladder": ladder_bot(_MADE, 3 * _PAIRPLUS, _MADE, _PAIRPLUS,
                                  top=3, mid=1, bot=0),
    }
