"""Distill solver strategies into policy nets at anchored subgame states.

Round-4 verdict #7/#8 machinery: the relative-fitness training loop
(pool ES) plateaued at an adaptive exploitability of ~1.2 bb/hand, and
both existing attacker families (CMA rule bots, REINFORCE BR) agree on
that number. This module injects *absolute* ground truth instead:

- **Nash distillation** (verdict #8): supervised targets are the CFR+
  average strategy of the exact turn+river subgame solve
  (models/turn_solver.py) at every decision node the artifact game
  reaches, mapped back onto the net's 4-action menu through the same
  correspondence the Nash-gap meter uses in reverse
  (``net_turn_river_strategy``: check=call-menu, bet=pot-raise).
  The distilled net is an init for pool ES whose two-street play
  starts *at* the solver's equilibrium instead of hoping relative
  fitness finds it.

- **Solver-BR distillation** (verdict #7): targets are the one-hot
  best response to a SUBJECT artifact inside the solved subgame
  (``best_response_strategy``), giving a third, structurally
  independent attacker family (neither a linear rule bot nor a
  REINFORCE exploiter) for the exploitability summary.

Early-street behavior is preserved with a self-anchor: the start
params' own action distributions at the scripted preflop/flop prelude
nodes are replayed as targets (KL-to-self), so distillation cannot
silently wreck the streets the solver says nothing about.

All of it is [N, 24] x MLP supervised learning — pure XLA mat-ops,
CPU-friendly, no accelerator needed.

The reference ships no solver or imitation machinery; this is
rebuild-added AI-testing capability for its stated purpose
("test AIs", the reference's README.md:9).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from montecarlo_tpu.engine.street import bets_needed
from montecarlo_tpu.engine.step import head_info
from montecarlo_tpu.models.features import state_features
from montecarlo_tpu.models.policy_net import (
    MLPParams, NUM_ACTIONS, policy_logits,
)
from montecarlo_tpu.models.turn_solver import (
    TurnRiverGame, TurnRiverStrategy, _avg_turn_reaches,
)

F32 = jnp.float32

# no-raise artifact-game lines with real engine states (brc unreachable)
_LINES = ("cc", "xbc", "bc")


class ExampleSet(NamedTuple):
    """A batch of supervised examples for the policy net."""
    feats: jax.Array    # [N, NUM_FEATURES]
    target: jax.Array   # [N, NUM_ACTIONS] rows sum to 1
    fold_masked: jax.Array  # [N] bool: nothing owed -> fold logit masked
    weight: jax.Array   # [N] >= 0 relative example weights


@jax.jit
def _feats_batch(state, head_pos, combos) -> jax.Array:
    """[C, NUM_FEATURES] features with the head's hole swapped per
    combo. One compile serves every node (state is an argument, not a
    closure); river node batches vmap this over the river axis."""
    holes0 = jnp.asarray(state.hole)

    def one(combo):
        s = state._replace(hole=holes0.at[head_pos].set(combo))
        return state_features(s)

    return jax.vmap(one)(combos)


def _node_feats(state, head_pos: int, combos) -> Tuple[jax.Array, bool]:
    """Features for every hero combo at one engine node; plus whether
    the node is free-to-check (fold masked), which depends only on the
    public state. Mirrors net_turn_river_strategy's extraction."""
    feats = _feats_batch(state, jnp.asarray(head_pos), jnp.asarray(combos))
    p, _, _ = head_info(state)
    free = bool(bets_needed(state.bets, p) == 0)
    return feats, free


def _free_target(dist2) -> jax.Array:
    """Tree {check, bet} -> menu [fold, call, raise2bb, raisepot].
    The tree's bet IS the pot-raise (node states measured the bet size
    from menu index 3 — turn_solver.turn_river_node_states)."""
    z = jnp.zeros_like(dist2[..., 0])
    return jnp.stack([z, dist2[..., 0], z, dist2[..., 1]], axis=-1)


def _owed_target(dist) -> jax.Array:
    """Tree {fold, call[, raise]} -> menu columns; raise mass (zero in
    the no-raise artifact game) goes to the pot-raise column."""
    z = jnp.zeros_like(dist[..., 0])
    r = dist[..., 2] if dist.shape[-1] == 3 else z
    return jnp.stack([dist[..., 0], dist[..., 1], z, r], axis=-1)


def _opp_avg(mask0, x) -> jax.Array:
    """Opponent-range average of a per-combo quantity: for hero combo j,
    mean over valid opponent combos i of x[i]. [C] -> [C]."""
    tot = jnp.sum(mask0, axis=0)
    return (mask0.T @ x) / jnp.where(tot > 0, tot, 1.0)


def turn_river_examples(game: TurnRiverGame, combos,
                        turn_states: Dict, river_states: Dict,
                        targets: TurnRiverStrategy,
                        prof_p1: TurnRiverStrategy,
                        prof_p2: TurnRiverStrategy) -> List[ExampleSet]:
    """Supervised examples at every reachable node of the no-raise
    artifact game.

    ``targets`` supplies the action distributions to imitate;
    ``prof_p1``/``prof_p2`` supply the reach profile that weights
    P1-owned / P2-owned nodes (for Nash distillation both are the Nash
    profile; for BR distillation the attacker's nodes follow the
    mixed attacker-vs-subject profile so training mass lands where the
    matchup actually plays). Example weight = own reach x opponent-
    range-average reach x river validity; each street's set is
    normalized to mean weight 1 downstream in ``stack_examples``."""
    mask0 = game.mask0
    C = mask0.shape[0]
    Rn = game.keys.shape[0]
    ones = jnp.ones((C,), F32)

    out: List[ExampleSet] = []

    def emit(state, head_pos, dist, w):
        feats, free = _node_feats(state, head_pos, combos)
        tgt = _free_target(dist) if free else _owed_target(dist)
        out.append(ExampleSet(
            feats, tgt, jnp.full((C,), free), jnp.asarray(w, F32)))

    # ---- turn nodes ----
    t0_1, t1_1 = prof_p1.t0, prof_p1.t1           # P1-owned weighting
    t0_2, t1_2 = prof_p2.t0, prof_p2.t1           # P2-owned weighting
    emit(turn_states["n0"], 0, targets.t0, ones)
    emit(turn_states["n1"], 1, targets.t1, _opp_avg(mask0, t0_2[:, 0]))
    emit(turn_states["n2"], 0, targets.t2,
         t0_1[:, 0] * _opp_avg(mask0, t1_1[:, 1]))
    emit(turn_states["n3"], 1, targets.t3, _opp_avg(mask0, t0_2[:, 1]))

    # ---- river nodes, per line and river card ----
    rho1_1, rho2_1 = _avg_turn_reaches(prof_p1)
    rho1_2, rho2_2 = _avg_turn_reaches(prof_p2)

    for L, lname in enumerate(_LINES):
        ns = river_states[lname]
        valid = 1.0 - game.has_r                      # [Rn, C]

        def vemit(node, head_pos, dist_lr, w_rc):
            """dist_lr: [Rn, C, A] targets; w_rc: [Rn, C] weights."""
            feats = jax.vmap(_feats_batch, in_axes=(0, None, None))(
                ns[node], jnp.asarray(head_pos), jnp.asarray(combos))
            feats = feats.reshape((-1, feats.shape[-1]))
            st0 = jax.tree.map(lambda x: x[0], ns[node])
            _, free = _node_feats(st0, head_pos, combos[:1])
            dist = dist_lr.reshape((-1,) + dist_lr.shape[2:])
            tgt = _free_target(dist) if free else _owed_target(dist)
            out.append(ExampleSet(
                feats, tgt, jnp.full((Rn * C,), free),
                w_rc.reshape(-1)))

        s0_1, s1_1 = prof_p1.s0[L], prof_p1.s1[L]     # [Rn, C, A]
        s0_2, s1_2 = prof_p2.s0[L], prof_p2.s1[L]
        oavg = jax.vmap(lambda x: _opp_avg(mask0, x))  # [Rn, C] -> [Rn, C]
        vemit("n0", 0, targets.s0[L],
              valid * rho1_1[L][None, :] * oavg(valid * rho2_1[L][None, :]))
        vemit("n1", 1, targets.s1[L],
              valid * rho2_2[L][None, :]
              * oavg(valid * rho1_2[L][None, :] * s0_2[:, :, 0]))
        vemit("n2", 0, targets.s2[L],
              valid * rho1_1[L][None, :] * s0_1[:, :, 0]
              * oavg(valid * rho2_1[L][None, :] * s1_1[:, :, 1]))
        vemit("n3", 1, targets.s3[L],
              valid * rho2_2[L][None, :]
              * oavg(valid * rho1_2[L][None, :] * s0_2[:, :, 1]))
    return out


def prelude_examples(params0: MLPParams, prelude_states: Dict,
                     combos) -> List[ExampleSet]:
    """Self-anchor: the START params' own masked action distributions at
    the scripted preflop/flop prelude nodes become targets, so the
    distilled net keeps its early-street behavior."""
    out = []
    for node, state in prelude_states.items():
        head_pos = int(head_info(state)[0])
        feats, free = _node_feats(state, head_pos, combos)
        logits = policy_logits(params0, feats)
        if free:
            logits = logits.at[:, 0].add(-1e9)
        tgt = jax.nn.softmax(logits, axis=-1)
        out.append(ExampleSet(feats, tgt, jnp.full((feats.shape[0],), free),
                              jnp.ones((feats.shape[0],), F32)))
    return out


def stack_examples(sets: List[ExampleSet], min_weight: float = 1e-6
                   ) -> ExampleSet:
    """Concatenate, drop zero-weight rows, normalize to mean weight 1."""
    feats = np.concatenate([np.asarray(s.feats) for s in sets])
    tgt = np.concatenate([np.asarray(s.target) for s in sets])
    fm = np.concatenate([np.asarray(s.fold_masked) for s in sets])
    w = np.concatenate([np.asarray(s.weight) for s in sets])
    keep = w > min_weight
    feats, tgt, fm, w = feats[keep], tgt[keep], fm[keep], w[keep]
    w = w / max(w.mean(), 1e-12)
    return ExampleSet(jnp.asarray(feats), jnp.asarray(tgt),
                      jnp.asarray(fm), jnp.asarray(w))


def _masked_ce(params, ex: ExampleSet, idx) -> jax.Array:
    feats = ex.feats[idx]
    tgt = ex.target[idx]
    fm = ex.fold_masked[idx]
    w = ex.weight[idx]
    logits = policy_logits(params, feats)
    logits = logits + jnp.where(fm[:, None]
                                & (jnp.arange(NUM_ACTIONS) == 0)[None, :],
                                -1e9, 0.0)
    logp = jax.nn.log_softmax(logits, axis=-1)
    ce = -jnp.sum(tgt * jnp.where(tgt > 0, logp, 0.0), axis=-1)
    return jnp.sum(w * ce) / jnp.sum(w)


def distill(params0: MLPParams, data: ExampleSet,
            anchor: ExampleSet = None, steps: int = 2000,
            batch: int = 8192, lr: float = 3e-4,
            anchor_weight: float = 1.0, l2_init: float = 1e-4,
            seed: int = 0, log=None, log_every: int = 200) -> MLPParams:
    """Adam on weighted masked cross-entropy to the solver targets,
    plus the prelude self-anchor and an L2 leash to the start params.

    Full dataset stays device-resident; minibatches are index slices of
    a reshuffled permutation (one jitted update reused throughout)."""
    import optax

    opt = optax.adam(lr)

    def loss_fn(params, idx, aidx):
        loss = _masked_ce(params, data, idx)
        if anchor is not None:
            loss = loss + anchor_weight * _masked_ce(params, anchor, aidx)
        leash = sum(jnp.sum((p - q) ** 2)
                    for p, q in zip(params, params0))
        return loss + l2_init * leash

    @jax.jit
    def update(params, opt_state, idx, aidx):
        loss, grads = jax.value_and_grad(loss_fn)(params, idx, aidx)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    n = data.feats.shape[0]
    an = anchor.feats.shape[0] if anchor is not None else 1
    abatch = min(batch, an)
    rng = np.random.default_rng(seed)
    params, opt_state = params0, opt.init(params0)
    perm, pos = rng.permutation(n), 0
    for t in range(steps):
        if pos + batch > n:
            perm, pos = rng.permutation(n), 0
        idx = jnp.asarray(perm[pos:pos + batch])
        pos += batch
        aidx = jnp.asarray(rng.integers(0, an, size=abatch))
        params, opt_state, loss = update(params, opt_state, idx, aidx)
        if log and (t % log_every == 0 or t == steps - 1):
            log({"step": t, "loss": round(float(loss), 5)})
    return params
