"""Policy network: a small MLP over decision features.

Actions are a discrete menu mapped onto the engine's integer encoding
(fold / call / raise-small / raise-pot); illegal raises degrade to calls
through the reference validation clamp, so every menu entry is always
playable.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from montecarlo_tpu.engine.street import bets_needed, bets_total
from montecarlo_tpu.engine.step import head_info
from montecarlo_tpu.models.features import NUM_FEATURES, state_features

F32 = jnp.float32
I32 = jnp.int32

NUM_ACTIONS = 4  # fold, call/check, raise 2bb, raise pot

# Precision of every policy-net product (here and in the packed-block
# engine): full float32. A GPU would otherwise run float32 products in
# TF32; the products are tiny next to the engine step, and one stated
# precision keeps the two net pipelines on the same argmax.
MATMUL_PRECISION = jax.lax.Precision.HIGHEST


class MLPParams(NamedTuple):
    w1: jax.Array
    b1: jax.Array
    w2: jax.Array
    b2: jax.Array
    w3: jax.Array
    b3: jax.Array


def init_params(key, hidden: int = 64) -> MLPParams:
    k1, k2, k3 = jax.random.split(key, 3)

    def dense(k, n_in, n_out):
        scale = jnp.sqrt(2.0 / n_in)
        return (jax.random.normal(k, (n_in, n_out), F32) * scale,
                jnp.zeros((n_out,), F32))

    w1, b1 = dense(k1, NUM_FEATURES, hidden)
    w2, b2 = dense(k2, hidden, hidden)
    w3, b3 = dense(k3, hidden, NUM_ACTIONS)
    return MLPParams(w1, b1, w2, b2, w3, b3)


def policy_logits(params: MLPParams, feats) -> jax.Array:
    """[..., NUM_FEATURES] -> [..., NUM_ACTIONS] in ``MATMUL_PRECISION``."""
    def dense(x, w, b):
        return jnp.matmul(x, w, precision=MATMUL_PRECISION) + b

    h = jax.nn.relu(dense(feats, params.w1, params.b1))
    h = jax.nn.relu(dense(h, params.w2, params.b2))
    return dense(h, params.w3, params.b3)


def action_from_index(idx, state) -> jax.Array:
    """Menu index -> engine action int (action.clj encoding)."""
    seat, _, _ = head_info(state)
    pot = bets_total(state.bets) + jnp.sum(
        jnp.where(jnp.arange(state.pots.capacity) < state.pots.count,
                  state.pots.amt, 0))
    needed = bets_needed(state.bets, seat)
    small_raise = 2 * state.big_blind
    pot_raise = jnp.maximum(pot + needed, small_raise)
    menu = jnp.stack([I32(-1), I32(0),
                      small_raise.astype(I32), pot_raise.astype(I32)])
    return jnp.sum(jnp.where(jnp.arange(NUM_ACTIONS) == idx, menu, 0))


def net_policy(params: MLPParams):
    """Wrap params into the standard policy signature
    ``(key, state, street_raises) -> action``; sampling is categorical over
    the masked menu (folding with nothing owed is a wasted check — masked)."""

    def policy(key, state, street_raises):
        del street_raises
        feats = state_features(state)
        logits = policy_logits(params, feats)
        seat, _, _ = head_info(state)
        free = bets_needed(state.bets, seat) == 0
        logits = logits.at[0].add(jnp.where(free, -1e9, 0.0))
        idx = jax.random.categorical(key, logits)
        return action_from_index(idx, state)

    return policy


def save_params(path: str, params: MLPParams) -> None:
    import numpy as np

    np.savez_compressed(path, **{f"p_{i}": np.asarray(x)
                                 for i, x in enumerate(params)})


def load_params(path: str) -> MLPParams:
    """Load an artifact; feature-set upgrades are applied here.

    Artifacts trained on an older (shorter) feature vector load with
    ``w1`` zero-padded to ``NUM_FEATURES`` input rows — features are only
    ever APPENDED (models/features.py), and a zero row contributes
    nothing, so the upgraded net plays bit-identically to the original.
    """
    import numpy as np

    with np.load(path) as data:
        leaves = [jnp.asarray(data[f"p_{i}"])
                  for i in range(len(MLPParams._fields))]
    w1 = leaves[0]
    if w1.shape[0] < NUM_FEATURES:
        pad = jnp.zeros((NUM_FEATURES - w1.shape[0], w1.shape[1]), w1.dtype)
        leaves[0] = jnp.concatenate([w1, pad], axis=0)
    return MLPParams(*leaves)
