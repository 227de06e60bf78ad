"""REINFORCE self-play training for the policy network.

The game itself is the engine's ``lax.scan`` (ints, non-differentiable);
the score-function estimator only needs gradients of the action log-probs,
which flow through the MLP. Rewards are settled chip deltas in big blinds,
advantage-normalized across the table batch. Everything — feature
extraction, the network, the game, the gradient — is one jitted program.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from montecarlo_tpu.engine.street import bets_needed
from montecarlo_tpu.engine.state import TableConfig, init_state
from montecarlo_tpu.engine.step import (
    _pick,
    _select_tree,
    clamp_action,
    head_info,
    settle_showdown,
    step_action,
)
from montecarlo_tpu.models.features import state_features
from montecarlo_tpu.models.policy_net import (
    MLPParams,
    action_from_index,
    init_params,
    policy_logits,
)
from montecarlo_tpu.rollout.policy import random_policy

F32 = jnp.float32
I32 = jnp.int32


def _play_hand_collect(params, state, key, learner_pos, opponent,
                       max_steps: int, rules: str):
    """Play one hand; return (learner chip delta, sum of learner log-probs)."""
    start_stack = _pick(state.stacks, learner_pos) + jnp.where(
        learner_pos == 0, state.small_blind,
        jnp.where(learner_pos == 1, state.big_blind, 0))

    def body(carry, k):
        st, lp, street_raises = carry
        k_net, k_opp = jax.random.split(k)
        seat, _, exists = head_info(st)
        is_learner = (seat == learner_pos) & exists & ~st.hand_over

        feats = state_features(st)
        logits = policy_logits(params, feats)
        # Same fold mask as net_policy (policy_net.py): folding is masked
        # exactly when the actor owes nothing — train/eval distributions match.
        free = bets_needed(st.bets, seat) == 0
        logits = logits.at[0].add(jnp.where(free, -1e9, 0.0))
        idx = jax.random.categorical(k_net, logits)
        logprob = jax.nn.log_softmax(logits)[idx]
        learner_action = action_from_index(idx, st)

        opp_action = opponent(k_opp, st, street_raises)
        action = clamp_action(
            st, jnp.where(is_learner, learner_action, opp_action))
        prev_stage = st.stage
        nxt = step_action(st, action, rules=rules)
        applied_raise = (action > 0) & ~st.hand_over
        street_raises = jnp.where(nxt.stage != prev_stage, 0,
                                  street_raises + applied_raise)
        return (nxt, lp + jnp.where(is_learner, logprob, 0.0),
                street_raises), None

    keys = jax.random.split(key, max_steps)
    (state, lp, _), _ = jax.lax.scan(
        body, (state, jnp.zeros((), F32), jnp.zeros((), I32)), keys)
    state = _select_tree(state.hand_over,
                         settle_showdown(state, rules=rules), state)
    reward = (_pick(state.stacks, learner_pos) - start_stack).astype(F32)
    return reward, lp


class TrainResult(NamedTuple):
    params: MLPParams
    mean_reward_bb: jax.Array  # [steps] learner bb/hand per update


def make_update_step(
    cfg: TableConfig,
    opponent: Callable = random_policy,
    tables: int = 2048,
    lr: float = 3e-3,
    max_steps: int = 48,
):
    """(opt_init, update) where ``update(params, opt_state, key)`` plays
    ``tables`` fresh hands and applies one advantage-normalized REINFORCE
    step. One jitted program per update (the host loop in
    ``train_policy`` drives it)."""
    import optax

    opt = optax.adam(lr)
    bb = float(cfg.big_blind)

    def loss_fn(params, step_key):
        table_keys = jax.random.split(step_key, tables)
        learner_pos = (jnp.arange(tables) % cfg.num_seats).astype(I32)

        def one(table_key, pos):
            st = init_state(jax.random.fold_in(table_key, 7), cfg)
            return _play_hand_collect(params, st, table_key, pos, opponent,
                                      max_steps, cfg.rules)

        rewards, lps = jax.vmap(one)(table_keys, learner_pos)
        rewards_bb = rewards / bb
        adv = (rewards_bb - jnp.mean(rewards_bb)) / (
            jnp.std(rewards_bb) + 1e-6)
        return -jnp.mean(adv * lps), jnp.mean(rewards_bb)

    @jax.jit
    def update(params, opt_state, key):
        (_, mean_r), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, key)
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        return params, opt_state, mean_r

    return opt.init, update


def train_policy(
    key,
    cfg: TableConfig = TableConfig(num_seats=2, rules="standard"),
    opponent: Callable = random_policy,
    tables: int = 2048,
    steps: int = 100,
    lr: float = 3e-3,
    max_steps: int = 48,
) -> TrainResult:
    """REINFORCE loop: at each update the learner plays ``tables`` fresh
    hands against ``opponent`` (alternating blinds across the batch) and
    ascends the advantage-weighted log-likelihood. Host-level loop over
    jitted updates (the executable is compiled once)."""
    params = init_params(key)
    opt_init, update = make_update_step(cfg, opponent, tables, lr, max_steps)
    opt_state = opt_init(params)
    history = []
    for i in range(steps):
        params, opt_state, mean_r = update(
            params, opt_state, jax.random.fold_in(key, 1000 + i))
        history.append(mean_r)
    return TrainResult(params=params,
                       mean_reward_bb=jnp.stack(history))
