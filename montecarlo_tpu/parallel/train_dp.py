"""Data-parallel REINFORCE over the device mesh.

The scaling recipe for training: replicate the (tiny) policy parameters,
shard the self-play table batch over the ``tables`` mesh axis, compute
local score-function gradients, and ``psum`` them over the mesh — the
classic DP layout, with the rollout *generation* itself on-device per shard (no
host in the loop).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from montecarlo_tpu.engine.state import TableConfig, init_state
from montecarlo_tpu.models.policy_net import MLPParams
from montecarlo_tpu.models.train import _play_hand_collect
from montecarlo_tpu.parallel.mesh import AXIS
from montecarlo_tpu.rollout.policy import random_policy

F32 = jnp.float32
I32 = jnp.int32


def make_dp_grad_fn(
    mesh: Mesh,
    cfg: TableConfig,
    opponent: Callable = random_policy,
    tables_per_device: int = 256,
    max_steps: int = 48,
):
    """Jitted ``(params, key) -> (grads, mean_reward_bb)`` of one
    advantage-normalized REINFORCE batch of ``n_dev * tables_per_device``
    tables, gradients psum-reduced over the mesh.

    Table keys and learner seats are indexed GLOBALLY (device d plays
    tables ``d * tables_per_device ..``), so the batch a key selects does
    not depend on the mesh: one device with ``n_dev * tables_per_device``
    tables computes the same gradients up to float summation order."""
    n_dev = mesh.devices.size
    bb = float(cfg.big_blind)
    n_global = n_dev * tables_per_device

    def local_rollouts(params: MLPParams, key):
        first = jax.lax.axis_index(AXIS) * tables_per_device
        table_keys = jax.lax.dynamic_slice_in_dim(
            jax.random.split(key, n_global), first, tables_per_device)
        learner_pos = (first + jnp.arange(tables_per_device)) \
            % cfg.num_seats

        def one(table_key, pos):
            st = init_state(jax.random.fold_in(table_key, 7), cfg)
            return _play_hand_collect(params, st, table_key, pos, opponent,
                                      max_steps, cfg.rules)

        rewards, lps = jax.vmap(one)(table_keys, learner_pos.astype(I32))
        return rewards / bb, lps

    def shard_fn(params, key):
        def loss_fn(params):
            rewards_bb, lps = local_rollouts(params, key)
            # Global advantage baseline over all shards.
            g_mean = jax.lax.pmean(jnp.mean(rewards_bb), AXIS)
            g_var = jax.lax.pmean(
                jnp.mean((rewards_bb - g_mean) ** 2), AXIS)
            adv = (rewards_bb - g_mean) * jax.lax.rsqrt(g_var + 1e-6)
            return -jnp.mean(adv * lps), jnp.mean(rewards_bb)

        (_, local_mean), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        grads = jax.tree.map(lambda g: jax.lax.psum(g, AXIS) / n_dev, grads)
        return grads, jax.lax.pmean(local_mean, AXIS)

    return jax.jit(jax.shard_map(
        shard_fn, mesh=mesh, in_specs=(P(), P()), out_specs=P(),
        check_vma=False))


def make_dp_train_step(
    mesh: Mesh,
    cfg: TableConfig,
    opponent: Callable = random_policy,
    tables_per_device: int = 256,
    lr: float = 3e-3,
    max_steps: int = 48,
):
    """Returns (opt_init, step) where ``step(params, opt_state, key)`` runs
    one advantage-normalized REINFORCE update with gradients psum-reduced
    over the mesh (``make_dp_grad_fn``). Params/optimizer state stay
    replicated."""
    import optax

    opt = optax.adam(lr)
    grad_fn = make_dp_grad_fn(mesh, cfg, opponent, tables_per_device,
                              max_steps)

    @jax.jit
    def step(params, opt_state, key):
        grads, mean_r = grad_fn(params, key)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, mean_r

    return opt.init, step
