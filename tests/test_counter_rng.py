"""The counter-based generator (ops/counter_rng.py) and the packed engine's
generator mode that draws from it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from montecarlo_tpu.engine.state import TableConfig
from montecarlo_tpu.ops import pallas_engine as pe
from montecarlo_tpu.ops.counter_rng import bits, mix32, stream_keys, uniform_int


def test_mix32_is_a_bijection_on_a_slice():
    x = jnp.arange(1 << 20, dtype=jnp.uint32) * jnp.uint32(2654435761)
    y = np.asarray(mix32(x))
    assert np.unique(y).size == y.size


def test_no_reuse_across_tables_steps_and_draws():
    """Distinct tables get distinct keys; within a table, distinct
    (step, draw) counters give distinct words (both maps are bijections),
    and the engine's per-step draw slots never overlap."""
    keys = np.asarray(stream_keys(7, jnp.arange(1 << 18)))
    assert np.unique(keys).size == keys.size
    ctr = jnp.arange(1 << 16)
    for key in keys[:4]:
        words = np.asarray(bits(jnp.uint32(key), ctr))
        assert np.unique(words).size == words.size
    # slot layout of one step: policy 0-1, Gumbel 2..2+4, deal 32..32+17
    slots = [0, 1] + list(range(2, 6)) + list(range(pe.DEAL_DRAW,
                                                    pe.DEAL_DRAW + 17))
    assert len(set(slots)) == len(slots) and max(slots) < pe.STEP_DRAWS


@pytest.mark.parametrize("bound", [2, 13, 20, 52])
def test_uniform_int_is_uniform(bound):
    n = 1 << 18
    keys = stream_keys(3, jnp.arange(n // 4))
    draws = np.concatenate([np.asarray(uniform_int(keys, c, bound))
                            for c in range(4)])
    assert draws.min() >= 0 and draws.max() < bound
    counts = np.bincount(draws, minlength=bound)
    expected = n / bound
    chi2 = float(np.sum((counts - expected) ** 2 / expected))
    # chi-square with bound-1 dof: mean bound-1, sd sqrt(2(bound-1))
    assert chi2 < (bound - 1) + 6 * np.sqrt(2 * (bound - 1)), chi2


def test_sample_cards_are_distinct_and_uniform():
    key = stream_keys(11, jnp.arange(1 << 14).reshape(16, 1024))
    cards = np.asarray(pe._sample_cards(key, 5, 17))  # [17, 16, 1024]
    flat = cards.reshape(17, -1).T
    assert flat.min() >= 0 and flat.max() < 52
    assert all(np.unique(row).size == 17 for row in flat[:2048])
    counts = np.bincount(flat[:, 0], minlength=52)  # first card: uniform
    expected = flat.shape[0] / 52
    assert float(np.sum((counts - expected) ** 2 / expected)) < 51 + 6 * 10.1


def test_generator_mode_block_offset_matches_whole_run():
    """A shard that passes its global block offset draws exactly what one
    device draws for the same tables (the sharded runner relies on it)."""
    cfg = TableConfig(num_seats=6)
    state = pe.initial_packed_state(3, cfg, 2 * pe.TABLES_PER_BLOCK)
    whole = np.asarray(pe.run_perpetual_prng(9, state, 6, 16, 5, 10))
    parts = [np.asarray(pe.run_perpetual_prng(
        9, state[b:b + 1], 6, 16, 5, 10, block0=b)) for b in range(2)]
    assert np.array_equal(whole, np.concatenate(parts))
    assert not np.array_equal(whole[0], whole[1])


def test_generator_mode_matches_random_policy_statistics():
    """Generator mode against the XLA engine under
    ``rollout.policy.random_policy``: the same game and policy, different
    random streams, so the number of hands a table completes agrees in
    distribution (and the overflow latch stays down). A launch length
    that DEFER does not divide settles every step, as the XLA engine
    does; deferred settlement only adds idle steps between hands."""
    from montecarlo_tpu.rollout.selfplay import play_hands_perpetual

    n_steps = 90
    assert n_steps % pe.DEFER
    cfg = TableConfig(num_seats=6)
    T = 2 * pe.TABLES_PER_BLOCK
    state = pe.run_perpetual_prng(5, pe.initial_packed_state(5, cfg, T), 6,
                                  n_steps, 5, 10)
    hands_k = np.asarray(pe.unpack_field(state, cfg, "hand_ct"))
    assert int(np.asarray(pe.unpack_field(state, cfg, "overflow")).sum()) == 0
    cfg_x = TableConfig(num_seats=6, max_layers=8, max_pot_layers=16)
    final, hands_x = play_hands_perpetual(
        jax.random.split(jax.random.key(5), T), cfg_x, n_steps)
    hands_x = np.asarray(final.hand_idx)

    # completed hands per table: independent samples of the same law
    se = np.sqrt(hands_k.var() / T + hands_x.var() / T)
    assert abs(hands_k.mean() - hands_x.mean()) < 5 * se, (
        hands_k.mean(), hands_x.mean())
    # and the hand lengths match the policy's own (fold 15%, raise 30%)
    assert 10 < n_steps * T / hands_k.sum() < 60
