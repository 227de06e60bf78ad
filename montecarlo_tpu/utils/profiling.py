"""Observability: profiler traces and throughput/CI meters.

The reference's only observability is bare ``println``s on the hot path
(``board.clj:99-107``, ``helpers.clj:42``). Replacements here:
``jax.profiler`` traces (never print inside jitted code) and host-side
meters for the two BASELINE metrics — rollouts/sec and equity-CI-width at
fixed wall-clock.
"""

from __future__ import annotations

import contextlib
import time


import jax


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a jax.profiler trace (view with TensorBoard/XProf)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def ci_width_at_wallclock(
    key,
    hero,
    villain,
    seconds: float,
    batch_size: int = 1 << 21,
    chunk: int = 32,
):
    """Run hand-vs-hand equity rollouts for ~``seconds`` of wall-clock and
    return the achieved EquityResult (its ci95 width is the BASELINE metric).
    """
    import jax.numpy as jnp

    from montecarlo_tpu.rollout.equity import EquityResult, _equity_vs_hand_device

    hero = jnp.asarray(hero, jnp.int32)
    villain = jnp.asarray(villain, jnp.int32)
    board = jnp.zeros((0,), jnp.int32)
    # Warm/compile outside the budget.
    w, t = _equity_vs_hand_device(key, hero, villain, board, batch_size, chunk)
    _ = int(w) + int(t)

    wins = ties = n = 0
    i = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        w, t = _equity_vs_hand_device(
            jax.random.fold_in(key, 1000 + i), hero, villain, board,
            batch_size, chunk)
        wins += int(w)
        ties += int(t)
        n += batch_size * chunk
        i += 1
    elapsed = time.perf_counter() - t0
    return EquityResult(wins=wins, ties=ties, losses=n - wins - ties, n=n), elapsed
