"""Counter-based random bits for the engine and the equity rollouts.

A draw is a pure function of ``(seed, stream index, counter)``: nothing is
carried from one draw to the next, so every table (or rollout lane) computes
its own stream in any order, on any device, and a sharded run draws exactly
what a one-device run draws for the same global indices.

- ``stream_keys(seed, index)`` is a bijection of ``index`` for a fixed seed,
  so two tables (lanes) never share a key;
- ``bits(key, counter)`` is a bijection of ``key`` for a fixed counter and of
  ``counter`` for a fixed key, so no (stream, counter) pair repeats a word
  within 2^32 counters.

The mixer is ``lowbias32`` (C. Wellons, hash-prospector): two multiplies and
three xor-shifts, near-ideal avalanche. A bounded draw is one word modulo the
bound; at bounds <= 52 the bias is <= 52 / 2^32 (~1.2e-8) per draw, orders of
magnitude below Monte Carlo noise at any practical sample count.
"""

from __future__ import annotations

import jax.numpy as jnp

U32 = jnp.uint32
I32 = jnp.int32

_GOLDEN = 0x9E3779B9  # odd: multiplication by it permutes uint32


def mix32(x):
    """lowbias32: a bijection on uint32."""
    x = x ^ (x >> 16)
    x = x * U32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * U32(0x846CA68B)
    return x ^ (x >> 16)


def stream_keys(seed, index):
    """Key of stream ``index`` (any int array) under ``seed`` (int scalar)."""
    seed = jnp.asarray(seed).astype(U32)
    return mix32(mix32(seed) ^ (jnp.asarray(index).astype(U32) * U32(_GOLDEN)))


def bits(key, counter):
    """32 random bits: word ``counter`` of the stream ``key``."""
    return mix32(key ^ mix32(jnp.asarray(counter).astype(U32)))


def uniform_int(key, counter, bound: int):
    """Draw in ``[0, bound)`` as int32 (one word, modulo)."""
    return (bits(key, counter) % U32(bound)).astype(I32)
