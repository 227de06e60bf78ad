"""The Triton equity kernels (ops/pallas_equity.py) in interpret mode:
against exact enumeration and the XLA rollouts, their per-program
partial counts, int32-safe planning, sharding by lane offset, and the
routing that picks them on a GPU."""

import functools

import jax
import numpy as np
import pytest

from montecarlo_tpu.cards import make_card
from montecarlo_tpu.ops import pallas_equity as pe
from montecarlo_tpu.rollout import equity as eqm

AKS = [make_card(0, 14), make_card(0, 13)]
QQ = [make_card(1, 12), make_card(2, 12)]


def _z(est, exact, n):
    return (est - exact) / np.sqrt(exact * (1 - exact) / n)


@pytest.mark.parametrize("board", [(), (make_card(3, 2), make_card(3, 9),
                                        make_card(1, 5))])
def test_vs_hand_kernel_matches_exact(board):
    w, t, n = pe.equity_vs_hand_pallas(5, AKS, QQ, 1 << 15, board=board,
                                       interpret=True)
    assert n >= 1 << 15 and 0 <= w and w + t <= n
    exact = eqm.equity_exact(AKS, QQ, board=board).equity
    assert abs(_z((w + 0.5 * t) / n, exact, n)) < 5


def test_sweep_kernel_matches_xla_rollouts():
    heroes = [[make_card(0, 14), make_card(1, 14)],
              [make_card(0, 7), make_card(1, 2)]]
    eq, n = pe.equity_sweep_pallas(3, heroes, 1 << 14, interpret=True)
    for h, e in zip(heroes, eq):
        ref = eqm.equity_vs_random(jax.random.key(4), h, 1 << 15,
                                   batch_size=1 << 13)
        se = np.sqrt(e * (1 - e) * (1 / n + 1 / ref.n))
        assert abs(e - ref.equity) < 5 * se


def test_showdown_partials_conserve_shares():
    """Every rollout hands out exactly ``scale`` share units, so each
    program's shares sum to scale * BLOCK * n_iter; joint wins of hand 0
    never exceed its share."""
    params, N, n_dead = pe.showdown_params(9, [AKS, QQ])
    n_programs, n_iter = 3, 2
    parts = np.asarray(pe.showdown_counts(params, N, n_dead, n_programs,
                                          n_iter, 2, interpret=True))
    assert parts.shape == (N + 1, n_programs)
    assert np.all(parts[0] + parts[1] == 2 * pe.BLOCK * n_iter)
    assert np.all(parts[2] <= parts[0])


def test_sweep_partials_are_per_program():
    heroes = [[make_card(0, 14), make_card(1, 14)]]
    w, t = pe.sweep_counts(pe.sweep_params(1, heroes), 1, 4, 3,
                           interpret=True)
    w, t = np.asarray(w), np.asarray(t)
    assert w.shape == t.shape == (1, 4)
    assert np.all(w + t <= pe.BLOCK * 3) and np.all(w > 0)


@pytest.mark.parametrize("n", [1, 255, 1 << 20, 1 << 33, 10**11])
@pytest.mark.parametrize("scale", [1, 2, 6])
def test_plan_covers_n_within_int32(n, scale):
    n_programs, n_iter = pe._plan(n, scale)
    assert n_programs * pe.BLOCK * n_iter >= n
    assert scale * pe.BLOCK * n_iter <= 2**31 - 1  # per-program partial
    assert n_programs * pe.BLOCK * n_iter < n + n_programs * pe.BLOCK * 2


def test_sharded_kernel_uses_distinct_lanes():
    """Over the 8-device mesh each device draws its own lanes: the
    sharded count differs from eight copies of one device's count, and
    the estimate stays within 5 sigma of exact."""
    from montecarlo_tpu.parallel.mesh import _vs_hand_kernel, make_mesh

    mesh = make_mesh()
    res = _vs_hand_kernel(mesh, 7, AKS, QQ, 8 << 12, interpret=True)
    one = _vs_hand_kernel(make_mesh(jax.devices()[:1]), 7, AKS, QQ,
                          1 << 12, interpret=True)
    assert res.n == 8 * one.n
    assert res.wins != 8 * one.wins
    assert abs(_z(res.equity, eqm.equity_exact(AKS, QQ).equity,
                  res.n)) < 5


def test_kernel_routing(monkeypatch):
    assert eqm.kernel_impl() == "xla"  # the test suite runs on the CPU
    assert eqm.kernel_impl("triton") == "triton"
    seed = eqm.key_to_seed(jax.random.key(3))
    assert seed == eqm.key_to_seed(jax.random.key(3))
    assert 0 <= seed < 2**31
    monkeypatch.setattr(pe, "equity_vs_hand_pallas", functools.partial(
        pe.equity_vs_hand_pallas, interpret=True))
    res = eqm.equity_vs_hand(jax.random.key(3), AKS, QQ, 1 << 13,
                             impl="triton")
    assert res.n >= 1 << 13 and res.wins + res.ties + res.losses == res.n
