"""Evolution-strategies training at packed-engine speed.

REINFORCE (models/train.py) needs per-action log-prob gradients, so its
rollouts run through the XLA pipeline (~10k hands/s/update at training
shapes). The packed-block engine (ops/pallas_engine.py) meters per-seat
settled deltas on the device at millions of hands/s but is not
differentiable — the natural
way to consume that experience for training is evolution strategies
(Salimans et al. 2017, "Evolution Strategies as a Scalable Alternative
to RL"; public method): sample antithetic Gaussian perturbations of the
policy weights, measure each candidate's bb/hand at its pinned seat with
the engine's meters, and ascend the fitness-weighted perturbation mean

    g = (1 / (pop * sigma)) * sum_i f_std(theta + sigma*eps_i) * eps_i.

Variance control: antithetic pairs (+eps, -eps) and common random
numbers — every candidate in a generation is evaluated on the SAME seed
(same deals), so pair differences cancel card luck. Fitnesses are
standardized per generation.

The evaluator is injectable (tests drive a quadratic toy); the default
is ``selfplay_net_eval_kernel`` — the packed evaluation stack whose
feature/logit path is pinned bit-exact against models/features.py.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from montecarlo_tpu.models.policy_net import MLPParams


def _flatten(params: MLPParams):
    leaves, treedef = jax.tree.flatten(params)
    shapes = [leaf.shape for leaf in leaves]
    sizes = [int(np.prod(s)) for s in shapes]
    vec = jnp.concatenate([jnp.ravel(leaf) for leaf in leaves])
    return vec, (treedef, shapes, sizes)


def _unflatten(vec, spec) -> MLPParams:
    treedef, shapes, sizes = spec
    leaves, off = [], 0
    for shape, size in zip(shapes, sizes):
        leaves.append(jnp.reshape(vec[off:off + size], shape))
        off += size
    return jax.tree.unflatten(treedef, leaves)


class ESResult(NamedTuple):
    params: MLPParams             # center at the best-mean generation
    fitness_history: np.ndarray   # [generations] mean fitness
    best_fitness: float
    hands_total: int
    final_params: Optional[MLPParams] = None  # last-generation center


def train_es(
    seed: int,
    params0: MLPParams,
    eval_fn: Optional[Callable] = None,  # (params, seed) -> (fitness, hands)
    generations: int = 40,
    pop: int = 8,                 # antithetic pairs per generation
    sigma: float = 0.05,
    lr: float = 0.03,
    momentum: float = 0.9,
    mask: Optional[jnp.ndarray] = None,  # 0/1 over the flat vector
    progress: Optional[Callable] = None,
    eval_pop_fn: Optional[Callable] = None,  # ([params], seed) ->
                                             # (fits[2*pop], hands[2*pop])
    noise_floor: float = 0.0,
    center_eval_fn: Optional[Callable] = None,  # (params) -> fitness
    center_eval_every: int = 10,
    checkpoint_fn: Optional[Callable] = None,  # (g, center, best,
                                               #  best_quality) -> None
    adapt_fn: Optional[Callable] = None,  # (g, center) -> None
    adapt_every: int = 0,
) -> ESResult:
    """Antithetic ES ascent on ``eval_fn``'s fitness.

    ``pop`` counts PAIRS: each generation evaluates ``2*pop`` candidates
    plus nothing else (the center is never evaluated — the standardized
    pair differences carry the signal). All candidates in a generation
    share one eval seed (common random numbers). When ``eval_pop_fn`` is
    given it receives the whole generation at once, ordered
    ``[+eps_0, -eps_0, +eps_1, ...]`` — the population-batched kernel
    path (one launch per generation instead of ``2*pop``).

    ``noise_floor`` (same units as fitness) guards against spread
    collapse: fitness is standardized by ``max(std(diff), noise_floor)``,
    so when perturbations stop flipping any action (a saturated policy:
    pair differences below measurement noise) the update damps toward
    zero instead of amplifying noise to a full lr-sized random-walk step
    — the observed failure mode of league-fitness runs, where the center
    drifted off its fitness peak once the spread died. The returned
    ``params`` is the CENTER snapshotted at its best measured quality,
    not the final center. Quality is ``center_eval_fn`` (every
    ``center_eval_every`` generations, plus the last) when given — use a
    FIXED holdout seed inside it so snapshots share common random
    numbers and the argmax is not a winner's curse over per-generation
    deal noise (measured: a +0.19 bb best-mean generation whose center
    evaluated at ~0 on a fresh seed). Fallback: best per-generation mean.
    """
    assert (eval_fn is None) != (eval_pop_fn is None), \
        "exactly one of eval_fn / eval_pop_fn"
    vec, spec = _flatten(params0)
    vel = jnp.zeros_like(vec)
    key = jax.random.key(seed)
    hist, hands_total, best = [], 0, -np.inf
    best_mean, best_vec = -np.inf, vec

    for g in range(generations):
        if adapt_fn is not None and adapt_every > 0 \
                and g % adapt_every == 0:
            # Adaptive opponent refresh (the answer to probe->retrain
            # whack-a-mole): the caller re-attacks the CURRENT center
            # (e.g. a short CMA run over the rule-bot families,
            # scripts/opt_bot.quick_attack) and swaps the discovered
            # attacker into its opponent pool IN PLACE — the pool
            # evaluator iterates its opponents list per call, so the
            # very next generation trains against the refreshed
            # attacker. Runs at g=0 too (attack the start center).
            adapt_fn(g, _unflatten(vec, spec))
        key, kp = jax.random.split(key)
        eps = jax.random.normal(kp, (pop, vec.shape[0]), vec.dtype)
        if mask is not None:
            # restrict the search to a parameter subspace (ES progress per
            # generation scales like pop/dim — masking trades ceiling for
            # speed on small populations)
            eps = eps * mask[None]
        eval_seed = seed * 1_000_003 + g
        fits = np.zeros((pop, 2))
        if eval_pop_fn is not None:
            cands = [_unflatten(vec + sgn * sigma * eps[i], spec)
                     for i in range(pop) for sgn in (1.0, -1.0)]
            fs, hs = eval_pop_fn(cands, eval_seed)
            fits[:] = np.asarray(fs).reshape(pop, 2)
            hands_total += int(np.sum(hs))
        else:
            for i in range(pop):
                for j, sgn in enumerate((1.0, -1.0)):
                    cand = _unflatten(vec + sgn * sigma * eps[i], spec)
                    f, h = eval_fn(cand, eval_seed)
                    fits[i, j] = f
                    hands_total += h
        mean_fit = float(fits.mean())
        hist.append(mean_fit)
        best = max(best, float(fits.max()))
        if center_eval_fn is not None:
            if g % center_eval_every == 0 or g == generations - 1:
                cf = float(center_eval_fn(_unflatten(vec, spec)))
                if cf > best_mean:
                    best_mean, best_vec = cf, vec
                if checkpoint_fn is not None:
                    # durable progress: persist the current center +
                    # best-so-far so a --resume relaunch of a killed run
                    # loses at most ``center_eval_every`` generations.
                    checkpoint_fn(g, _unflatten(vec, spec),
                                  _unflatten(best_vec, spec), best_mean)
        elif mean_fit > best_mean:
            # the generation's candidates are vec +/- sigma*eps; their
            # mean fitness estimates the CENTER's (antithetic pairs
            # cancel the O(sigma) term) — snapshot before updating.
            best_mean, best_vec = mean_fit, vec
        # standardized antithetic ascent direction. Fitness is
        # standardized per generation, so the direction has unit-free
        # O(1/sqrt(pop)) coordinates; lr directly sets the weight-space
        # step size (no 1/sigma factor — that rescaling blows up small
        # populations).
        diff = (fits[:, 0] - fits[:, 1]) / 2.0       # [pop]
        std = max(float(diff.std()), noise_floor) + 1e-8
        w = jnp.asarray(diff / std, vec.dtype)
        grad = (w[:, None] * eps).mean(axis=0)
        vel = momentum * vel + (1.0 - momentum) * grad
        vec = vec + lr * vel
        if progress is not None:
            progress(g, mean_fit, float(fits.max()),
                     float(fits.max() - fits.min()))

    return ESResult(_unflatten(best_vec, spec), np.asarray(hist), best,
                    hands_total, _unflatten(vec, spec))


def layer_mask(params: MLPParams, names) -> jnp.ndarray:
    """0/1 flat-vector mask selecting the given MLPParams field names."""
    vec_parts = []
    for field, leaf in zip(params._fields, jax.tree.leaves(params)):
        val = 1.0 if field in names else 0.0
        vec_parts.append(jnp.full((int(np.prod(leaf.shape)),), val,
                                  jnp.float32))
    return jnp.concatenate(vec_parts)


def kernel_eval_fn(cfg, net_seats: int = 1, n_tables: int = 1 << 14,
                   n_steps: int = 256):
    """Fitness = mean bb/hand at the lowest pinned net seat, measured by
    the packed engine's seat-delta meters."""
    from montecarlo_tpu.ops.pallas_engine import (
        initial_packed_state, selfplay_net_eval_kernel,
    )

    seat = int(np.log2(net_seats & -net_seats))  # lowest set bit
    cache = {}

    def eval_fn(params, eval_seed: int):
        # All candidates in an ES generation share eval_seed (common
        # random numbers): build the initial decks once per generation.
        if eval_seed not in cache:
            cache.clear()
            cache[eval_seed] = initial_packed_state(eval_seed, cfg,
                                                    n_tables)
        means, _, hands = selfplay_net_eval_kernel(
            eval_seed, cfg, params, net_seats=net_seats,
            n_tables=n_tables, n_steps=n_steps, state0=cache[eval_seed])
        return float(means[seat]), int(hands)

    return eval_fn


def kernel_eval_pop_fn(cfg, net_seats: int = 1, n_tables: int = 1 << 14,
                       n_steps: int = 256):
    """Population form of ``kernel_eval_fn``: the whole ES generation in
    one call per chunk (candidate axis vmapped; the shared-seed
    common-random-numbers property holds by construction — the engine's
    generator stream depends only on the table index)."""
    from montecarlo_tpu.ops.pallas_engine import (
        initial_packed_state, selfplay_net_eval_pop,
    )

    seat = int(np.log2(net_seats & -net_seats))  # lowest set bit
    cache = {}

    def eval_pop(params_list, eval_seed: int):
        if eval_seed not in cache:
            cache.clear()
            cache[eval_seed] = initial_packed_state(eval_seed, cfg,
                                                    n_tables)
        means, _, hands = selfplay_net_eval_pop(
            eval_seed, cfg, params_list, net_seats=net_seats,
            n_tables=n_tables, n_steps=n_steps, state0=cache[eval_seed])
        return means[:, seat], hands

    return eval_pop


def kernel_league_eval_pop_fn(cfg, opponent, n_tables: int = 1 << 14,
                              n_steps: int = 256, seat: int = 0):
    """League-fitness population evaluator: each candidate plays seat
    ``seat`` against a FIXED trained ``opponent`` net at every other
    seat (banked kernel) — fitness measured against the opponent
    distribution that matters instead of against random players (whose
    exploitation does not transfer; PERF.md head-to-head finding)."""
    from montecarlo_tpu.ops.pallas_engine import (
        initial_packed_state, selfplay_net_league_pop,
    )

    cache = {}

    def eval_pop(params_list, eval_seed: int):
        if eval_seed not in cache:
            cache.clear()
            cache[eval_seed] = initial_packed_state(eval_seed, cfg,
                                                    n_tables)
        seat_to_bank = tuple(0 if k == seat else 1
                             for k in range(cfg.num_seats))
        means, _, hands = selfplay_net_league_pop(
            eval_seed, cfg, params_list, opponent,
            n_tables=n_tables, n_steps=n_steps,
            seat_to_bank=seat_to_bank, state0=cache[eval_seed])
        return means[:, seat], hands

    return eval_pop


def kernel_pool_eval_pop_fn(cfg, opponents, n_tables: int = 1 << 14,
                            n_steps: int = 256, seat: int = 0):
    """Opponent-POOL fitness: mean over pool members of the candidate's
    bb/hand. ``opponents`` entries are ``None`` (PRNG random opponents —
    the plain net-eval pop kernel), an ``MLPParams`` opponent (banked
    league pop kernel; rule bots from ``models/bots.py`` slot in here as
    nets), or a ``(params_or_None, geometry)`` tuple where geometry is

    - ``"five"`` (default): the candidate sits ALONE at ``seat`` against
      P-1 copies of the opponent — fitness = candidate's seat bb/hand;
    - ``"lone"``: the OPPONENT sits alone at ``seat`` against P-1 copies
      of the candidate — fitness = SUM over the candidate's seats
      (= minus the opponent's bb/hand under exact conservation, the
      same scale as the probe's extraction number).

    Round 3 measured the two geometries differing by 0.7 bb/hand on the
    jam matchup (training five-vs-one closed only the five-vs-one hole);
    pooling both makes the fitness see the seating the probe measures.

    One launch per (generation, pool member); all members share the
    per-seed initial state, so every member plays the same decks and
    the fitness differences across members carry opponent identity
    only (common random numbers along a second axis).

    ``opponents`` is re-read on every call (weights are runtime kernel
    inputs, so shapes never change): callers may replace entries IN
    PLACE between generations — the ``train_es`` adaptive-attacker
    hook (``adapt_fn``/``adapt_every``) relies on exactly this.
    """
    from montecarlo_tpu.ops.pallas_engine import (
        initial_packed_state, selfplay_net_eval_pop,
        selfplay_net_league_pop,
    )

    assert len(opponents) >= 1
    P = cfg.num_seats
    cache = {}

    def eval_pop(params_list, eval_seed: int):
        if eval_seed not in cache:
            cache.clear()
            cache[eval_seed] = initial_packed_state(eval_seed, cfg,
                                                    n_tables)
        s0 = cache[eval_seed]
        tot, hands_sum = None, 0
        for entry in opponents:
            # MLPParams is a NamedTuple (tuple subclass): only a plain
            # 2-tuple ending in a geometry string is (opp, geom).
            if (type(entry) is tuple and len(entry) == 2
                    and isinstance(entry[1], str)):
                opp, geom = entry
            else:
                opp, geom = entry, "five"
            cand_seats = ([seat] if geom == "five"
                          else [k for k in range(P) if k != seat])
            if opp is None:
                net_seats = sum(1 << k for k in cand_seats)
                m, _, h = selfplay_net_eval_pop(
                    eval_seed, cfg, params_list, net_seats=net_seats,
                    n_tables=n_tables, n_steps=n_steps, state0=s0)
            else:
                stb = tuple(0 if k in cand_seats else 1
                            for k in range(P))
                m, _, h = selfplay_net_league_pop(
                    eval_seed, cfg, params_list, opp,
                    n_tables=n_tables, n_steps=n_steps,
                    seat_to_bank=stb, state0=s0)
            vals = np.asarray(m)[:, cand_seats]
            # "lone": the candidate's seat SUM = exactly -(opponent's
            # bb/hand) under exact conservation — same scale as the
            # probe's extraction number and as the "five" components.
            # The seat MEAN would enter the pool average at 1/(P-1) the
            # magnitude, underweighting the very holes the probe
            # measures.
            f = vals.sum(axis=1) if geom == "lone" else vals.mean(axis=1)
            tot = f if tot is None else tot + f
            hands_sum += int(np.sum(h))
        return tot / len(opponents), hands_sum

    return eval_pop
