"""montecarlo_tpu — a Monte Carlo Texas Hold'em poker engine in JAX.

A ground-up rebuild of the capabilities of sabraham/Monte-Carlo (a Clojure
core.async poker server) as idiomatic JAX/XLA/Pallas array code, run on
an NVIDIA GPU:

- The game state machine (deal, blinds, betting rounds, pot/side-pot
  splitting, showdown) is a pure fixed-shape ``step`` function, ``vmap``-ed
  over millions of concurrent tables (replaces one go-loop per board/player,
  reference ``board.clj:131-138`` / ``player.clj:58-69``).
- Deck shuffles are counter-based threefry permutations (replaces
  ``(shuffle COMPLETE-DECK)``, reference ``board.clj:148``).
- 7-card hand ranking is a branchless bitmask evaluator (pure jnp and fused
  Pallas kernels on the Triton route), producing a packed uint32 key whose integer order equals
  the reference's lexicographic ``[category hit-ranks kickers]`` compare
  (reference ``hand_evaluator.clj:112-133``).
- Scale-out is ``shard_map``/``pjit`` over a ``jax.sharding.Mesh`` with
  ``psum`` reductions between the cards (the reference has no multi-node
  story).
- The TCP/JSON room protocol (``new_room``/``join_room``/``play``/``hand``/
  ``whoami``, reference ``server.clj``) survives as a thin asyncio host layer
  over the device engine.
"""

from montecarlo_tpu.cards import (  # noqa: F401
    NUM_CARDS,
    card_rank,
    card_suit,
    make_card,
    SUIT_NAMES,
)
from montecarlo_tpu.handval import (  # noqa: F401
    pack_value,
    unpack_value,
    CATEGORY_NAMES,
)

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy top-level API (keeps `import montecarlo_tpu` light; the heavy
    # JAX modules load on first use).
    lazy = {
        "TableConfig": "montecarlo_tpu.engine.state",
        "TableState": "montecarlo_tpu.engine.state",
        "init_state": "montecarlo_tpu.engine.state",
        "step_action": "montecarlo_tpu.engine.step",
        "step_table": "montecarlo_tpu.engine.step",
        "public_board": "montecarlo_tpu.engine.public",
        "play_hands": "montecarlo_tpu.rollout.selfplay",
        "play_hands_perpetual": "montecarlo_tpu.rollout.selfplay",
        "play_tournament": "montecarlo_tpu.rollout.selfplay",
        "tournament_placements": "montecarlo_tpu.rollout.selfplay",
        "equity_vs_hand": "montecarlo_tpu.rollout.equity",
        "equity_vs_random": "montecarlo_tpu.rollout.equity",
        "equity_vs_range": "montecarlo_tpu.rollout.equity",
        "equity_multiway": "montecarlo_tpu.rollout.equity",
        "equity_exact": "montecarlo_tpu.rollout.equity",
        "equity_exact_vs_range": "montecarlo_tpu.rollout.equity",
        "equity_exact_range_vs_range": "montecarlo_tpu.rollout.equity",
        "expand_range": "montecarlo_tpu.rollout.equity",
        "canonical_hands": "montecarlo_tpu.rollout.equity",
        "duplicate_match": "montecarlo_tpu.rollout.evaluate",
        "duplicate_match_multihand": "montecarlo_tpu.rollout.evaluate",
        "make_mesh": "montecarlo_tpu.parallel.mesh",
        "equity_sweep": "montecarlo_tpu.parallel.mesh",
        "train_policy": "montecarlo_tpu.models.train",
        "net_policy": "montecarlo_tpu.models.policy_net",
    }
    if name in lazy:
        import importlib

        return getattr(importlib.import_module(lazy[name]), name)
    raise AttributeError(f"module 'montecarlo_tpu' has no attribute {name!r}")
