"""Train a policy network by REINFORCE self-play and measure its edge.

    python scripts/train_policy.py [--steps 300] [--tables 4096]

Trains heads-up vs a random-policy opponent entirely on device, then
reports duplicate-match edges (trained-vs-random and untrained-vs-random)
in bb/hand.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np

from montecarlo_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from montecarlo_tpu.engine.state import TableConfig  # noqa: E402
from montecarlo_tpu.models.policy_net import init_params, net_policy  # noqa: E402
from montecarlo_tpu.models.train import train_policy  # noqa: E402
from montecarlo_tpu.rollout.evaluate import duplicate_match  # noqa: E402
from montecarlo_tpu.rollout.policy import random_policy  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tables", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seats", type=int, default=2)
    ap.add_argument("--save", type=str, default="")
    args = ap.parse_args()

    from montecarlo_tpu.rollout.selfplay import hand_action_bound

    cfg = TableConfig(num_seats=args.seats, rules="standard")
    t0 = time.perf_counter()
    out = train_policy(jax.random.key(0), cfg=cfg, opponent=random_policy,
                       tables=args.tables, steps=args.steps, lr=args.lr,
                       max_steps=hand_action_bound(cfg))
    hist = np.asarray(out.mean_reward_bb)
    dt = time.perf_counter() - t0
    hands = args.steps * args.tables
    print(f"trained {args.steps} updates x {args.tables} hands "
          f"({hands:,} hands) in {dt:.1f}s ({hands / dt:,.0f} hands/s)")
    print(f"reward bb/hand: first10={hist[:10].mean():+.3f} "
          f"last10={hist[-10:].mean():+.3f}")

    for name, params in [("untrained", init_params(jax.random.key(0))),
                         ("trained", out.params)]:
        if args.seats == 2:
            r = duplicate_match(jax.random.key(9), net_policy(params),
                                random_policy, n_tables=8192, cfg=cfg)
            lo, hi = r.ci95
            print(f"{name:9s} vs random: {r.bb_per_hand:+.3f} bb/hand "
                  f"95% CI [{lo:+.3f}, {hi:+.3f}]")
        else:
            # Multiway: the policy in one pinned seat vs randoms, multi-hand
            # mean seat delta in bb/hand.
            import jax as _jax

            from montecarlo_tpu.rollout.evaluate import per_seat_deltas
            from montecarlo_tpu.rollout.policy import pinned_seat_policies
            from montecarlo_tpu.rollout.selfplay import play_hands

            pol = pinned_seat_policies(
                [net_policy(params)] + [random_policy] * (args.seats - 1))
            keys = _jax.random.split(_jax.random.key(9), 4096)
            _, d = play_hands(keys, cfg, num_hands=8, policy=pol,
                              collect_deltas=True)
            bb = per_seat_deltas(d)[:, :, 0].mean(axis=1) / cfg.big_blind
            se = bb.std(ddof=1) / np.sqrt(bb.shape[0])
            print(f"{name:9s} seat-0 vs {args.seats - 1} randoms: "
                  f"{bb.mean():+.3f} bb/hand +/- {1.96 * se:.3f}")

    if args.save:
        from montecarlo_tpu.models.policy_net import save_params

        save_params(args.save, out.params)
        print(f"saved {args.save}")


if __name__ == "__main__":
    main()
