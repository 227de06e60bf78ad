"""League-kernel routing diagnostic with extreme deterministic nets.

bank "callbot" has b3 = [0, +100, 0, 0] (always check/call); bank
"raisebot" has b3 = [0, 0, 0, +100] (always pot-raise).  With
seat_to_bank = (0, 1, 1, 1, 1, 1):

- [callbot, raisebot]: seat 0 passively calls into five pot-raisers;
- [raisebot, callbot]: seat 0 pot-raises five calling stations.

If the per-seat bank selection works, seat 0's bb/hand differs
dramatically between the two orderings (and the pop kernel's two
candidates differ likewise).  If the selection collapses to a constant
bank, every case degenerates to self-play and all numbers are ~0 —
which would also explain the flat league-ES fitness (mean == best every
generation, /tmp/train_league.log) and make the committed ES2-vs-
REINFORCE "tie" an artifact.

Run on the GPU:
    python scripts/check_league_routing.py
"""
import jax

from montecarlo_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import json

import numpy as np

from montecarlo_tpu.engine.state import TableConfig
from montecarlo_tpu.models.policy_net import init_params
from montecarlo_tpu.ops.pallas_engine import (
    selfplay_net_league, selfplay_net_league_pop,
)


def biased_net(key, action: int):
    p = init_params(key)
    b3 = np.zeros(4, np.float32)
    b3[action] = 100.0
    return p._replace(w3=p.w3 * 0.0, b3=jax.numpy.asarray(b3))


def main():
    cfg = TableConfig(num_seats=6)
    callbot = biased_net(jax.random.key(1), 1)
    raisebot = biased_net(jax.random.key(2), 3)
    stb = (0, 1, 1, 1, 1, 1)

    for name, banks in (("call_at_seat0_vs_raisers", [callbot, raisebot]),
                        ("raise_at_seat0_vs_callers", [raisebot, callbot])):
        m, e, h = selfplay_net_league(991, cfg, banks, stb,
                                      n_tables=1 << 14, n_steps=256)
        print(json.dumps({"case": name,
                          "per_seat_bb": [round(float(x), 4) for x in m],
                          "seat0_stderr": round(float(e[0]), 4),
                          "hands": int(h)}), flush=True)

    m, _, h = selfplay_net_league_pop(991, cfg, [callbot, raisebot],
                                      raisebot, n_tables=1 << 14,
                                      n_steps=256)
    print(json.dumps({"case": "pop_cand0_call_cand1_raise_vs_raise_opp",
                      "cand_seat0_bb": [round(float(m[0, 0]), 4),
                                        round(float(m[1, 0]), 4)],
                      "hands": [int(x) for x in h]}), flush=True)


if __name__ == "__main__":
    main()
