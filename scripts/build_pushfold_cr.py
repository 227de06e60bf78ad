"""Build the card-removal-correct exact push/fold artifacts.

1. ``data/pushfold_eq169_cr.npz``: [169, 169] class equity matrix where
   entry (a, b) is hero-a's exact all-in equity averaged over every
   disjoint (hero combo, villain combo) pair — one hero representative per
   class (WLOG by suit symmetry) x all 1326 villain combos x all C(48,5)
   boards — plus the true conditional pair counts.
2. ``data/pushfold_ranges_cr.json``: Nash jam/call ranges for 3-20bb from
   ``solve_push_fold_cr`` (conditional combo weighting, no removal
   approximation).

One-time accelerator job (~2.3e12 comparisons).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from montecarlo_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from montecarlo_tpu.models.pushfold import (  # noqa: E402
    matchup_equity_matrix_cr,
    solve_push_fold_cr,
)

DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")


def main():
    t0 = time.perf_counter()
    eq, n_pairs = matchup_equity_matrix_cr(elem_budget=1 << 27,
                                           progress=True)
    dt = time.perf_counter() - t0
    np.savez_compressed(os.path.join(DATA, "pushfold_eq169_cr.npz"),
                        equity=eq, n_pairs=n_pairs)
    print(f"CR matrix built in {dt:.0f}s", file=sys.stderr)

    out = {}
    for s in (3, 4, 5, 6, 8, 10, 12, 15, 20):
        sol = solve_push_fold_cr(eq, n_pairs, stack_bb=float(s))
        out[str(s)] = {
            "jam": sol.jam_range(),
            "call": sol.call_range(),
            "jam_fraction": sol.jam_fraction,
            "call_fraction": sol.call_fraction,
        }
        print(f"{s:>3}bb jam {sol.jam_fraction:.3f} "
              f"call {sol.call_fraction:.3f}", file=sys.stderr)
    with open(os.path.join(DATA, "pushfold_ranges_cr.json"), "w") as f:
        json.dump({"stacks_bb": out,
                   "source": "matchup_equity_matrix_cr (exact, "
                             "card-removal-correct)"}, f, indent=1)
    print(json.dumps({"built": True, "seconds": dt,
                      "jam10": out["10"]["jam_fraction"],
                      "call10": out["10"]["call_fraction"]}))


if __name__ == "__main__":
    main()
