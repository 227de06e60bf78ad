"""Hand-evaluation ops: the compute-hot kernels of the engine.

- ``ref_evaluator``: slow, obviously-correct Python oracle mirroring the
  reference's naive combinatorial evaluator (``hand_evaluator.clj``).
- ``evaluator``: branchless bitmask evaluator in pure jnp (vmap/jit-safe).
- ``pallas_equity``: fused Pallas kernels on the Triton route (GPU):
  sample + evaluate + reduce, one block of rollouts per program.
"""

from montecarlo_tpu.ops.ref_evaluator import ref_eval5, ref_eval_best  # noqa: F401
from montecarlo_tpu.ops.evaluator import (  # noqa: F401
    eval7_from_cards,
    eval_masks,
    suit_masks_from_cards,
)


def __getattr__(name):
    # Pallas kernels import lazily (they compile for the GPU only).
    if name in ("equity_vs_hand_pallas", "equity_sweep_pallas"):
        import importlib

        return getattr(
            importlib.import_module("montecarlo_tpu.ops.pallas_equity"), name)
    raise AttributeError(name)
