"""Learnable poker agents: the model family on top of the table engine.

The reference exists "to test AIs" (``README.md:9``) but contains none.
Here the engine's pure step function makes the whole game differentiable-
adjacent: a policy network plays millions of vmapped hands per second and
trains with REINFORCE entirely on device (features, the MLP and the game
itself in one jitted program, the same ``lax.scan`` as self-play).
"""

from montecarlo_tpu.models.features import state_features, NUM_FEATURES  # noqa: F401
from montecarlo_tpu.models.policy_net import (  # noqa: F401
    NUM_ACTIONS,
    action_from_index,
    init_params,
    net_policy,
    policy_logits,
)
from montecarlo_tpu.models.train import train_policy  # noqa: F401
