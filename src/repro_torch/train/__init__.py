"""Training substrate: AdamW, the train step, checkpoint/commit.

The port of :mod:`repro.train`.  The step-commit protocol
(:mod:`repro_torch.train.commit`) is the Jointλ exactly-once protocol
(paper §4.1) applied to training: a step's checkpoint write is the *output
data checkpoint* and the hand-off to the next stage is the *invocation
checkpoint* — duplicated/retried steps collapse to one.
"""

from repro_torch.train.optim import adamw_init, adamw_update  # noqa: F401
from repro_torch.train.step import (TrainState, make_train_step,  # noqa: F401
                                    train_state_shapes)
