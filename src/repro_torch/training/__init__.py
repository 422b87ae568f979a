"""Training on the port: the loss, the train step and the optimizers."""

from .optimizer import (Optimizer, OptState, adafactor, adamw,  # noqa: F401
                        apply_updates, clip_by_global_norm, clip_scale,
                        global_norm, make_optimizer, warmup_cosine)
from .train import (LB_LOSS_COEF, cross_entropy, loss_fn,  # noqa: F401
                    make_train_step)
