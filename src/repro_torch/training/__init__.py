"""Training on one GPU: loss, train step, fault-tolerant loop, compression
(the port of `repro.training`)."""

from repro_torch.training.trainer import (
    OptimizerStepError,
    Trainer,
    loss_fn,
    make_train_step,
    trainable,
)
