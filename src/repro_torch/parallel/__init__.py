"""Training steps (``repro/parallel``). One device for now: the JAX package's
sharding rules, pipeline schedule and multislice exchange are still to port."""

from repro_torch.parallel.steps import (  # noqa: F401
    TrainState,
    init_train_state,
    make_train_step,
    train_state_specs,
)
