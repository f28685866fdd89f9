from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, adam, constant_schedule, cosine_schedule, delay_compensated_sgd,
    momentum, sgd,
    state_template, warmup_cosine,
)
