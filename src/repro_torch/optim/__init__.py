"""Tree optimizers of the port's LM trainer."""
from repro_torch.optim.optimizers import (  # noqa: F401
    OptState,
    accel_point,
    init_optimizer,
    make_optimizer,
    polyak_init,
    polyak_update,
)
