from .diffusion import Diffusion, create_diffusion  # noqa: F401
from .schedules import (DiffusionSchedule, get_named_beta_schedule,  # noqa: F401
                        make_schedule, space_timesteps)
