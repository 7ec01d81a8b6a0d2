"""Time integration: deterministic and fluctuating BD steppers."""

from rigid_body_light_tpu_torch.dynamics.stepper import (
    StepAux,
    deterministic_step,
    make_differentiable_step,
    make_draws,
    run_bd,
    stochastic_step,
)

__all__ = ["StepAux", "deterministic_step", "make_differentiable_step",
           "make_draws", "run_bd", "stochastic_step"]
