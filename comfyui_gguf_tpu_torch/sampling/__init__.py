from .flow_match import (
    euler_sample,
    flux_schedule,
    linear_schedule,
    sample_flow,
    shift_sigmas,
)

__all__ = ["flux_schedule", "linear_schedule", "shift_sigmas",
           "euler_sample", "sample_flow"]
