from .flow_match import (
    euler_sample,
    euler_sample_inpaint,
    flux_schedule,
    linear_schedule,
    sample_flow,
    shift_sigmas,
)

__all__ = ["flux_schedule", "linear_schedule", "shift_sigmas",
           "euler_sample", "euler_sample_inpaint", "sample_flow"]
