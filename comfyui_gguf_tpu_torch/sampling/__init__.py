from .flow_match import (
    euler_sample_inpaint,
    flux_schedule,
    linear_schedule,
    shift_sigmas,
    euler_sample,
    multistep_sample,
    sample_flow,
    set_flow_sampler,
    cfg_wrap,
    FLOW_SAMPLERS,
)

__all__ = ["flux_schedule", "linear_schedule", "shift_sigmas",
           "euler_sample", "multistep_sample", "sample_flow",
           "set_flow_sampler", "euler_sample_inpaint", "cfg_wrap",
           "FLOW_SAMPLERS"]
