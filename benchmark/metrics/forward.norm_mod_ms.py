"""Device milliseconds per denoise step in the program's
``forward.norm_mod`` spans: each block's layer or RMS norms before a
linear and their ``·(1 + scale) + shift``, timed by the program with CUDA
events in the traced steps."""

import spans


def read(m):
    return spans.device_ms_per_step(m, "forward.norm_mod")
