"""Device milliseconds per denoise step in the program's
``forward.gate_res`` spans: the gated residual adds ``x + gate·y`` (and
the single block's concat before its output linear), timed by the program
with CUDA events in the traced steps."""

import spans


def read(m):
    return spans.device_ms_per_step(m, "forward.gate_res")
