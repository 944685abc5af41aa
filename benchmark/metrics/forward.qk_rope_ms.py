"""Device milliseconds per denoise step in the program's
``forward.qk_rope`` spans: the head split, q/k norms, RoPE and layout
copies before each attention call and the merge of its output, timed by
the program with CUDA events in the traced steps."""

import spans


def read(m):
    return spans.device_ms_per_step(m, "forward.qk_rope")
