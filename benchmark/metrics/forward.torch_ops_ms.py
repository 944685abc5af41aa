"""Device milliseconds per denoise step in kernels that the frozen map
assigns to no program kernel, library GEMM, attention or convolution:
PyTorch's elementwise ops, norms, RoPE, copies and memsets (over a traced
image, all of its stages' ÷ its denoise steps)."""


def read(m):
    t = m.timeline
    if t is None or not m.traced_steps:
        return None
    steps = m.traced_steps * m.host.get("denoise_steps_per_tick", 1)
    return 1e3 * t.class_s.get("torch_ops", 0.0) / steps
