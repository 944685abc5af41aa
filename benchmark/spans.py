"""The program's own spans, as the per-layer metrics read them: the totals
that ``comfyui_gguf_tpu_torch.observability.totals()`` keeps by span name
(host seconds over the whole run; device seconds of the spans that ran
while the profiler recorded, i.e. in the traced steps only). Each reading
is None where the program keeps no such totals or the span has no
reading."""

from __future__ import annotations


def _record(name: str):
    from comfyui_gguf_tpu_torch import observability

    totals = getattr(observability, "totals", None)
    rec = totals().get(name) if totals is not None else None
    return rec if rec and rec.get("count") else None


def host_s(name: str):
    """Host seconds of every ``name`` span so far (set-up's, for a span
    only the set-up runs)."""
    rec = _record(name)
    return None if rec is None else float(rec["host_s"])


def device_ms_per_step(m, name: str):
    """Device milliseconds of the ``name`` spans per denoise step of the
    traced steps: their device seconds ÷ (traced steps × denoise steps an
    engine step or image), the divisor of ``forward.torch_ops_ms``."""
    rec = _record(name)
    if rec is None or not rec.get("device_count") or not m.traced_steps:
        return None
    steps = m.traced_steps * m.host.get("denoise_steps_per_tick", 1)
    return 1e3 * float(rec["device_s"]) / steps
