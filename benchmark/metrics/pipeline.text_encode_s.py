"""Seconds an image spends tokenizing and in the text encoders (T5 and
CLIP), by the pipeline's own stage clock (``FluxPipeline.last_timings``:
the card synchronised at each stage), the mean over the window's
images."""


def read(m):
    return m.host.get("text_encode_s")
