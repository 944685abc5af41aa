"""The whole step's share of the card's bf16 peak (%): the model FLOPs of
the traced steps (every product their forwards, encoders and decoders
ran, at the requests' own shapes: linears, attention, convolutions) over
the traced window's seconds times the peak."""


def read(m):
    t = m.timeline
    if t is None or m.peaks is None or not m.work:
        return None
    flops = sum(item[0] for w in m.work for calls in w.values()
                for item in calls)
    return 100.0 * flops / (t.window_s * m.peaks["bf16_flops"])
