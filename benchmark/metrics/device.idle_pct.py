"""Share of the traced window (%) in which no kernel, copy or memset ran
on the card: one minus the union of the device intervals over the
window."""


def read(m):
    t = m.timeline
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
