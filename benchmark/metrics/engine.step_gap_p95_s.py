"""95th percentile, over every lane of the window, of the host-clock
seconds between a request's consecutive steps (the cadence at which a
client sees its image advance), timed by the benchmark around the
engine's ``tick()``."""


def read(m):
    return m.host.get("step_gap_p95_s")
