"""Host seconds of the program's ``loader.copy`` spans over the run's
set-up: each leaf's host-to-card copy."""

import spans


def read(m):
    return spans.host_s("loader.copy")
