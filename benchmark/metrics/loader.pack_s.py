"""Host seconds of the program's ``loader.pack`` spans over the run's
set-up: the planar packing and padding of each quantized weight."""

import spans


def read(m):
    return spans.host_s("loader.pack")
