"""Host seconds of the program's ``loader.decode`` spans over the run's
set-up: component extraction of the stored blocks, or the dequantize of a
dense leaf."""

import spans


def read(m):
    return spans.host_s("loader.decode")
