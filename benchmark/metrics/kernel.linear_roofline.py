"""Share of the quantized-linear kernels' roofline (%): the least time the
card could take for the traced steps' linear work (each call the larger
of its FLOPs at the bf16 peak and its bytes at the HBM peak; the work is
counted from the architecture at the cell's shapes, weights in their
stored GGUF format) over the device time of the kernels the frozen map
classes as linear (the program's fused dequant-matmuls, its w8a8 matmul
and library GEMMs)."""


def read(m):
    return m.roofline_share("linear")
