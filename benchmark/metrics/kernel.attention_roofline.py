"""Share of the attention kernels' roofline (%): the least time of the
traced steps' attention work (QKᵀ and PV FLOPs at the bf16 peak, or q, k,
v and the output in bf16 at the HBM peak, whichever is longer, for each
call) over the device time of the kernels the frozen map classes as
attention."""


def read(m):
    return m.roofline_share("attention")
