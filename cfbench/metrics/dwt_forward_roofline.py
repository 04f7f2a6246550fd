"""dwt_forward_roofline: the forward DWT kernel's (`csrc/dwt_forward.cu`,
`dwt_forward_kernel`) share of its bandwidth roofline, in percent, in the
profiled sub-window: the bytes its calls read and write
(`roofline.call_bytes`, the calls' mean times the kernels run) at the
card's peak bandwidth, over the kernels' device time
(`roofline.kernel_share`).  The wrappers are wrapped where `models/intra`
calls them."""

from cfbench import roofline
from cfbench.spans import Spec

NAMES = ("dwt.yuy2", "dwt.groups", "dwt.planes")
SPANS = [Spec(name, "cineform_tpu_torch.models.intra", fn,
              nbytes=roofline.call_bytes)
         for name, fn in zip(NAMES, ("dwt_forward_yuy2", "dwt_forward_groups",
                                     "dwt_forward_planes"))]


def read(ctx):
    # each wrapper call launches one `dwt_forward_kernel`
    return roofline.kernel_share(ctx, NAMES, ("dwt_forward_kernel",), 1)
