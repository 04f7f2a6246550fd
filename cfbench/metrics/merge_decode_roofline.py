"""merge_decode_roofline: the decoder forms of the merge network kernel
(`csrc/merge_network.cu`: `merge_network_tgt`, `merge_network_highfirst`,
each a placement and a guarded network) as a share of their bandwidth
roofline, in percent, in the profiled sub-window: their calls' bytes
(`roofline.call_bytes`, the calls' mean times the kernels run) at the
card's peak bandwidth, over the kernels' device time
(`roofline.kernel_share`).  The wrappers are wrapped where
`entropy/device_decode` calls them."""

from cfbench import roofline
from cfbench.spans import Spec

NAMES = ("merge.tgt", "merge.highfirst")
SPANS = [Spec(name, "cineform_tpu_torch.entropy.device_decode", fn,
              nbytes=roofline.call_bytes)
         for name, fn in zip(NAMES, ("merge_network_tgt",
                                     "merge_network_highfirst"))]


def read(ctx):
    # each wrapper call launches its placement and its guarded network
    return roofline.kernel_share(ctx, NAMES, (
        "place_tgt_kernel", "place_highfirst_kernel",
        "guarded_network_kernel"), 2)
