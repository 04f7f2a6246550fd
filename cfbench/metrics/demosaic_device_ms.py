"""demosaic_device_ms: device milliseconds a frame of the kernels launched
inside `IntraCodec.inverse_bayer_rgb`, the Bayer demosaic and develop
(`ops/demosaic`), in the profiled sub-window."""

from cfbench.spans import Spec
from cfbench.trace import device_ms_per_frame

SPANS = [Spec("intra.inverse_bayer_rgb", "cineform_tpu_torch.models.intra",
              "IntraCodec.inverse_bayer_rgb",
              frames=lambda a, k: a[1][0][0].shape[0])]


def read(ctx):
    return device_ms_per_frame(ctx.trace, ctx.spans,
                               "intra.inverse_bayer_rgb")
