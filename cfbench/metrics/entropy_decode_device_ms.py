"""entropy_decode_device_ms: device milliseconds a frame of the kernels
launched inside `IntraCodec.decode_coefficients`, the band entropy decoder
(`entropy/device_decode`, its plain PyTorch stages and the merge kernels),
in the profiled sub-window."""

from cfbench.spans import Spec
from cfbench.trace import device_ms_per_frame

SPANS = [Spec("intra.decode_coefficients", "cineform_tpu_torch.models.intra",
              "IntraCodec.decode_coefficients",
              frames=lambda a, k: a[5][0].shape[0])]


def read(ctx):
    return device_ms_per_frame(ctx.trace, ctx.spans,
                               "intra.decode_coefficients")
