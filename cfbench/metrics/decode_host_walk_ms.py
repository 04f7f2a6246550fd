"""decode_host_walk_ms: host milliseconds a frame of the device decode's
header walk, `bitstream.fastwalk.walk` and `IntraCodec._decode_rows_host`
(the walk, the pinned row fill), in the window before the profiler
starts: per thread the union of their spans, over the frames
`_decode_rows_host` took."""

from cfbench.spans import Spec, host_ms_per_frame

SPANS = [
    Spec("fastwalk.walk", "cineform_tpu_torch.bitstream.fastwalk", "walk",
         frames=lambda a, k: 1),
    Spec("intra.decode_rows_host", "cineform_tpu_torch.models.intra",
         "IntraCodec._decode_rows_host", frames=lambda a, k: len(a[1])),
]


def read(ctx):
    return host_ms_per_frame(ctx.spans, ("fastwalk.walk",
                                         "intra.decode_rows_host"),
                             ctx.start, ctx.quiet_end,
                             "intra.decode_rows_host")
