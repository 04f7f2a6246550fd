"""encode_host_tail_ms: host milliseconds a frame in
`IntraCodec.write_samples`, the encode's host tail (the fetch of the
packed bands, the band-end codes, the C++ re-encode of the bands that
overflowed the device coder, the sample writer), in the window before
the profiler starts."""

from cfbench.spans import Spec, host_ms_per_frame

SPANS = [Spec("intra.write_samples", "cineform_tpu_torch.models.intra",
              "IntraCodec.write_samples", frames=lambda a, k: len(a[1]))]


def read(ctx):
    return host_ms_per_frame(ctx.spans, ("intra.write_samples",), ctx.start,
                             ctx.quiet_end, "intra.write_samples")
