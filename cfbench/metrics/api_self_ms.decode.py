"""api_self_ms.decode: the mean milliseconds of an `api.Decoder.
decode_sample` call in the window before the profiler starts, less the
time it spends in the calls it makes into `models/intra`
(`IntraCodec.decode_batch_device` and `IntraCodec.screen`): the API's own
per-call path (parse, routing, the develop plan, the output's
reshape)."""

from cfbench.spans import Spec, self_seconds

SPANS = [
    Spec("api.decode_sample", "cineform_tpu_torch.api",
         "Decoder.decode_sample", frames=lambda a, k: 1),
    Spec("intra.decode_batch_device", "cineform_tpu_torch.models.intra",
         "IntraCodec.decode_batch_device", frames=lambda a, k: len(a[1])),
    Spec("intra.screen", "cineform_tpu_torch.models.intra",
         "IntraCodec.screen"),
]


def read(ctx):
    calls = [s for s in ctx.spans if s.name == "api.decode_sample"
             and s.start >= ctx.start and s.end <= ctx.quiet_end]
    if not calls:
        return None
    inner = [s for s in ctx.spans
             if s.name in ("intra.decode_batch_device", "intra.screen")]
    return 1e3 * self_seconds(calls, inner) / len(calls)
