"""The yardstick of the kernels' roofline shares: the card's peaks, and
the bytes each kernel call must move, counted from its shapes.

A call's bytes are its tensor inputs read once and its tensor outputs
written once (`spans.tensor_bytes`), as `chip_smoke.py` counts a kernel's
bound: the DWT reads its level's input and writes the lows and the
coder-layout highs; a merge network reads its two or three int32 arrays
and writes as many.  The least time is those bytes over the peak
bandwidth; every kernel here does a few integer operations a byte, far
under the card's rate, so bandwidth bounds them all.
"""

from __future__ import annotations

from cfbench.spans import tensor_bytes

#: NVIDIA H100 SXM, 80 GB HBM3 (data sheet): bytes per second
PEAK_BYTES_PER_S = 3.35e12


def call_bytes(args, kwargs, result) -> int:
    """Bytes a kernel wrapper's call reads and writes."""
    return tensor_bytes(args, tuple(kwargs.values()), result)


def share_pct(total_bytes: int, kernel_seconds: float) -> float | None:
    """The least time of `total_bytes` over the kernels' measured time, in
    percent; None where no kernel time was measured."""
    if kernel_seconds <= 0 or total_bytes <= 0:
        return None
    return 100.0 * (total_bytes / PEAK_BYTES_PER_S) / kernel_seconds


def kernel_share(ctx, names, kernels, per_call: int) -> float | None:
    """The roofline share, in percent, of the kernels whose names hold one
    of `kernels` (the trace writes `void name<...>(...)`), which only the
    wrapper calls `names` launch, `per_call` to a call, in the profiled
    sub-window: the mean bytes of the calls that lie in it, times the calls
    those kernels stand for, at the peak bandwidth, over the kernels'
    device time.  Pairing by count, not by each launch's thread, keeps the
    share right where the trace misses some of the kernels; none found,
    or no call: None."""
    tr = ctx.trace
    if tr is None:
        return None
    calls = [b for n, _, t0, t1, b in ctx.call_bytes
             if n in names and t0 >= tr.start and t1 <= tr.end]
    ks = [k for k in tr.kernels if tr.start <= k.start < tr.end
          and any(n in k.name for n in kernels)]
    if not calls or not ks:
        return None
    moved = sum(calls) / len(calls) * len(ks) / per_call
    return share_pct(moved, sum(k.dur for k in ks))
