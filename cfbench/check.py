"""The check of a run's outputs against the plain reference.

It compares what the timed path produced, at the timed sizes: outputs
that the clients kept in the window (`drive.Record.output`), a sample of
them drawn from the seed, each against the reference's answer for the
same request (`plugins.Parts.answer`: the driver's `expected`, from the
configuration's reference format): a pool's sample byte for byte against
the reference encoder's, a decoded frame byte for byte against what the
reference works out from the frame.  The sample covers every client and
every batch slot of the program (a request's place in its client's
stream, modulo the slots) before it takes a second of any.  A request
that failed, or that never finished, fails the check as well.

Each number compared has its limit; both are exact comparisons of a
byte-exact codec, so both limits are 0:

- `failed_calls`: the window's requests that raised or returned another
  frame than was asked for;
- `differing_bytes`: bytes of the checked outputs that differ from the
  reference's.
"""

from __future__ import annotations

import numpy as np

from cfbench import content

LIMITS = {"failed_calls": 0, "differing_bytes": 0}


def differing(got, want) -> int:
    """Bytes in which two answers differ; a size mismatch counts every
    byte of the larger."""
    a = np.frombuffer(got, np.uint8) if isinstance(got, bytes) \
        else np.ascontiguousarray(got).view(np.uint8).reshape(-1)
    b = np.frombuffer(want, np.uint8) if isinstance(want, bytes) \
        else np.ascontiguousarray(want).view(np.uint8).reshape(-1)
    if a.size != b.size:
        return max(a.size, b.size)
    return int(np.count_nonzero(a != b))


def choose(records, start: float, end: float, count: int, seed: int,
           slots: int = 1):
    """`count` kept outputs finished in [start, end], drawn from the seed:
    one from each (client, slot) class in a seeded order, then a second
    from each, and so on."""
    kept = [r for r in records if r.output is not None
            and start <= r.end <= end]
    classes: dict = {}
    for r in kept:
        classes.setdefault((r.client, r.k % slots), []).append(r)
    g = content.rng(seed, 2)
    keys = sorted(classes)
    keys = [keys[i] for i in g.permutation(len(keys))]
    for key in keys:
        members = classes[key]
        classes[key] = [members[i] for i in g.permutation(len(members))]
    chosen = []
    depth = 0
    while len(chosen) < min(count, len(kept)):
        chosen += [classes[key][depth] for key in keys
                   if len(classes[key]) > depth][:count - len(chosen)]
        depth += 1
    return sorted(chosen, key=lambda r: (r.client, r.k))


def compare(parts, frames: np.ndarray, records, start: float, end: float,
            seed: int, slots: int = 1) -> tuple[dict, list]:
    """-> ({name: value} of the numbers compared, the records checked)."""
    window = [r for r in records if start <= r.start <= end
              or start <= r.end <= end]
    failed = sum(not r.ok for r in window)
    checked = choose(records, start, end, parts.mix["check"], seed, slots)
    diff = sum(differing(r.output, parts.answer(frames, r))
               for r in checked)
    return {"failed_calls": failed, "differing_bytes": diff}, checked


def verdict(numbers: dict, checked: int) -> bool:
    """Correct: every number within its limit, and something checked."""
    return checked > 0 and all(numbers[k] <= LIMITS[k] for k in LIMITS)
