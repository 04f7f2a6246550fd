"""A dry run of the sharded codec over an n-device frame mesh: the port of
`__graft_entry__.dryrun_multichip`.

The intra codec's multi-card strategy is pure data parallelism over the
frame batch, so the mesh has a single frames axis and each shard of the
batch runs on its device through a codec of the same configuration.
"""

from __future__ import annotations

import numpy as np
import torch

from cineform_tpu_torch.models.intra import IntraCodec
from cineform_tpu_torch.parallel.mesh import frame_mesh, map_shards


def _flat(tree) -> list[torch.Tensor]:
    if isinstance(tree, (tuple, list)):
        return [t for part in tree for t in _flat(part)]
    return [tree]


def _sharded(mesh, codec: IntraCodec, frames: np.ndarray, step):
    """`step` over the shards of `frames` (`map_shards`) -> the leaves of
    the results, each gathered in frame order on the CPU."""
    runs = [_flat(out) for _, out in map_shards(mesh, codec, frames, step)]
    return [torch.cat([leaf.cpu() for leaf in leaves])
            for leaves in zip(*runs)]


def dryrun_multichip(n_devices: int,
                     device: torch.device | str = "cuda") -> None:
    """Run the codec's device step sharded over an `n_devices` mesh and
    check it against the unsharded one; raises AssertionError where they
    differ.  The mesh is the visible devices of `device`'s type, repeated
    where fewer than `n_devices` are visible, as the JAX dry run forces a
    virtual CPU mesh of n devices.

    1. At 64x48, `2 * n_devices` frames of seeded noise: the sharded
       `forward_packed` (the whole device encode: transform, quantization,
       entropy coding and bit packing) and `inverse(dequantize(forward))`
       equal the unsharded ones on the mesh's first device bit for bit.
    2. At 1920x1080, `n_devices` frames through the sharded
       `inverse(dequantize(forward))`: the shape and dtype hold."""
    visible = frame_mesh(device=device)
    mesh = [visible[i % len(visible)] for i in range(n_devices)]
    rng = np.random.default_rng(0)

    def roundtrip(c, x):
        return c.inverse(c.dequantize(c.forward(x)))

    def step(c, x):
        return c.forward_packed(x), roundtrip(c, x)

    codec = IntraCodec(64, 48, 4, device=mesh[0])
    frames = rng.integers(0, 256, (2 * n_devices, 48, 128), dtype=np.uint8)
    got = _sharded(mesh, codec, frames, step)
    want = [t.cpu() for t in _flat(step(codec, codec._upload(frames)))]
    if len(got) != len(want) or not all(
            torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"the step sharded over {n_devices} devices "
                             "differs from the unsharded one")
    big = IntraCodec(1920, 1080, 4, device=mesh[0])
    frames = rng.integers(0, 256, (n_devices, 1080, 2 * 1920),
                          dtype=np.uint8)
    (out,) = _sharded(mesh, big, frames, roundtrip)
    if out.shape != frames.shape or out.dtype != torch.uint8:
        raise AssertionError(f"1080p sharded step gave {tuple(out.shape)} "
                             f"{out.dtype}, not {frames.shape} uint8")

