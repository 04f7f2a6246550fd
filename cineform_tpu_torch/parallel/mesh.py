"""Frame meshes and the sharding of a frame batch over them.

A mesh is an ordered list of torch devices along one "frames" axis: the
intra codec is embarrassingly parallel across frames (SURVEY §2.4), so a
single axis is the whole sharding story.  A mesh may repeat a device (a
test's `[cpu, cpu]`), as the JAX tests force a virtual 8-device CPU mesh.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def frame_mesh(n_devices: int | None = None,
               device: torch.device | str = "cuda") -> list[torch.device]:
    """The visible devices of `device`'s type, the first `n_devices` of
    them: the cards, or `[cpu]` on the CPU."""
    kind = torch.device(device).type
    if kind == "cpu":
        devices = [torch.device("cpu")]
    else:
        devices = [torch.device(kind, i)
                   for i in range(torch.cuda.device_count())]
    if not devices:
        raise RuntimeError(f"no visible {kind} device")
    return devices if n_devices is None else devices[:n_devices]


def shard_frames(mesh, arr: np.ndarray | torch.Tensor) -> list[torch.Tensor]:
    """Split a (B, ...) batch along axis 0 into contiguous shards, one a
    device of `mesh` (`torch.tensor_split`'s sizes: B need not divide by
    the mesh's size, and a shard may be empty), each uploaded to its
    device."""
    t = torch.as_tensor(arr)
    return [part.to(d) for part, d in zip(torch.tensor_split(t, len(mesh)),
                                          mesh)]


def batch_sharding(mesh) -> tuple[torch.device, ...]:
    """The placement `IntraCodec.encode_batch_device(sharding=...)` takes:
    the mesh itself, as a tuple of torch devices (the JAX codec takes a
    `NamedSharding` built from its mesh)."""
    return tuple(torch.device(d) for d in mesh)


def map_shards(mesh, codec, frames, step) -> list[tuple[torch.Tensor,
                                                      object]]:
    """`step(c, x)` of each non-empty shard `x` of `frames`
    (`shard_frames`), with `c` the codec of `codec`'s configuration on the
    shard's device; every shard's step is queued before any result is
    fetched -> [(x, its result)] in frame order."""
    return [(x, step(dataclasses.replace(codec, device=x.device), x))
            for x in shard_frames(mesh, frames) if len(x)]
