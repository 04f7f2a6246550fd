"""Multi-card scaling: data-parallel frame batches over a list of devices.

The port of `cineform_tpu.parallel`.  The reference codec's parallelism is
frame-level (`CEncoderPool`, N worker threads each encoding whole frames,
`EncoderSDK/EncoderPool.cpp:59-382`) plus intra-frame thread tiling.  On
the cards the equivalents are:

- frame level -> the leading batch axis, split into contiguous shards, one
  a device of a frame mesh (`mesh.frame_mesh`), each encoded by a codec of
  the same configuration on its device (pure data parallel: no
  cross-frame communication exists in the intra codec, SURVEY §2.4);
- channel/strip level -> one kernel launch a level for all the channels.

No collectives are required for correctness: the host uploads each shard
to its card and gathers the samples in frame order.
"""

from cineform_tpu_torch.parallel.mesh import (batch_sharding,  # noqa: F401
                                              frame_mesh, map_shards,
                                              shard_frames)
