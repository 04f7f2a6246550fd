"""The port's frame meshes (`cineform_tpu_torch.parallel`) on the CPU,
with meshes of repeated `torch.device("cpu")`, as the JAX tests force a
virtual 8-device CPU mesh: the split of a batch, the sharded encode and
the dry run bit-identical to the unsharded ones, and the pool's sharded
batcher equal to the sync Encoder (the counterpart of
`tests/test_pool.py::test_pool_shards_batch_over_mesh`); the sharded
samples equal to the JAX package's host encoder's too.
"""

import ast
import os

import numpy as np
import pytest
import torch

from cineform_tpu.models import intra_host as jhost
from cineform_tpu_torch import api
from cineform_tpu_torch import testframes as tframes
from cineform_tpu_torch.models.intra import IntraCodec
from cineform_tpu_torch.parallel import mesh
from cineform_tpu_torch.parallel.dryrun import dryrun_multichip

torch.set_num_threads(1)

CPU = torch.device("cpu")
W, H = 64, 48
PARALLEL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "cineform_tpu_torch", "parallel")


def test_frame_mesh():
    assert mesh.frame_mesh(device="cpu") == [CPU]
    assert mesh.frame_mesh(1, "cpu") == [CPU]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no visible cuda device"):
            mesh.frame_mesh()


@pytest.mark.parametrize("batch,n,sizes", [(3, 2, [2, 1]), (7, 3, [3, 2, 2]),
                                           (8, 4, [2, 2, 2, 2]),
                                           (2, 4, [1, 1, 0, 0])])
def test_shard_frames_splits_the_batch_in_order(batch, n, sizes):
    """Contiguous shards of the frame axis, `torch.tensor_split`'s sizes
    (a ragged batch too), each on its device, which gather back to the
    batch."""
    frames = np.random.default_rng(batch).integers(0, 256, (batch, 4, 6),
                                                   dtype=np.uint8)
    shards = mesh.shard_frames([CPU] * n, frames)
    assert [len(s) for s in shards] == sizes
    assert all(s.device == CPU for s in shards)
    np.testing.assert_array_equal(torch.cat(shards).numpy(), frames)
    assert mesh.batch_sharding([CPU] * n) == (CPU,) * n


@pytest.mark.parametrize("batch,n", [(4, 2), (6, 3), (7, 3), (3, 2), (2, 4)])
def test_sharded_encode_equals_unsharded(batch, n):
    """`encode_batch_device(sharding=...)` over n devices gives the
    unsharded samples byte for byte, and the JAX package's host encoder's,
    with per-frame frame numbers and metadata (2n frames, and ragged
    batches)."""
    codec = IntraCodec(W, H, 4, device=CPU)
    frames = np.stack([np.frombuffer(tframes.yuy2_frame(W, H, p), np.uint8)
                       .reshape(H, 2 * W) for p in range(batch)])
    numbers = list(range(5, 5 + batch))
    want = codec.encode_batch_device(frames, frame_numbers=numbers)
    got = codec.encode_batch_device(
        frames, frame_numbers=numbers,
        sharding=mesh.batch_sharding([CPU] * n))
    assert got == want
    assert got == [jhost.encode_sample(
        f.tobytes(), W, H, 4, frame_number=fn,
        metadata=jhost.EncoderMetadata().advanced(fn - 1))
        for f, fn in zip(frames, numbers)]
    assert codec.encode_batch_device(
        frames, 3, sharding=mesh.batch_sharding([CPU] * n)) == \
        codec.encode_batch_device(frames, 3)


def test_dryrun_multichip_on_the_cpu():
    """Both steps of the dry run over a 2-device CPU mesh, the 1080p one
    included."""
    dryrun_multichip(2, device="cpu")


def test_pool_shards_the_batch_over_the_mesh(monkeypatch):
    """With more than one device visible (`frame_mesh` giving 4 CPUs) the
    pool's batcher shards its batches over a mesh of them and still
    delivers the sync Encoder's samples, which are the JAX package's host
    encoder's."""
    monkeypatch.setattr(mesh, "frame_mesh", lambda n_devices=None,
                        device="cuda": [CPU] * 4)
    p = api.CFHD_CreateEncoderPool(2, 8, device="cpu")
    p.prepare_to_encode(W, H, api.PixelFormat.YUY2)
    assert p.use_device and p._sharding == (CPU,) * 4
    frames = [tframes.yuy2_frame(W, H, q) for q in range(8)]
    enc = api.Encoder("cpu")
    enc.prepare_to_encode(W, H, api.PixelFormat.YUY2)
    want = []
    for f in frames:
        enc.encode_sample(f)
        want.append(enc.get_sample_data())
    p.start()
    for i, f in enumerate(frames):
        p.encode_async_sample(i + 1, f)
    got = [p.wait_for_sample(timeout=300).get_encoded_sample()
           for _ in frames]
    p.stop()
    assert got == want
    assert got == [jhost.encode_sample(
        f, W, H, 4, frame_number=i + 1,
        metadata=jhost.EncoderMetadata().advanced(i))
        for i, f in enumerate(frames)]


def test_one_device_builds_no_sharding():
    p = api.CFHD_CreateEncoderPool(1, 2, device="cpu")
    p.prepare_to_encode(W, H, api.PixelFormat.YUY2)
    assert p.use_device and p._sharding is None


@pytest.mark.parametrize("name", ["__init__.py", "mesh.py", "dryrun.py"])
def test_parallel_imports_no_jax(name):
    with open(os.path.join(PARALLEL, name)) as f:
        tree = ast.parse(f.read())
    imported = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names]
    imported += [n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom)]
    assert imported and not [m for m in imported if m.split(".")[0]
                             in ("jax", "jaxlib", "cineform_tpu")]
