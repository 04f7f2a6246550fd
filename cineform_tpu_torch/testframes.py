"""Synthetic YUY2 test frames, for checks and benchmarks of the port.

The generator is the JAX package's host one (`cineform_tpu.utils.
testframes`, which holds no JAX); the 1080p golden sample
`tests/golden/samples/s_1920x1080_q6_p1.cfhd` is its pattern 1 encoded by
the reference SDK.
"""

from cineform_tpu.utils.testframes import yuy2_frame

__all__ = ["yuy2_frame"]
