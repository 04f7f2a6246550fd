"""CFHD bitstream syntax on the host: the sample writer, the parser and the
native header walk (the port's copies of the JAX package's modules)."""

from cineform_tpu_torch.bitstream.parser import parse_sample

__all__ = ["parse_sample"]
