"""CFHD format constants: tags, codebooks, production quantizers, and the
demo pyramid's quantizer and 2-6 wavelet contract (the port's copies of
the JAX package's `spec/` modules it uses)."""
