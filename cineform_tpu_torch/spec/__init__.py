"""CFHD format constants: tags, codebooks and production quantizers (the
port's copies of the JAX package's `spec/` modules it uses)."""
