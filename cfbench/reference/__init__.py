"""The plain reference of the benchmark's check: a CFHD intra encoder and
decoder in NumPy (`codec`), from frozen copies of the JAX package's NumPy
oracle and the host helpers; it imports neither that package nor the
port."""
