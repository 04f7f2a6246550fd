"""See the package docstring of cineform_tpu_torch."""
