"""See the package docstring of objgan_tpu_torch."""
