"""The benchmark of objgan_tpu_torch on one NVIDIA H100 (``run.py``)."""
