"""objgan_tpu_torch — the PyTorch/CUDA port of objgan_tpu for NVIDIA Hopper.

It mirrors the JAX package's layout (``core/``, ``ops/``, ``models/``,
``train/``, ``data/``, ``pipeline_e2e.py``, ``serving.py``) and is held to
it by the ``tests/test_torch_*.py`` parity tests. It imports ``torch`` and
never JAX; of the JAX package it imports only the JAX-free host modules
``objgan_tpu.core.config`` and ``objgan_tpu.utils.visualize``.

The GroupNorm(+GLU) layers run the hand-written CUDA kernel
``csrc/groupnorm.cu`` on the card (built by nvcc at first use into
``_build/``) and its plain PyTorch twin on the CPU.
"""
