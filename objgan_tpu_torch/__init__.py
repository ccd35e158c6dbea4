"""objgan_tpu_torch — the PyTorch/CUDA port of objgan_tpu for NVIDIA Hopper.

It mirrors the JAX package's layout (``core/``, ``ops/``, ``models/``,
``losses/``, ``train/``, ``data/``, ``utils/``, ``pipeline_e2e.py``,
``serving.py``, ``cli.py``) and is held to it by the
``tests/test_torch_*.py`` parity tests. It imports ``torch`` and nothing of
the JAX package: the JAX-free host modules it needs (the config tree, the
tokenizer, the label tables, the PNG writer) are copies of their own,
held equal to the originals by tests.

Three hand-written CUDA kernels run on the card, built by nvcc at first use
into ``_build/``: GroupNorm(+GLU) (``csrc/groupnorm.cu``) and ROI-align
forward and backward (``csrc/roi_align.cu``). On the CPU their plain
PyTorch twins run instead.
"""
