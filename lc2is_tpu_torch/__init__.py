"""PyTorch + CUDA port of lc2is_tpu for NVIDIA Hopper (H100).

Same module layout and names as ``lc2is_tpu`` (``ops/``, ``nn/``,
``models/``, ``core/``, ``engine/``, ``metrics/``, ``data/``, ``cli/``).
Every TPU kernel on the ported path is a kernel written by hand for
``sm_90a`` in ``csrc/``, built by ``ops/_build.py``; each
kernel's wrapper launches it on a CUDA tensor and runs its plain PyTorch
version on a CPU tensor.  This package imports torch, and nothing of jax
or of ``lc2is_tpu``.
"""

__version__ = "0.1.0"
