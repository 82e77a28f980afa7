"""PyTorch/CUDA port of aspire_tpu for NVIDIA Hopper.

The package mirrors the sub-package and module names of ``aspire_tpu`` so
that each function is found next to its counterpart.  It imports torch and
numpy only.  Entry points run on the GPU unless the caller hands them CPU
tensors or ``device="cpu"``; the hand-written CUDA kernels under ``csrc/`` are
built with nvcc at first use (``ops/_build.py``).
"""
