"""Hand-written CUDA kernels for Hopper and their Python wrappers.

The counterpart of fei_tpu/ops/pallas/: one module per kernel, each with
its plain PyTorch version beside it. Sources live in fei_tpu_torch/csrc/
and are built at first launch (``build.py``).
"""
