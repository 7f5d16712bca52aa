"""fei_tpu_torch — the fei_tpu serving engine on PyTorch and CUDA.

A second package beside the JAX one (``fei_tpu``), with the same layout:
``fei_tpu_torch/X/Y.py`` is the counterpart of ``fei_tpu/X/Y.py``. The JAX
package stays the reference; the tests feed the same inputs through both
and compare. This package imports ``torch`` and never ``jax``, and nothing
of ``fei_tpu``.

What is ported so far is the dense serving path (``fei serve`` without
``paged``): model configs, the llama-family forward, the dense engine with
fused chunked decode, sampling, checkpoint loading, the local provider and
the OpenAI-compatible server. Its one kernel is the flash-attention
forward (``ops/kernels/flash_attention.py`` over
``csrc/flash_attention_fwd.cu``), built with ``nvcc`` for ``sm_90a`` at
first use.

Entry points run on CUDA unless the caller asks for the CPU
(``device="cpu"``); without a card they raise instead of falling back.
"""

__version__ = "0.1.0"
