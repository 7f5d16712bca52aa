"""fei_tpu_torch — the fei_tpu serving engine on PyTorch and CUDA.

A second package beside the JAX one (``fei_tpu``), with the same layout:
``fei_tpu_torch/X/Y.py`` is the counterpart of ``fei_tpu/X/Y.py``. The JAX
package stays the reference; the tests feed the same inputs through both
and compare. This package imports ``torch`` and never ``jax``, and nothing
of ``fei_tpu``.

What is ported so far: the dense and paged serving paths (model configs,
the llama-family forward, the engine with fused chunked decode, the
continuous-batching scheduler, sampling, checkpoint loading, int8/int4
weights, the OpenAI-compatible server), training, and the agent turn
(grammar-enforced tool calls, the providers, the assistant loop, the code
tools and the CLI). Its kernels are hand-written CUDA C++ for ``sm_90a``
(``csrc/``), built with ``nvcc`` at first use.

Entry points run on CUDA unless the caller asks for the CPU
(``device="cpu"``); without a card they raise instead of falling back.
"""

__version__ = "0.1.0"
