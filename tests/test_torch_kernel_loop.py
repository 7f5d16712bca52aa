"""Kernel looping (``FEI_TPU_KERNEL_LOOP``) in the port against the JAX
package (tests/test_ragged_attention.py::TestKernelLoop): the factor
parses as ``fei_tpu.engine.fused_decode.resolve_kernel_loop`` parses it; at
a factor of 2 the dense engine dispatches fewer, longer chunks (as many as
the reference dispatches) with a token stream identical to the reference's
at either factor; ``engine.kernel_loop_depth`` reads steps × layers on the
fused dense dispatch and on the paged scheduler's merged dispatch, whose
streams stay the reference's. fp32 tiny weights on the CPU, shared through
``params_from_jax``.
"""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import concurrent.futures as cf

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fei_tpu.engine.engine import GenerationConfig as JaxGen
from fei_tpu.engine.engine import InferenceEngine as JaxEngine
from fei_tpu.engine.fused_decode import resolve_kernel_loop as jax_resolve
from fei_tpu.utils.metrics import METRICS as JAX_METRICS
from fei_tpu_torch.engine.engine import GenerationConfig, InferenceEngine
from fei_tpu_torch.engine.fused_decode import resolve_kernel_loop
from fei_tpu_torch.models.convert import params_from_jax
from fei_tpu_torch.utils.metrics import METRICS

MAX_SEQ = 128
LAYERS = 2


def _counter(metrics, name):
    return metrics.snapshot()["counters"].get(name, 0.0)


def _gauge(metrics, name):
    return metrics.snapshot()["gauges"].get(name)


@pytest.mark.parametrize("value", [None, "3", "0", "-2", "meteor", "2"])
def test_resolve_matches_jax(value, monkeypatch):
    if value is None:
        monkeypatch.delenv("FEI_TPU_KERNEL_LOOP", raising=False)
    else:
        monkeypatch.setenv("FEI_TPU_KERNEL_LOOP", value)
    want = {None: 1, "3": 3, "0": 1, "-2": 1, "meteor": 1, "2": 2}[value]
    assert resolve_kernel_loop() == jax_resolve() == want


@pytest.fixture(scope="module")
def engines():
    jeng = JaxEngine.from_config("tiny", dtype=jnp.float32, max_seq_len=MAX_SEQ,
                                 num_layers=LAYERS)
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params))
    eng = InferenceEngine.from_config("tiny", params=params, device="cpu", dtype=torch.float32,
                                      max_seq_len=MAX_SEQ, num_layers=LAYERS)
    return jeng, eng


def test_dense_loop_fewer_dispatches_same_tokens(engines, monkeypatch):
    """chunk 4, 24 tokens: at factor 2 both engines dispatch chunks of 8
    (fewer dispatches, as many as the reference's), the streams equal the
    reference's at both factors, and the gauge reads 8 × layers."""
    jeng, eng = engines
    prompt = eng.tokenizer.encode("kernel loop", add_bos=True)
    runs = {}
    for factor in ("1", "2"):
        monkeypatch.setenv("FEI_TPU_KERNEL_LOOP", factor)
        j0, p0 = (_counter(m, "engine.decode_dispatches") for m in (JAX_METRICS, METRICS))
        want = list(jeng.generate_stream(prompt, JaxGen(max_new_tokens=24, ignore_eos=True,
                                                        chunk=4)))
        got = list(eng.generate_stream(prompt, GenerationConfig(max_new_tokens=24,
                                                                ignore_eos=True, chunk=4)))
        runs[factor] = dict(
            want=want, got=got,
            jax=_counter(JAX_METRICS, "engine.decode_dispatches") - j0,
            port=_counter(METRICS, "engine.decode_dispatches") - p0,
            depth=(_gauge(JAX_METRICS, "engine.kernel_loop_depth"),
                   _gauge(METRICS, "engine.kernel_loop_depth")))
    one, two = runs["1"], runs["2"]
    assert len(one["want"]) == 24
    assert one["got"] == one["want"] == two["got"] == two["want"]
    assert two["port"] < one["port"]
    assert (one["port"], two["port"]) == (one["jax"], two["jax"])
    assert one["depth"] == (4 * LAYERS, 4 * LAYERS)
    assert two["depth"] == (8 * LAYERS, 8 * LAYERS)


def test_paged_merged_dispatch_sets_the_gauge(engines, monkeypatch):
    """A paged engine at factor 2: chunked prompts merge with live decode;
    each merged dispatch sets the gauge to its steps × layers, and the
    greedy streams equal the reference's dense streams."""
    jeng, eng = engines
    monkeypatch.setenv("FEI_TPU_KERNEL_LOOP", "2")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 500, n).tolist() for n in (9, 70, 21, 90)]
    want = [list(jeng.generate_stream(p, JaxGen(max_new_tokens=16, ignore_eos=True)))
            for p in prompts]
    paged = InferenceEngine.from_config("tiny", params=eng.params, paged=True, page_size=16,
                                        batch_size=4, device="cpu", dtype=torch.float32,
                                        max_seq_len=MAX_SEQ, num_layers=LAYERS)
    paged.scheduler.prefill_chunk = 32
    seen = []
    real = paged.scheduler._finish_merged_chunk

    def finish(pc, logits):
        # read right after the merged dispatch set it
        seen.append(_gauge(METRICS, "engine.kernel_loop_depth"))
        return real(pc, logits)

    paged.scheduler._finish_merged_chunk = finish
    METRICS.gauge("engine.kernel_loop_depth", -1)
    merged = _counter(METRICS, "engine.ragged_dispatches")
    gen = GenerationConfig(max_new_tokens=16, ignore_eos=True)
    try:
        with cf.ThreadPoolExecutor(len(prompts)) as ex:
            got = list(ex.map(lambda p: list(paged.scheduler.stream(p, gen)), prompts))
    finally:
        paged.close()
    n_merged = _counter(METRICS, "engine.ragged_dispatches") - merged
    assert n_merged > 0 and len(seen) == n_merged
    multistep = paged.scheduler.multistep
    assert all(d in {n * LAYERS for n in range(1, multistep + 1)} for d in seen), seen
    assert got == want
