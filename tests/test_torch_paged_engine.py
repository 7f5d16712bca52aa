"""The port's paged engine (``InferenceEngine(paged=True)`` and its
``PagedScheduler``) on the CPU: greedy tokens equal to fei_tpu's paged
engine on the same fp32 weights, and the JAX package's scheduler
identities re-proved inside the port — interleaved streams equal the
dense engine (greedy and seeded), FIFO beyond the slots, chunked ==
unchunked, ragged == paged, multistep 8 == 1, tight-pool preempt-resume
== roomy (greedy and seeded), prefix-cache reuse, and a cancel
mid-chunk that does not wedge the loop. Failure domains: a kernel
failure fails the in-flight requests through ``_fail_all`` and is never
rerouted; a host fault at delivery fails only its own request."""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import concurrent.futures as cf
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fei_tpu.engine.engine import GenerationConfig as JaxGen
from fei_tpu.engine.engine import InferenceEngine as JaxEngine
from fei_tpu_torch.engine.engine import GenerationConfig, InferenceEngine
from fei_tpu_torch.engine.faults import FAULTS
from fei_tpu_torch.models.convert import params_from_jax
from fei_tpu_torch.utils.errors import EngineError, QueueFullError
from fei_tpu_torch.utils.metrics import METRICS

MAX_SEQ = 256
KW = dict(device="cpu", dtype=torch.float32, max_seq_len=MAX_SEQ, num_layers=2)


def _counter(name):
    return METRICS.snapshot()["counters"].get(name, 0.0)


@pytest.fixture(scope="module")
def dense():
    return InferenceEngine.from_config("tiny", **KW)


def _paged(dense, **kw):
    chunk = kw.pop("prefill_chunk", 32)
    eng = InferenceEngine.from_config("tiny", params=dense.params, paged=True,
                                      page_size=16, batch_size=kw.pop("batch_size", 4),
                                      **KW, **kw)
    eng.scheduler.prefill_chunk = chunk
    return eng


@pytest.fixture(scope="module")
def paged(dense):
    eng = _paged(dense)
    yield eng
    eng.close()


def _prompts(n, lens=(9, 40, 21, 77, 13, 55)):
    rng = np.random.default_rng(0)
    return [rng.integers(1, 500, lens[i % len(lens)]).tolist() for i in range(n)]


def _gen(n=16, **kw):
    return GenerationConfig(max_new_tokens=n, ignore_eos=True, **kw)


def _concurrent(eng, prompts, gens):
    """Every request from its own thread; returns the token streams."""
    with cf.ThreadPoolExecutor(len(prompts)) as ex:
        return list(ex.map(lambda pg: list(eng.generate_stream(*pg)), zip(prompts, gens)))


def test_greedy_tokens_match_jax_paged_engine():
    jeng = JaxEngine.from_config("tiny", dtype=jnp.float32, max_seq_len=128, paged=True,
                                 page_size=16, batch_size=2, num_layers=2)
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params))
    eng = InferenceEngine.from_config("tiny", params=params, paged=True, page_size=16,
                                      batch_size=2, device="cpu", dtype=torch.float32,
                                      max_seq_len=128, num_layers=2)
    try:
        for prompt in _prompts(2, (11, 40)):
            want = list(jeng.generate_stream(prompt, JaxGen(max_new_tokens=12,
                                                            ignore_eos=True)))
            assert list(eng.generate_stream(prompt, _gen(12))) == want
    finally:
        eng.close()
        jeng.close()


def test_four_interleaved_streams_match_dense(dense, paged):
    prompts = _prompts(4)
    want = [list(dense.generate_stream(p, _gen())) for p in prompts]
    streams = [paged.generate_stream(p, _gen()) for p in prompts]
    got = [[] for _ in prompts]
    live = set(range(4))
    while live:  # round-robin: all four in flight at once
        for i in sorted(live):
            try:
                got[i].append(next(streams[i]))
            except StopIteration:
                live.discard(i)
    assert got == want
    assert paged._allocator.free_pages == paged._allocator.num_pages - 1


def test_more_requests_than_slots_fifo_and_seeded_match_dense(dense, paged):
    """Six requests for four slots, greedy and seeded mixed: each stream
    equals the dense engine's for the same request."""
    prompts = _prompts(6)
    gens = [_gen(10), _gen(10, temperature=0.8, seed=1, top_k=20), _gen(10),
            _gen(10, temperature=1.1, seed=2, top_p=0.9), _gen(10, temperature=0.7,
                                                             seed=3, min_p=0.05), _gen(10)]
    want = [list(dense.generate_stream(p, g)) for p, g in zip(prompts, gens)]
    assert _concurrent(paged, prompts, gens) == want


@pytest.mark.parametrize("knob,values", [("prefill_chunk", (16, 512)),
                                         ("ragged_attention", (True, False)),
                                         ("multistep", (8, 1))],
                         ids=["chunked_vs_unchunked", "ragged_vs_paged", "multistep_8_vs_1"])
def test_scheduler_knobs_keep_streams(dense, knob, values):
    """Streams are the same under either value of each scheduler knob; the
    ragged arm really merges chunks with live decode."""
    prompts = _prompts(4, (9, 70, 21, 90))
    gens = [_gen(24), _gen(24, temperature=0.9, seed=5), _gen(24), _gen(24)]
    runs = []
    for v in values:
        eng = _paged(dense)
        setattr(eng.scheduler, knob, v)
        merged = _counter("engine.ragged_dispatches")
        runs.append(_concurrent(eng, prompts, gens))
        if knob == "ragged_attention":
            assert (_counter("engine.ragged_dispatches") > merged) == v
        eng.close()
    assert runs[0] == runs[1]


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "seeded"])
def test_tight_pool_preempts_and_resumes_identically(dense, sampled):
    prompts = _prompts(4, (20, 60, 33, 90))
    gens = [_gen(40, temperature=0.9 if sampled and i % 2 else 0.0, seed=i)
            for i in range(4)]
    roomy, tight = _paged(dense), _paged(dense, num_pages=14)
    want = _concurrent(roomy, prompts, gens)
    before = _counter("scheduler.preemptions")
    got = _concurrent(tight, prompts, gens)
    assert _counter("scheduler.preemptions") > before
    assert got == want
    assert tight._allocator.free_pages == tight._allocator.num_pages - 1
    roomy.close()
    tight.close()


def test_resume_rebuilds_a_dense_prompt_densely(dense):
    """A preempted prompt that was admitted through the dense route is
    rebuilt through it on resume (prompt positions only; the generated
    suffix replays through decode), so its K/V are what admission wrote
    whatever the dense and paged attention kernels round."""
    prompts = _prompts(4, (20, 60, 33, 90))
    tight = _paged(dense, num_pages=14)
    calls = []
    dense_prefill = tight.scheduler._dense_prefill
    tight.scheduler._dense_prefill = lambda ids: calls.append(list(ids)) or dense_prefill(ids)
    before = _counter("scheduler.preemptions")
    _concurrent(tight, prompts, [_gen(40)] * 4)
    assert _counter("scheduler.preemptions") > before
    assert all(ids in prompts for ids in calls)  # prompts only, never a generated suffix
    assert any(calls.count(ids) > 1 for ids in calls)  # admitted, then resumed, densely
    tight.close()


@dataclasses.dataclass(frozen=True)
class _PriorityGen(GenerationConfig):
    """A request with a priority class (the scheduler reads ``gen.priority``)."""

    priority: int = 0


def test_prefix_cache_resume_rebuilds_a_dense_prompt_densely(dense):
    """With the prefix cache on, a densely admitted prompt that a higher-
    priority request preempts still finds its own registered page when it
    resumes; it is rebuilt through the dense route all the same (no prefix
    match, no chunks), and its stream equals the dense engine's."""
    eng = _paged(dense, prefix_cache=True, batch_size=1)
    sched = eng.scheduler
    low, high = _prompts(2, (24, 13))
    want = list(dense.generate_stream(low, _gen(120)))
    calls = []
    dense_prefill = sched._dense_prefill
    sched._dense_prefill = lambda ids: calls.append(list(ids)) or dense_prefill(ids)
    hits, preempted = _counter("prefix.hits"), _counter("scheduler.priority_preemptions")
    seq = sched.submit(low, _gen(120))
    deadline = time.time() + 30
    while not seq.generated and time.time() < deadline:
        time.sleep(0.0005)
    urgent = sched.submit(high, _PriorityGen(max_new_tokens=8, ignore_eos=True, priority=1))
    assert list(sched.drain(urgent)) == list(dense.generate_stream(high, _gen(8)))
    assert list(sched.drain(seq)) == want
    assert _counter("scheduler.priority_preemptions") > preempted
    assert calls.count(low) == 2  # admitted, then resumed, densely
    assert _counter("prefix.hits") == hits  # the resume probed no prefix
    assert len(sched._prefix.match(low)) == 1  # though its page was there to match
    eng.close()


def test_prefix_cache_hit_reuses_pages(dense):
    eng = _paged(dense, prefix_cache=True)
    prompt = _prompts(1, (70,))[0]
    want = list(dense.generate_stream(prompt, _gen()))
    assert list(eng.generate_stream(prompt, _gen())) == want
    hits = _counter("prefix.hits")
    shared = eng.scheduler._prefix.match(prompt)
    assert len(shared) == 4  # (70 - 1) // 16 full pages
    assert list(eng.generate_stream(prompt, _gen())) == want
    assert _counter("prefix.hits") >= hits + 2
    eng.close()


def test_int8_pool_serves_finite_streams(dense):
    eng = _paged(dense, kv_quant="int8")
    prompts = _prompts(3)
    got = _concurrent(eng, prompts, [_gen(12)] * 3)
    assert all(len(s) == 12 and all(0 <= t < eng.cfg.vocab_size for t in s) for s in got)
    assert eng.scheduler._pool.k_pages.dtype == torch.int8
    eng.close()


def test_cancel_mid_chunk_does_not_wedge(dense, paged):
    """Abandoning a stream while its prompt is still being chunked frees
    its slot and pages; the next request runs normally."""
    paged.scheduler.prefill_chunk = 8
    try:
        seq = paged.scheduler.submit(_prompts(1, (120,))[0], _gen(8))
        deadline = time.time() + 30
        while paged.scheduler._admitting is None and time.time() < deadline:
            time.sleep(0.001)
        paged.scheduler.cancel(seq)
        prompt = _prompts(1, (12,))[0]
        assert list(paged.generate_stream(prompt, _gen(6))) == list(
            dense.generate_stream(prompt, _gen(6)))
        assert paged._allocator.free_pages == paged._allocator.num_pages - 1
    finally:
        paged.scheduler.prefill_chunk = 32


def test_kernel_failure_fails_requests_without_rerouting(dense, monkeypatch):
    """A paged-attention failure (a RuntimeError, as a failed launch
    raises) fails the in-flight requests through _fail_all: the pool is
    dropped, nothing is retried on another program, and a later request
    is served by a rebuilt pool."""
    import fei_tpu_torch.ops.kernels.paged_attention as k2

    eng = _paged(dense)
    real = k2.paged_attention

    def broken(*a, **kw):
        raise RuntimeError("paged_attention launch failed: injected")

    monkeypatch.setattr(k2, "paged_attention", broken)
    with pytest.raises(RuntimeError, match="injected"):
        list(eng.generate_stream(_prompts(1)[0], _gen(4)))
    assert eng.scheduler._pool is None
    monkeypatch.setattr(k2, "paged_attention", real)
    prompt = _prompts(1, (12,))[0]
    assert list(eng.generate_stream(prompt, _gen(4))) == list(
        dense.generate_stream(prompt, _gen(4)))
    eng.close()


def test_delivery_fault_fails_only_its_request(dense, paged):
    prompts = _prompts(2, (10, 14))
    want = list(dense.generate_stream(prompts[1], _gen(12)))
    seqs = {}
    FAULTS.arm("delivery.detok", "request", count=1,
               match=lambda ctx: ctx["seq"] is seqs.get("victim"))
    try:
        seqs["victim"] = paged.scheduler.submit(prompts[0], _gen(12))
        survivor = paged.scheduler.submit(prompts[1], _gen(12))
        from fei_tpu_torch.utils.errors import RequestError

        with pytest.raises(RequestError):
            list(paged.scheduler.drain(seqs["victim"]))
        assert list(paged.scheduler.drain(survivor)) == want
    finally:
        FAULTS.disarm()


def test_queue_cap_sheds_with_queue_full_error(dense):
    eng = _paged(dense, batch_size=1)
    sched = eng.scheduler
    hold = sched.submit(_prompts(1)[0], _gen(200))
    queued = sched.submit(_prompts(1)[0], _gen(4))
    sched.max_queue = 1
    with pytest.raises(QueueFullError) as err:
        sched.submit(_prompts(1)[0], _gen(4))
    assert err.value.retry_after_s >= 1
    sched.cancel(hold)
    sched.cancel(queued)
    eng.close()


def test_paged_engine_options_need_paged():
    with pytest.raises(EngineError, match="requires paged=True"):
        InferenceEngine.from_config("tiny", device="cpu", kv_quant="int8")
    with pytest.raises(EngineError, match="only exists for paged engines"):
        InferenceEngine.from_config("tiny", device="cpu").scheduler
