"""The serving controls of fei_tpu_torch against fei_tpu's: the per-request
fields and ``X-FEI-*`` headers (``ui/server.py::_gen_overrides``), the
scheduler's environment variables read when a scheduler is built, the
tenant policy table, ``FEI_TPU_FAULT`` arming, and the port's server
answering 429 once ``FEI_TPU_MAX_QUEUE`` is reached, shedding a request
whose propagated deadline has passed and counting a labelled tenant."""

from __future__ import annotations

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import dataclasses

import pytest
import torch

from fei_tpu.engine.engine import InferenceEngine as JaxEngine
from fei_tpu.engine.faults import FaultInjector as JaxFaultInjector
from fei_tpu.engine.scheduler import PagedScheduler as JaxScheduler
from fei_tpu.engine.tenancy import TenantBook as JaxTenantBook
from fei_tpu.ui.server import _gen_overrides as jax_gen_overrides
from fei_tpu.utils.errors import EngineError as JaxEngineError
from fei_tpu_torch.agent.providers import TorchLocalProvider
from fei_tpu_torch.engine.engine import GenerationConfig, InferenceEngine
from fei_tpu_torch.engine.faults import FaultInjector
from fei_tpu_torch.engine.scheduler import PagedScheduler
from fei_tpu_torch.engine.tenancy import TenantBook
from fei_tpu_torch.ui.server import ServeAPI, _gen_overrides
from fei_tpu_torch.utils.errors import DeviceError, EngineError
from fei_tpu_torch.utils.metrics import METRICS

# tests/test_tenancy.py::TestServerPlumbing's cases, and the fields beside them
PLUMBING = [
    ({"tenant": "gold", "priority": 2, "deadline_s": 5}, {}),
    ({}, {"X-FEI-Tenant": "silver", "X-FEI-Priority": "1"}),
    ({"tenant": "gold"}, {"x-fei-tenant": "silver"}),
    ({"priority": "soon"}, {}),
    ({"deadline_s": 9}, {"X-FEI-Deadline-S": "2.5"}),
    ({"deadline_s": 1}, {"X-FEI-Deadline-S": "30"}),
    ({}, {"X-FEI-Deadline-S": "0"}),
    ({}, {"X-FEI-Deadline-S": "-4"}),
    ({}, {"X-FEI-Deadline-S": "soon"}),
    ({"deadline_s": 0}, {}),
    ({"temperature": 0.7, "seed": 3, "deadline_s": 2.5, "tenant": "acme", "priority": 5},
     {"X-FEI-Deadline-S": "1.0"}),
    ({"top_p": 0.9, "top_k": 4, "min_p": 3, "ignore_eos": True, "temperature": None}, None),
]


@pytest.mark.parametrize("body,headers", PLUMBING)
def test_gen_overrides_equal_the_reference(body, headers):
    assert _gen_overrides(body, headers) == jax_gen_overrides(body, headers)


def test_gen_overrides_fold_the_header_deadline_and_clamp_it():
    assert _gen_overrides({"deadline_s": 9}, {"X-FEI-Deadline-S": "2.5"})["deadline_s"] == 2.5
    assert _gen_overrides({}, {"X-FEI-Deadline-S": "0"})["deadline_s"] == pytest.approx(1e-3)
    assert _gen_overrides({"tenant": "gold"}, {"X-FEI-Tenant": "silver"})["tenant"] == "gold"


@pytest.fixture(scope="module")
def engines():
    """A tiny paged engine of each package; each case builds a fresh
    scheduler over it, which is never started (parked)."""
    jeng = JaxEngine.from_config("tiny", paged=True, batch_size=2)
    peng = InferenceEngine.from_config("tiny", device="cpu", dtype=torch.float32,
                                       paged=True, batch_size=2)
    yield jeng, peng
    peng.close()


# (variable, value, attribute): the same value must set the same attribute
SCHEDULER_VARS = [
    ("FEI_TPU_PREFILL_CHUNK", "64", "prefill_chunk"),
    ("FEI_TPU_ATTENTION", "paged", "ragged_attention"),
    ("FEI_TPU_RAGGED_ROWS", "0", "ragged_rows"),
    ("FEI_TPU_RAGGED_ROWS", "3", "ragged_rows"),
    ("FEI_TPU_SCHED_MULTISTEP", "0", "multistep"),
    ("FEI_TPU_MAX_QUEUE", "3", "max_queue"),
    ("FEI_TPU_RETRY_AFTER_S", "2.5", "retry_after_s"),
    ("FEI_TPU_DEFAULT_DEADLINE_S", "7", "default_deadline_s"),
    ("FEI_TPU_BREAKER_FAILS", "5", "breaker_fails"),
    ("FEI_TPU_BREAKER_WINDOW_S", "12", "breaker_window_s"),
    ("FEI_TPU_BREAKER_COOLDOWN_S", "4.5", "breaker_cooldown_s"),
    ("FEI_TPU_PREEMPT_POLICY", "off", "preempt_policy"),
]


@pytest.mark.parametrize("var,value,attr", SCHEDULER_VARS,
                         ids=[f"{v[0]}={v[1]}" for v in SCHEDULER_VARS])
def test_scheduler_variable_sets_what_it_sets_in_the_reference(engines, var, value, attr,
                                                               monkeypatch):
    jeng, peng = engines
    default = getattr(PagedScheduler(peng), attr)
    assert default == getattr(JaxScheduler(jeng), attr)
    monkeypatch.setenv(var, value)
    ours, theirs = getattr(PagedScheduler(peng), attr), getattr(JaxScheduler(jeng), attr)
    assert ours == theirs and type(ours) is type(theirs)
    assert ours != default


@pytest.mark.parametrize("var,value", [("FEI_TPU_ATTENTION", "dense"),
                                       ("FEI_TPU_PREEMPT_POLICY", "lifo")])
def test_unknown_scheduler_values_raise_in_both(engines, var, value, monkeypatch):
    jeng, peng = engines
    monkeypatch.setenv(var, value)
    with pytest.raises(EngineError, match=var):
        PagedScheduler(peng)
    with pytest.raises(JaxEngineError, match=var):
        JaxScheduler(jeng)


def test_dense_staging_admission_is_refused_not_ignored(engines, monkeypatch):
    """FEI_TPU_PAGED_PREFILL=0 selects the JAX package's dense-staging
    admission, which the port does not have: it raises, naming it."""
    jeng, peng = engines
    monkeypatch.setenv("FEI_TPU_PAGED_PREFILL", "0")
    assert JaxScheduler(jeng).paged_native_prefill is False
    with pytest.raises(EngineError, match="dense-staging"):
        PagedScheduler(peng)


@pytest.mark.parametrize("budgets,default", [
    ("gold:4,silver:2:8,bronze:1:4:4096,*:1", "team a!"),
    ("gold:nope,:3,silver:2,,x:1:bad", None),
    ("", None),
])
def test_tenant_book_reads_the_two_variables(budgets, default, monkeypatch):
    monkeypatch.setenv("FEI_TPU_TENANT_BUDGETS", budgets)
    if default is None:
        monkeypatch.delenv("FEI_TPU_DEFAULT_TENANT", raising=False)
    else:
        monkeypatch.setenv("FEI_TPU_DEFAULT_TENANT", default)
    ours, theirs = TenantBook(), JaxTenantBook()
    assert ({k: dataclasses.astuple(v) for k, v in ours.policies.items()}
            == {k: dataclasses.astuple(v) for k, v in theirs.policies.items()})
    assert ours.default_tenant == theirs.default_tenant
    assert ours.configured == theirs.configured == bool(ours.policies)


def test_fault_arming_from_the_environment(monkeypatch):
    """FEI_TPU_FAULT arms the same points as the reference's; malformed or
    unknown entries are logged and skipped."""
    monkeypatch.setenv("FEI_TPU_FAULT",
                       "decode.dispatch:device:2, bogus, nope:request, kv.fetch:io")
    ours, theirs = FaultInjector(), JaxFaultInjector()
    assert sorted(ours._armed) == sorted(theirs._armed) == ["decode.dispatch", "kv.fetch"]
    assert ({p: f.count for p, f in ours._armed.items()}
            == {p: f.count for p, f in theirs._armed.items()})
    for _ in range(2):
        with pytest.raises(DeviceError):
            ours.check("decode.dispatch")
    ours.check("decode.dispatch")  # count=2: disarmed
    with pytest.raises(OSError):
        ours.check("kv.fetch")


BODY = {"messages": [{"role": "user", "content": "page tables"}],
        "max_tokens": 4, "ignore_eos": True}


def _capped_engine(monkeypatch, **env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    eng = InferenceEngine.from_config("tiny", paged=True, batch_size=1, page_size=16,
                                      device="cpu", dtype=torch.float32, max_seq_len=128)
    for k in env:
        monkeypatch.delenv(k)
    return eng


def test_server_answers_429_once_the_variable_cap_is_reached(monkeypatch):
    eng = _capped_engine(monkeypatch, FEI_TPU_MAX_QUEUE="1", FEI_TPU_RETRY_AFTER_S="3")
    sched = eng.scheduler
    assert sched.max_queue == 1
    sched._start_thread = lambda: None  # parked: submits wait in the queue
    api = ServeAPI(TorchLocalProvider(engine=eng))
    hold = sched.submit([5] * 8, GenerationConfig(max_new_tokens=4))
    try:
        status, payload, headers = api.handle("POST", "/v1/chat/completions", dict(BODY), {})
        assert status == 429 and payload["error"]["type"] == "overloaded_error"
        assert headers["Retry-After"] == "3"
    finally:
        sched.cancel(hold)
        eng.close()


def _shed_behind_a_running_request(api, sched, gen) -> tuple:
    """A completion whose propagated deadline has passed, queued behind a
    request that holds the only slot: (status, error type)."""
    hold = sched.submit([5] * 8, gen)
    try:
        status, payload = api.handle("POST", "/v1/chat/completions", dict(BODY),
                                     {"X-FEI-Deadline-S": "0"})[:2]
    finally:
        sched.cancel(hold)
    return status, payload.get("error", {}).get("type")


def test_server_sheds_a_passed_deadline_as_the_reference_does(monkeypatch):
    from fei_tpu.agent.providers import JaxLocalProvider
    from fei_tpu.engine.engine import GenerationConfig as JaxGenerationConfig
    from fei_tpu.ui.server import ServeAPI as JaxServeAPI

    eng = _capped_engine(monkeypatch)
    jeng = JaxEngine.from_config("tiny", paged=True, batch_size=1, page_size=16,
                                 max_seq_len=128)
    try:
        ours = _shed_behind_a_running_request(
            ServeAPI(TorchLocalProvider(engine=eng)), eng.scheduler,
            GenerationConfig(max_new_tokens=100, ignore_eos=True))
        theirs = _shed_behind_a_running_request(
            JaxServeAPI(JaxLocalProvider(engine=jeng)), jeng.scheduler,
            JaxGenerationConfig(max_new_tokens=100, ignore_eos=True))
        assert ours == theirs == (504, "timeout_error")
    finally:
        eng.close()
        jeng.close()


def test_server_serves_a_labelled_tenant_and_counts_it(monkeypatch):
    eng = _capped_engine(monkeypatch)
    api = ServeAPI(TorchLocalProvider(engine=eng))
    try:
        before = METRICS.snapshot()["counters"].get("tenant.acme.tokens_served", 0)
        status, payload = api.handle("POST", "/v1/chat/completions", dict(BODY),
                                     {"X-FEI-Tenant": "acme", "X-FEI-Priority": "3"})[:2]
        assert status == 200 and payload["usage"]["completion_tokens"] == 4
        after = METRICS.snapshot()["counters"].get("tenant.acme.tokens_served", 0)
        assert after - before == 4
    finally:
        eng.close()
