"""The port's ServeAPI against fei_tpu's over the same fp32 tiny weights,
greedy: /health, /metrics, /v1/models, and /v1/chat/completions as JSON
and as SSE, with completion text identical to the JAX server's. A tools
request with constrain_tools on (the default) fails with the
ProviderError that names the unported grammar module."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fei_tpu.agent.providers import JaxLocalProvider
from fei_tpu.engine.engine import InferenceEngine as JaxEngine
from fei_tpu.ui.server import ServeAPI as JaxServeAPI
from fei_tpu_torch.agent.providers import TorchLocalProvider
from fei_tpu_torch.engine.engine import InferenceEngine
from fei_tpu_torch.engine.tokenizer import load_tokenizer
from fei_tpu_torch.models.configs import get_model_config
from fei_tpu_torch.models.convert import params_from_jax
from fei_tpu_torch.ui.server import ServeAPI, ServingServer
from fei_tpu_torch.utils.errors import ProviderError

BODY = {
    "messages": [
        {"role": "system", "content": "be brief"},
        {"role": "user", "content": "say something about tensors"},
    ],
    "max_tokens": 12,
    "ignore_eos": True,
}


@pytest.fixture(scope="module")
def apis():
    jeng = JaxEngine.from_config("tiny", dtype=jnp.float32, max_seq_len=128)
    params = params_from_jax(jax.tree.map(np.asarray, jeng.params))
    peng = InferenceEngine(
        get_model_config("tiny"), params, load_tokenizer("byte"),
        max_seq_len=128, dtype=torch.float32, device="cpu",
    )
    return JaxServeAPI(JaxLocalProvider(engine=jeng)), ServeAPI(TorchLocalProvider(engine=peng))


def _sse_content(frames: bytes) -> tuple[str, list[dict]]:
    lines = [ln[6:] for ln in frames.decode().split("\n") if ln.startswith("data: ")]
    assert lines[-1] == "[DONE]"
    chunks = [json.loads(x) for x in lines[:-1]]
    text = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks)
    return text, chunks


def test_health_models_metrics(apis):
    _, api = apis
    status, body = api.handle("GET", "/health", {}, {})
    assert status == 200 and body["status"] == "ok" and body["device"] == "cpu"
    status, body = api.handle("GET", "/v1/models", {}, {})
    assert status == 200 and body["data"][0]["id"] == api.model_name
    status, text = api.handle("GET", "/metrics", {}, {})
    assert status == 200 and "fei_server_requests_total" in text
    assert api.handle("POST", "/kv/export", {}, {})[0] == 404


def test_chat_json_matches_jax_server(apis):
    jax_api, api = apis
    jstatus, jout = jax_api.handle("POST", "/v1/chat/completions", dict(BODY), {})
    status, out = api.handle("POST", "/v1/chat/completions", dict(BODY), {})
    assert status == jstatus == 200
    assert out["choices"][0]["message"]["content"] == jout["choices"][0]["message"]["content"]
    assert out["usage"] == jout["usage"]
    assert out["usage"]["completion_tokens"] == 12


def test_chat_sse_matches_jax_server(apis):
    jax_api, api = apis
    body = dict(BODY, stream=True)
    jtext, _ = _sse_content(b"".join(jax_api.stream_chat(body, jax_api._parse_request(body))))
    text, chunks = _sse_content(b"".join(api.stream_chat(body, api._parse_request(body))))
    assert text == jtext
    assert chunks[0]["choices"][0]["delta"] == {"role": "assistant"}
    assert chunks[-1]["choices"][0]["finish_reason"] == "stop"


def test_tools_with_constrained_decoding_raise(apis):
    _, api = apis
    provider = api.provider
    tools = [{"name": "Glob", "description": "find files",
              "input_schema": {"type": "object", "properties": {"pattern": {"type": "string"}}}}]
    with pytest.raises(ProviderError, match="engine.grammar"):
        provider.complete([{"role": "user", "content": "x"}], tools=tools, max_tokens=2)
    body = dict(BODY, tools=[{"type": "function", "function": {"name": "Glob"}}])
    status, out = api.handle("POST", "/v1/chat/completions", body, {})
    assert status == 500 and "grammar" in out["error"]["message"]


def test_bad_requests_and_auth(apis):
    _, api = apis
    assert api.handle("POST", "/v1/chat/completions", {"messages": "x"}, {})[0] == 400
    assert api.handle("POST", "/v1/chat/completions", dict(BODY, max_tokens=-1), {})[0] == 400
    keyed = ServeAPI(api.provider, api_key="k")
    assert keyed.handle("GET", "/v1/models", {}, {})[0] == 401
    assert keyed.handle("GET", "/v1/models", {}, {"Authorization": "Bearer k"})[0] == 200


def test_serving_server_over_http(apis):
    import urllib.request

    _, api = apis
    server = ServingServer(api, host="127.0.0.1", port=0)
    server.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/v1/chat/completions",
            data=json.dumps(BODY).encode(), method="POST",
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        assert out["usage"]["completion_tokens"] == 12
    finally:
        server.stop()


def test_full_queue_answers_429_with_retry_after(apis):
    """Over a paged engine whose waiting queue is full, a completion is
    shed with 429 and Retry-After (JSON over ServeAPI and over HTTP), and
    a degraded engine answers /health with 503."""
    import urllib.error
    import urllib.request

    _, api = apis
    eng = InferenceEngine.from_config(
        "tiny", params=api.provider.engine.params, paged=True, batch_size=1,
        page_size=16, device="cpu", dtype=torch.float32, max_seq_len=128)
    paged = ServeAPI(TorchLocalProvider(engine=eng))
    sched = eng.scheduler
    from fei_tpu_torch.engine.engine import GenerationConfig

    hold = [sched.submit([5] * 8, GenerationConfig(max_new_tokens=100, ignore_eos=True))
            for _ in range(2)]
    sched.max_queue = 1  # one slot busy (or about to be), one request queued
    server = ServingServer(paged, host="127.0.0.1", port=0)
    server.start()
    try:
        out = paged.handle("POST", "/v1/chat/completions", dict(BODY), {})
        assert out[0] == 429 and out[1]["error"]["type"] == "overloaded_error"
        assert out[2]["Retry-After"] == "1"
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/v1/chat/completions",
            data=json.dumps(BODY).encode(), method="POST",
            headers={"Content-Type": "application/json"},
        )
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=60)
        assert err.value.code == 429 and err.value.headers["Retry-After"] == "1"
        sched._degraded_until = float("inf")
        status, health, headers = paged.handle("GET", "/health", {}, {})
        assert status == 503 and health["status"] == "degraded" and "Retry-After" in headers
    finally:
        sched.reset_degraded()
        server.stop()
        for s in hold:
            sched.cancel(s)
        eng.close()
