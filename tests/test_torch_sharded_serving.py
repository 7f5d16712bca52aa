"""Tensor- and data-parallel serving in the port (fei_tpu_torch/parallel/)
against fei_tpu, at the tiny config (two layers, fp32, the same weights in
both packages through ``params_from_jax``).

The port's side runs in gloo ranks on the CPU (tests/torch_mesh_ranks.py):
one group of two ranks runs every two-rank case once, one group of four
the tp2dp2 case, and the parametrised tests below read their results, so
each claim still counts on its own:

- the sharded K2/K3/K4 wrappers equal the unsharded kernels bitwise, and
  a gather in the wrong head order does not;
- the paged tp2 (both weight profiles) and tp2dp2 greedy and seeded
  streams are bitwise the port's one-rank streams and equal fei_tpu's
  single-chip streams (the reference's own tp2 greedy stream is a known
  reference failure, so no claim leans on it);
- the tp2 forward's logits of both profiles are within 1e-4 of fei_tpu's
  tp2 forward and of its single-chip forward;
- int4 under tp2 (K4 column-sharded, wo/w_down int8) on fei_tpu's int4
  tp2 weights, held to fei_tpu's tp2 and single-chip int4 logits;
- a sharded streaming load of an HF-layout safetensors checkpoint (the
  tensor names and ``config.json`` of ``save_pretrained``, written here
  from the same weights; tests/test_torch_weights.py holds the loader
  against files ``transformers`` itself writes), held to fei_tpu loading
  the same files on one chip and into its tp2 mesh;
- a tp2 drain restored on one rank, a tp2 FKV1 blob landing on one rank
  and the reverse;
- ``FEI_TPU_MESH=tp2 python -m fei_tpu_torch serve`` answers, reports
  ``mesh: "tp2"`` on /health and stops both ranks on SIGTERM.
"""

import torch_threads  # noqa: F401  (first: one torch thread per test process)

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fei_tpu.engine.engine import GenerationConfig as JaxGen
from fei_tpu.engine.engine import InferenceEngine as JaxEngine
from fei_tpu.models.llama import KVCache as JaxCache
from fei_tpu.models.llama import forward as jax_forward
from fei_tpu.parallel.mesh import make_mesh as jax_make_mesh
from fei_tpu.parallel.sharding import REPLICATED_RULES, shard_params
from fei_tpu_torch.engine.weights import _leaf_specs
from fei_tpu_torch.models.configs import get_model_config
from fei_tpu_torch.models.convert import params_from_jax

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_mesh_ranks import MAX_SEQ, N_NEW, PROMPTS, SEED  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PROFILES = ["replicated", "sharded"]
# the int4 model: tiny widened so that every linear's contraction takes int4
INT4 = dict(dtype=jnp.float32, seed=0, max_seq_len=MAX_SEQ, num_layers=2, hidden_size=512,
            intermediate_size=1024, num_heads=8, num_kv_heads=4)


def _jax_tp2():
    return jax_make_mesh({"tp": 2}, devices=jax.devices()[:2])


def _int4_close(got, want):
    """int4's tolerance against fei_tpu (tests/test_torch_quant_model.py):
    both packages round x to bf16 inside an int4 linear, and the JAX
    kernel also rounds its output to bf16, so the logits differ by bf16
    steps, not by fp32 noise."""
    np.testing.assert_allclose(got, want, atol=1e-2 * np.abs(want).max(), rtol=0)


def _save_hf(params: dict, path: Path) -> None:
    """The tiny model as an HF Llama checkpoint: model.safetensors under the
    HF tensor names ([out, in] linears) and its config.json."""
    from safetensors.torch import save_file

    cfg = get_model_config("tiny", num_layers=2)
    tensors = {}
    for where, (tmpl, _, transpose) in _leaf_specs(cfg).items():
        leaf = params[where[0]] if len(where) == 1 else params["layers"][where[1]]
        layers = range(cfg.num_layers) if where[0] == "layers" else [None]
        for i in layers:
            t = leaf if i is None else leaf[i]
            tensors[tmpl.format(i=i)] = (t.T if transpose else t).contiguous()
    path.mkdir()
    save_file(tensors, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps({
        "model_type": "llama", "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size, "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads, "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_norm_eps, "max_position_embeddings": MAX_SEQ,
        "tie_word_embeddings": cfg.tie_embeddings}))


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """fei_tpu's single-chip engine, the inputs every rank reads, and both
    rank groups, started here so that they run while the JAX side computes
    its references."""
    from torch_mesh_ranks import RankRun

    d = tmp_path_factory.mktemp("mesh")
    eng = JaxEngine.from_config("tiny", dtype=jnp.float32, max_seq_len=MAX_SEQ, num_layers=2)
    params = params_from_jax(jax.tree.map(np.asarray, eng.params))
    torch.save(params, d / "params.pt")
    _save_hf(params, d / "ckpt")
    # fei_tpu's int4 engine on its tp2 mesh: wo/w_down stay int8 there too
    int4 = JaxEngine.from_config("tiny", quantize="int4", mesh=_jax_tp2(), **INT4)
    torch.save(params_from_jax(jax.tree.map(np.asarray, jax.device_get(int4.params))),
               d / "int4.pt")
    runs = {
        "two": RankRun(2, "serving", {"params": str(d / "params.pt"), "ckpt": str(d / "ckpt"),
                                      "int4_params": str(d / "int4.pt"),
                                      "drain_dir": str(d / "drain")}, str(d)),
        "four": RankRun(4, "tp2dp2", {"params": str(d / "params.pt")}, str(d)),
    }
    return {"eng": eng, "int4": int4, "dir": d, "runs": runs}


@pytest.fixture(scope="module")
def jax_streams(ref):
    eng = ref["eng"]
    greedy = JaxGen(max_new_tokens=N_NEW, ignore_eos=True, chunk=1)
    seeded = JaxGen(max_new_tokens=N_NEW, ignore_eos=True, chunk=1, seed=SEED,
                    temperature=0.8, top_p=0.9)
    out = {i: list(eng.generate_stream(p, greedy)) for i, p in enumerate(PROMPTS)}
    out["seeded"] = list(eng.generate_stream(PROMPTS[0], seeded))
    return out


@pytest.fixture(scope="module")
def jax_logits(ref):
    """fei_tpu's forward of PROMPTS[1]: single chip, and tp2 under each
    weight profile on the conftest's virtual CPU mesh."""
    eng = ref["eng"]
    cfg = eng.cfg
    toks = jnp.asarray([PROMPTS[1]], dtype=jnp.int32)
    single, _ = jax_forward(eng.params, cfg, toks, JaxCache.create(cfg, 1, 64, jnp.float32))
    mesh = _jax_tp2()
    fwd = jax.jit(lambda p, t, c: jax_forward(p, cfg, t, c))
    out = {"single": np.asarray(single)}
    for profile, rules in (("replicated", REPLICATED_RULES), ("sharded", None)):
        sp = shard_params(eng.params, mesh, cfg.is_moe, rules=rules)
        got, _ = fwd(sp, toks, JaxCache.create(cfg, 1, 64, jnp.float32))
        out[profile] = np.asarray(got)
    return out


@pytest.fixture(scope="module")
def jax_int4(ref):
    """fei_tpu's int4 tp2 engine's prefill logits of PROMPTS[0], and a
    single-chip forward over the same weight values."""
    eng = ref["int4"]
    tp2, _ = eng.prefill([PROMPTS[0]], eng.new_cache(1))
    toks = jnp.asarray([PROMPTS[0]], dtype=jnp.int32)
    single, _ = jax_forward(jax.device_get(eng.params), eng.cfg, toks,
                            JaxCache.create(eng.cfg, 1, 64, jnp.float32))
    return {"tp2": np.asarray(tp2), "single": np.asarray(single[:, -1])}


@pytest.fixture(scope="module")
def jax_load(ref):
    """fei_tpu loading the same HF checkpoint (int8), on one chip and
    streamed into its tp2 mesh: the prefill logits of PROMPTS[0]."""
    out = {}
    for name, mesh in (("single", None), ("tp2", _jax_tp2())):
        eng = JaxEngine.from_config("tiny", checkpoint_dir=str(ref["dir"] / "ckpt"),
                                    dtype=jnp.float32, quantize="int8",
                                    max_seq_len=MAX_SEQ, mesh=mesh)
        logits, _ = eng.prefill([PROMPTS[0]], eng.new_cache(1))
        out[name] = np.asarray(logits)
    return out


@pytest.fixture(scope="module")
def two(ref, jax_streams, jax_logits, jax_int4, jax_load):
    return ref["runs"]["two"].result()


@pytest.fixture(scope="module")
def four(ref, jax_streams):
    return ref["runs"]["four"].result()


@pytest.mark.parametrize("name", ["paged_attention", "paged_attention_block",
                                  "ragged_paged_attention", "int4_mm_m1", "int4_mm_m8",
                                  "int4_mm_m256"])
def test_sharded_wrapper_bitwise(two, name):
    assert two[0]["wrappers"][name] is True


def test_head_order_mutant_caught(two):
    assert two[0]["wrappers"]["mutant"] is False


@pytest.mark.parametrize("stream", [0, 1, 2, "seeded"])
@pytest.mark.parametrize("profile", PROFILES)
def test_tp2_paged_streams(two, jax_streams, profile, stream):
    r = two[0]
    key = "tp2_streams" if profile == "replicated" else "sharded_streams"
    assert r[key][stream] == r["ms1_streams"][stream]
    assert r["ms1_streams"][stream] == jax_streams[stream]


@pytest.mark.parametrize("stream", [0, 1, 2, "seeded"])
def test_tp2dp2_paged_streams(four, jax_streams, stream):
    r = four[0]
    assert r["tag"] == "dp2tp2" and r["slots"] == 4  # 2 slots per dp group
    assert r["streams"][stream] == r["ms1_streams"][stream] == jax_streams[stream]
    assert {(c["dp"], c["tp"]) for c in (x["coords"] for x in four)} == {
        (0, 0), (0, 1), (1, 0), (1, 1)}


def test_mesh_records(two):
    r = two[0]
    assert r["tag"] == "tp2" and r["backend"] == "gloo"
    assert r["geometry"] == {"dp": 1, "tp": 2, "ep": 1, "sp": 1, "pp": 1}
    assert r["replicated_weights"] == "replicated"  # FEI_TPU_MESH's default
    assert r["kv_fingerprint"]["kv_heads"] == 2 and r["pool_heads"] == 1
    assert r["kv_layout"] == {"tp": 2, "head_slices": [[0, 1], [1, 2]]}
    assert r["dispatches"] > 0


@pytest.mark.parametrize("against", ["single", "tp2"])
@pytest.mark.parametrize("profile", PROFILES)
def test_tp2_logits_match_jax(two, jax_logits, profile, against):
    got = two[0][f"forward_{profile}"]
    want = jax_logits["single" if against == "single" else profile]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_allclose(two[0][f"logits_{profile}"], want[0, -1:], atol=1e-4, rtol=0)


@pytest.mark.parametrize("profile", PROFILES)
def test_tp2_dense_stream_matches_jax(two, jax_streams, profile):
    assert two[0][f"dense_{profile}"] == jax_streams[0]


def test_megatron_halves_param_bytes(two):
    for r in two:
        assert r["sharded_bytes"] < 0.6 * r["replicated_bytes"]
    assert two[0]["sharded_bytes"] == two[1]["sharded_bytes"]
    assert two[0]["sharded_wq"][-1] * 2 == 64  # tiny: 4 heads x 16, half each


def test_int4_tp2(two):
    """K4 column-sharded, wo/w_down int8 (their contraction is what tp
    splits): the port's int4 tp2 build keeps them int8, and on fei_tpu's
    int4 tp2 weights the replicated profile's logits are bitwise those of
    a one-rank engine on the same weights."""
    r = two[0]
    kinds = r["int4_kinds"]
    assert kinds["wo"] == kinds["w_down"] == "QTensor"
    assert {kinds[k] for k in ("wq", "wk", "wv", "w_gate", "w_up")} == {"QTensor4"}
    np.testing.assert_array_equal(r["int4_tp2_replicated"], r["int4_ms1"])


@pytest.mark.parametrize("against", ["single", "tp2"])
@pytest.mark.parametrize("profile", ["ms1", *PROFILES])
def test_int4_tp2_matches_jax(two, jax_int4, profile, against):
    """The port's int4 logits (one rank, tp2 under both profiles) on
    fei_tpu's int4 tp2 weights, against fei_tpu's int4 tp2 engine and its
    single-chip forward over the same values."""
    key = "int4_ms1" if profile == "ms1" else f"int4_tp2_{profile}"
    _int4_close(two[0][key], jax_int4[against])


def test_sharded_streaming_load(two):
    r = two[0]
    np.testing.assert_allclose(r["load_tp2"], r["load_ms1"], atol=1e-5, rtol=0)
    for rank in two:
        assert rank["load_bytes"] < 0.6 * r["load_ms1_bytes"]
        assert rank["load_wo"] == (2, 32, 64)  # wo's 64 input rows, half each


@pytest.mark.parametrize("against", ["single", "tp2"])
@pytest.mark.parametrize("load", ["load_ms1", "load_tp2"])
def test_sharded_load_matches_jax(two, jax_load, load, against):
    """The port's loads of the HF checkpoint (one rank, and streamed into
    tp2 shards) against fei_tpu loading the same files, on one chip and
    into its tp2 mesh: int8 logits at 1e-4."""
    np.testing.assert_allclose(two[0][load], jax_load[against], atol=1e-4, rtol=0)


def test_tp2_drain_restores_on_one_rank(two):
    r = two[0]
    assert r["restored"] == [r["ms1_streams"][0], r["ms1_streams"][1]]


def test_tp2_fkv1_blob_lands_on_one_rank(two):
    r = two[0]
    assert r["blob_layout"] == {"tp": 2, "head_slices": [[0, 1], [1, 2]]}
    assert r["landed_pages"] > 0
    assert r["ms1_next"] == r["tp2_next"]


def test_one_rank_blob_lands_on_tp2(two):
    """The reverse: each tp2 rank scatters its heads of a one-rank blob."""
    r = two[0]
    assert r["tp2_landed_pages"] > 0
    assert r["tp2_landed_next"] == r["tp2_next"]


def _alive(pid: int) -> bool:
    """A process that exists and is no zombie."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _followers(pid: int) -> list[int]:
    """The spawned rank processes of ``pid`` (its children started through
    multiprocessing's spawn, not its resource tracker)."""
    kids = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read()
        except OSError:
            continue
        if ppid == pid and b"spawn_main" in cmd and b"resource_tracker" not in cmd:
            kids.append(int(entry))
    return kids


def test_serve_tp2_answers_and_stops_both_ranks(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, FEI_TPU_MESH="tp2", FEI_TPU_TORCH_LOCAL_PAGED="1",
               FEI_TPU_TORCH_LOCAL_MAX_SEQ_LEN="128", FEI_TPU_DRAIN_DEADLINE_S="5",
               HOME=str(tmp_path), PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "fei_tpu_torch", "serve", "--device", "cpu", "--model",
         "tiny", "--port", str(port)], cwd=str(tmp_path), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        health = None
        for _ in range(240):
            try:
                with urllib.request.urlopen(base + "/health", timeout=2) as resp:
                    health = json.loads(resp.read())
                break
            except OSError:
                if proc.poll() is not None:
                    break
                time.sleep(0.25)
        assert health is not None, proc.stdout.read() if proc.poll() is not None else ""
        assert health["mesh"] == "tp2" and health["kv_layout"]["tp"] == 2
        body = json.dumps({"model": "tiny", "max_tokens": 4, "temperature": 0,
                           "messages": [{"role": "user", "content": "hi"}]}).encode()
        req = urllib.request.Request(base + "/v1/chat/completions", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 200
            assert json.loads(resp.read())["choices"][0]["message"]["role"] == "assistant"
        followers = _followers(proc.pid)
        assert len(followers) == 1, "tp2 runs one follower rank"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        deadline = time.time() + 30
        while time.time() < deadline and any(_alive(p) for p in followers):
            time.sleep(0.2)
        assert not any(_alive(p) for p in followers)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
