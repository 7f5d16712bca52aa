"""One run of one cell: ``python -m portbench --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``, from the repository's root.

The run builds the program's paged engine (``fei_tpu_torch``) on weights
made from the seed, warms the shapes the cell's traffic uses, starts the
load, lets it settle for the cell's ``ramp_s``, and measures ``--seconds``
seconds, from just after one burst of delivered tokens to just after the
first burst past that length (the scheduler hands a scan's tokens to the
clients together, so a window that cut a burst would count a share of a
scan that depends on where it fell). With ``--trace 1`` it then profiles
a steady slice of the same load. Then it stops the load, frees the
program and holds a sample of the served tokens against the plain
reference (``correctness.py``). The device's ``memory_peak_bytes`` is the
peak allocated less the KV pool's pages that no request or cache entry
ever held at once (the pool takes what the weights leave). The last
line of standard output is the result as one JSON object; the numbers
compared, each beside its limit, close standard error.

Metrics are read by one small module each, ``metrics/<name>.py``, whose
``read(view)`` returns the number or None when the run has nothing to read.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
TRACE_SECONDS = 3.0
FIRST_TOKEN_WAIT_S = 60.0


def process_start() -> float:
    """When this process started, on the ``time.time`` clock (from
    /proc; the import of this module where /proc is not there)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time()


T_START = process_start()


def cache_dirs() -> None:
    """Keep every build and kernel cache inside the checkout, at fixed
    paths (the program's nvcc libraries already live in build/)."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "portbench" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "portbench" / "torch_extensions"))
    os.environ["USE_FLAX"] = "0"  # keep transformers, if anything loads it, from loading JAX


@dataclass
class View:
    """What a metric reader sees of one run."""

    model: object  # spec.Model
    cell: object  # spec.Cell
    rows: int
    w0: float
    w1: float
    before: dict  # counters when the window opened
    after: dict  # counters when it closed
    records: list  # client.Record, every request sent
    setup_s: float
    slice: object | None = None  # trace.Slice in a traced run

    @property
    def window_s(self) -> float:
        return self.w1 - self.w0

    def delta(self, name: str) -> float:
        return self.after.get(name, 0.0) - self.before.get(name, 0.0)

    def due_in_window(self) -> list:
        return [r for r in self.records if self.w0 <= r.due <= self.w1]


def load_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def counters() -> dict:
    from fei_tpu_torch.utils.metrics import METRICS

    return METRICS.snapshot()["counters"]


def pages_in_use() -> float:
    """The program's gauge of KV pages held (by live requests and the
    prefix cache), read without its lock: one dict lookup a round."""
    from fei_tpu_torch.utils.metrics import METRICS

    return METRICS._gauges.get("pool.pages_in_use", 0.0)


def build_engine(cell, seed: int, device, parts: dict):
    import torch

    from fei_tpu_torch.engine.engine import InferenceEngine
    from fei_tpu_torch.ops.quant import quantize

    from portbench import spec, weights

    m = cell.model
    t = time.perf_counter()
    if device.type == "cuda":
        from fei_tpu_torch.ops.kernels import build

        for lib in cell.workload["kernels"]:
            build.load(lib)
    parts["kernels_s"] = time.perf_counter() - t
    t = time.perf_counter()
    params = weights.program_params(m, seed, device, quantize if m.quantize == "int8" else None)
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    parts["weights_s"] = time.perf_counter() - t
    t = time.perf_counter()
    page_bytes = 2 * m.layers * spec.PAGE_SIZE * m.kv_heads * m.head_dim * 2
    if device.type == "cuda":
        free = torch.cuda.mem_get_info(device)[0]
        pages = int((free - cell.workload["reserve_gib"] * 2**30) // page_bytes)
    else:
        pages = cell.workload["cpu_pages"]
    engine = InferenceEngine.from_config(
        cell.config["port_preset"], paged=True, batch_size=cell.workload["rows"],
        num_pages=pages, page_size=spec.PAGE_SIZE, prefix_cache=True, quantize=m.quantize,
        params=params, device=device, **spec.port_overrides(cell.config))
    engine.scheduler._ensure_pool()
    if device.type == "cuda":
        torch.cuda.synchronize()
    parts["pool_s"] = time.perf_counter() - t
    parts["pool_pages"] = pages
    parts["page_bytes"] = page_bytes
    return engine


def gen_config(max_new: int):
    from fei_tpu_torch.engine.engine import GenerationConfig

    return GenerationConfig(max_new_tokens=max_new, temperature=0.0, ignore_eos=True)


def warm_up(engine, traffic, seed: int) -> None:
    """One request at each prompt bucket the mix uses, long enough for two
    decode scans, all in flight together; the mix's own ramp warms the rest."""
    import random

    sched = engine.scheduler
    rng = random.Random(seed ^ 0x3A7)
    seqs = [sched.submit([rng.randrange(3, engine.cfg.vocab_size) for _ in range(n)],
                         gen_config(2 * sched.multistep + 1))
            for n in traffic.warm_lengths(sched.prefill_chunk)]
    for s in seqs:
        for _ in sched.drain(s):
            pass


def serve(cell, seed: int, seconds: float, trace: bool, device,
          t_start: float) -> tuple[dict, list, list, dict]:
    """Run the cell's load and measure it; returns (result, the numbers
    compared as (name, value, limit), the sampled requests, every number
    the sample's gaps give)."""
    import torch

    from portbench import correctness, spec, traffic as traffic_mod
    from portbench.client import LoadGenerator
    from portbench.trace import HostSpans, profile_slice

    parts: dict = {"start_and_import_s": time.time() - t_start}
    m = cell.model
    engine = build_engine(cell, seed, device, parts)
    spans = HostSpans() if trace else None
    mix = traffic_mod.make(cell.traffic, seed, m.vocab)
    t = time.perf_counter()
    warm_up(engine, mix, seed)
    parts["warm_s"] = time.perf_counter() - t
    load = LoadGenerator(engine.scheduler, mix, gen_config, probe=pages_in_use)
    load.start()
    time.sleep(cell.workload["ramp_s"])
    # the window opens and closes just after a burst of delivered tokens
    w0 = load.next_burst(time.perf_counter())
    before = counters()
    setup_s = time.time() - t_start
    time.sleep(max(0.0, w0 + seconds - time.perf_counter()))
    w1 = load.next_burst(w0 + seconds)
    after = counters()
    view = View(m, cell, cell.workload["rows"], w0, w1, before, after, load.records, setup_s)
    if trace:
        view.slice = profile_slice(
            TRACE_SECONDS, engine.scheduler, spans, counters,
            lambda: {id(r): len(r.seq.generated) for r in list(load.records) if r.seq is not None})
    load.stop_submitting()
    load.wait_first_tokens(w0, w1, FIRST_TOKEN_WAIT_S)
    load.close()
    on_gpu = device.type == "cuda"
    # the peak, counting of the KV pool only the pages ever held at once:
    # the pool takes what the weights leave, and a page no request held is
    # memory kept free, not used (pages_in_use leaves out the null page)
    parts["pages_in_use_peak"] = load.probe_peak
    unused = max(0, parts["pool_pages"] - 1 - int(load.probe_peak)) * parts["page_bytes"]
    parts["allocated_peak_bytes"] = torch.cuda.max_memory_allocated(device) if on_gpu else 0
    peak = max(0, parts["allocated_peak_bytes"] - unused) if on_gpu else 0
    engine.close()
    del engine
    gc.collect()
    if on_gpu:
        torch.cuda.empty_cache()
        parts["left_after_free_bytes"] = torch.cuda.memory_allocated(device)
    due = view.due_in_window()
    finished = [r for r in load.records if r.finished and r.ended is not None and w0 <= r.ended <= w1]
    check = cell.workload["check"]
    picked = correctness.sample(finished, seed, check["tokens"])
    t = time.perf_counter()
    read = correctness.numbers(correctness.served_gaps(m, seed, picked, device)) if picked else {}
    parts["reference_s"] = time.perf_counter() - t
    parts["sampled"] = [len(picked), sum(len(r.tokens) for r in picked)]
    parts["gaps"] = read
    parts["window_counts"] = {k: view.delta(f"scheduler.{k}")
                              for k in ("decode_steps", "decode_slot_steps", "prefill_tokens")}
    parts["tokens_per_5s"] = [sum(1 for r in load.records for x in r.stamps
                                  if w0 + 5 * i <= x < min(w1, w0 + 5 * i + 5))
                              for i in range(int((w1 - w0) // 5))]
    print("setup " + json.dumps({"setup_s": setup_s, **parts}), flush=True)
    compared, correct = correctness.judge(read, check["limits"])

    metrics = {}
    for entry in spec.metrics_for(cell.name, trace):
        if entry["name"] == "setup_s":
            value = setup_s
        else:
            value = load_reader(entry["name"])(view)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    result = {
        "correct": correct,
        "attempted": len(due),
        "failed": sum(1 for r in due if r.error is not None),
        "metrics": metrics,
        "device": device_info(device, peak, view.slice),
    }
    if view.slice is not None:
        result["breakdown"] = view.slice.breakdown()
    # a number with no sample to read is reported as null, never as Infinity
    result["checks"] = {n: {"value": v if math.isfinite(v) else None, "limit": lim}
                        for n, v, lim in compared}
    return result, compared, picked, read


def device_info(device, peak: int, sl) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": peak}
    if sl is not None:
        info.update(busy_s=sl.busy_s(), window_s=sl.wall_s)
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    from portbench import spec

    cell = spec.load_cell(args.workload)  # a checkout without BENCHMARK.json stops here
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    try:
        import fei_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"portbench: the program is not here: {exc}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result, compared, _, _ = serve(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    from portbench.guard import forbidden_modules

    bad = forbidden_modules()
    if bad:
        print(f"portbench: modules of the JAX side were loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, value, limit in compared:
        print(f"check {name}: {value} (limit {limit})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
