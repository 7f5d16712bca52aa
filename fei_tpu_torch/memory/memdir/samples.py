"""Sample-memory generator for demos and tests
(reference memdir_tools/create_samples.py:197-244).

Populates a Memdir store with ~20 memories spread over the standard and
special folders, with realistic headers, tags, flags, and staggered dates so
search/filter/archiver demos have something to chew on.

A copy of ``fei_tpu/memory/memdir/samples.py`` that imports only the port.
"""

from __future__ import annotations

import argparse
import time

from fei_tpu_torch.memory.memdir.store import MemdirStore

_DAY = 86400.0

# (folder, subject, content, tags, flags, age_days)
SAMPLES = [
    ("", "Python decorators cheat sheet",
     "functools.wraps preserves __name__/__doc__ on wrapped functions.",
     ["python", "reference"], "S", 1),
    ("", "JAX donation semantics",
     "donate_argnums invalidates the input buffer; reuse raises.",
     ["jax", "tpu"], "", 2),
    ("", "Pallas tiling constraint",
     "Last two block dims must be (8k, 128m) or match the array dims.",
     ["tpu", "pallas", "kernels"], "F", 3),
    ("", "Ring attention sketch",
     "Rotate KV with ppermute; online softmax carries (m, l, acc).",
     ["tpu", "attention"], "", 5),
    ("", "Standup notes",
     "Paged KV landed; grammar decode next. Bench on Thursday.",
     ["meeting"], "S", 0),
    ("", "Shell allowlist rationale",
     "Deny raw rm -rf and sudo; allow git/ls/grep/python.",
     ["security", "tools"], "", 8),
    ("", "Mesh axis conventions",
     "dp/tp/ep/sp/pp — size-1 axes are legal everywhere.",
     ["tpu", "parallel"], "R", 4),
    ("", "Interview question bank",
     "Ask about cache coherence and tail latency budgets.",
     ["hiring"], "", 21),
    (".Projects", "Project: memdir search parity",
     "Query language: #tag, +F flags, field:value, /regex/, sort:, limit:.",
     ["project", "memdir"], "S", 6),
    (".Projects", "Project: bench harness",
     "One JSON line; tok/s/chip and p50 TTFT per BASELINE config.",
     ["project", "bench"], "", 7),
    (".Projects", "Project: federation",
     "Map chain nodes to sub-meshes; gossip → ICI all-gather.",
     ["project", "memorychain"], "P", 9),
    (".ToDoLater", "Try int8 weights for 70B",
     "v5e has 16 GB HBM/chip; bf16 70B needs ~140 GB — quantize or shard.",
     ["todo", "quantization"], "", 11),
    (".ToDoLater", "Profile prefill HBM traffic",
     "Check if XLA fuses rope into the qkv matmuls or materializes.",
     ["todo", "profiling"], "", 13),
    (".Archive", "Old: initial survey notes",
     "Reference is 100% Python; the TPU build is greenfield.",
     ["survey"], "S", 120),
    (".Archive", "Old: provider interface draft",
     "(messages, system, tools) -> (text, tool_calls).",
     ["design"], "S", 95),
    (".Trash", "Scratch: failed idea",
     "Per-token host sync for grammar masks — too slow, superseded.",
     ["scratch"], "", 30),
    ("", "Completed: tokenizer parity",
     "[x] byte tokenizer round-trips; chat template matches llama3 shape.",
     ["done"], "S", 14),
    ("", "Urgent: fix flaky watchdog",
     "priority: high — memorychain vote timeout flaps under load.",
     ["urgent", "bug"], "F", 1),
    ("", "Learning: scaling-book notes",
     "Pick a mesh, annotate shardings, let XLA insert collectives.",
     ["learning", "tpu"], "", 2),
    ("", "AI assistant UX notes",
     "Stream tokens as they decode; whole-message render feels dead.",
     ["ai", "ux"], "", 3),
]


def create_samples(store: MemdirStore | None = None, base: str | None = None) -> int:
    """Write the sample corpus; returns the number of memories created."""
    store = store or MemdirStore(base)
    now = time.time()
    count = 0
    for folder, subject, content, tags, flags, age_days in SAMPLES:
        headers = {
            "Subject": subject,
            "Date": time.strftime(
                "%a, %d %b %Y %H:%M:%S +0000",
                time.gmtime(now - age_days * _DAY),
            ),
        }
        if "urgent" in tags:
            headers["Priority"] = "high"
        store.save(content, headers=headers, folder=folder, flags=flags, tags=tags)
        count += 1
    return count


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m fei_tpu_torch.memory.memdir.samples",
        description="populate a Memdir store with sample memories",
    )
    p.add_argument("--base", default=None, help="store directory (default ./Memdir)")
    args = p.parse_args(argv)
    n = create_samples(base=args.base)
    print(f"created {n} sample memories in {MemdirStore(args.base).base}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
