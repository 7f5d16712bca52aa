"""The readings a cell's correctness limit is set from, on the chip:
``python -m portbench.calibrate --workload <cell> --seeds <a,b,...>
--control-seeds <n> --seconds <s>``.

For each seed, in one process, it runs the cell's timed path at its own
load and window and reads every number of ``correctness.NUMBERS`` from the
gaps of the sampled served tokens (a number's lower reading is the largest
over the seeds). For the first ``--control-seeds`` seeds it also reads the
control on the same sample: the reference a precision step lower, put in
the program's place (the upper reading is the least of those), and judges
it as a run would, with the cell's own limits (``correct`` of the control,
which has to come out false). One JSON line per seed goes to
standard output and to ``chiprun_out/calibrate-<cell>.jsonl``.
"""

from __future__ import annotations

import argparse
import gc
import json
import time

from portbench.run import ROOT, cache_dirs, serve


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=15)
    args = ap.parse_args(argv)
    cache_dirs()
    import torch

    from portbench import correctness, spec

    cell = spec.load_cell(args.workload)
    device = torch.device("cuda", 0)
    out = ROOT / "chiprun_out" / f"calibrate-{cell.name}.jsonl"
    out.parent.mkdir(exist_ok=True)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        result, _, picked, read = serve(cell, seed, args.seconds, False, device, t0)
        line = {"seed": seed, "served": read, "correct": result["correct"],
                "tokens": sum(len(r.tokens) for r in picked), "requests": len(picked),
                "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                "memory_peak_bytes": result["device"]["memory_peak_bytes"]}
        if i < args.control_seeds:
            t = time.perf_counter()
            line["control"] = correctness.numbers(
                correctness.control_gaps(cell.model, seed, picked, device))
            line["control_s"] = time.perf_counter() - t
            line["control_correct"] = correctness.judge(
                line["control"], cell.workload["check"]["limits"])[1]
        line["seconds"] = time.time() - t0
        print(json.dumps(line), flush=True)
        with open(out, "a") as f:
            f.write(json.dumps(line) + "\n")
        del result, picked, read
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
