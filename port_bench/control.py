#!/usr/bin/env python3
"""Readings that set the limits of check.py, at a cell's own size, each
taken by a whole run of the cell (run.run_cell: the window, the frames
drawn from the seed, the reference, check.judge):

    python3 port_bench/control.py --workload <cell> --seeds 1,2,... \
        --wraps sound,control_bf16,panes_dropped --seconds 4 [--out <json>]

"sound" is the program as it is: the lower readings. Any other name is a
wrap of faults.py put in the program's place: the control (the reference
in bfloat16) or a planted fault, the upper readings. One line of JSON a
run (its compared numbers, `correct`, the frames checked), then one
summary line. It needs a card; the benchmark's runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def readings(workload: str, seed: int, wrap: str, seconds: float,
             device: str = "cuda", edit_cfg=None) -> dict:
    from port_bench import faults, run

    res = run.run_cell(workload, seed, seconds, False, device=device,
                       edit_cfg=edit_cfg,
                       wrap=None if wrap == "sound" else faults.WRAPS[wrap],
                       log=lambda msg: None)
    return {"workload": workload, "wrap": wrap, "seed": seed,
            "correct": res["correct"], "attempted": res["attempted"],
            "check": {n: v["value"] for n, v in res["check"].items()}}


def summary(rows) -> dict:
    out = {}
    for row in rows:
        s = out.setdefault(row["wrap"], {"runs": 0, "correct": 0})
        s["runs"] += 1
        s["correct"] += int(row["correct"])
        for n, v in row["check"].items():
            lo, hi = s.get(n, (v, v))
            s[n] = (min(lo, v), max(hi, v))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--wraps", default="sound")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from port_bench import run

    run._caches_in_checkout()
    import torch

    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 3
    rows = []
    for wrap in args.wraps.split(","):
        for s in args.seeds.split(","):
            rows.append(readings(args.workload, int(s), wrap, args.seconds))
            print(json.dumps(rows[-1]), flush=True)
    summ = {"workload": args.workload,
            "device": torch.cuda.get_device_name(0), "wraps": summary(rows)}
    print(json.dumps(summ), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summ}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
