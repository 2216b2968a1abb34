"""Readings for setting a cell's limits, many seeds in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds 3]
        [--control | --int8 | --fault altered|half] [--out FILE]

For each seed, one run of the cell (a short window) and its check; with
``--control`` the control in the program's place (the reference with its
products in fp8: each traffic driver's ``control``); with ``--int8`` the run on the
program's own int8 path (``program.int8_path``: the cell still states bf16, so
its precision checks hold); with ``--fault`` the run
with that fault planted underneath (``harness/faults.py``).  Prints one JSON line a
seed (``seed``, ``checks``, ``metrics``) and appends it to ``--out``.  On
the card only: the benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--fault")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark.harness import cell, faults, manifest, program

    wl = manifest.workload(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        if args.control:
            run = cell.Run(wl, manifest.config(wl["config"]), seed, torch.device(args.device),
                           program.DTYPES[wl["dtype"]], False)
            checks = manifest.driver(wl["driver"]).control(run)
            line = {"checks": {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}}
        else:
            plant = faults.planted(wl["driver"], args.fault) if args.fault else contextlib.nullcontext()
            with plant, program.int8_path() if args.int8 else contextlib.nullcontext():
                line = cell.run(args.workload, seed, args.seconds, False, device=args.device)
        line = {"workload": args.workload, "seed": seed, "control": args.control, "int8": args.int8, "fault": args.fault,
                "seconds": time.perf_counter() - t, **line}
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
