"""Run one cell of the benchmark once, on the card this process is given.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``, with
``--trace 1`` a ``breakdown``, and last ``checks``: each number compared with
the reference beside its limit, which also close standard error.  Exits 0
when the run is correct; 1 when it is not (the line is still printed); 2,
printing no result, without enough CUDA cards or when a JAX module is loaded
once the window has closed.

Build and kernel caches stay inside the checkout (``build/``), at fixed
paths, so only a checkout's first run builds.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "ucod_dpl_tpu")


def loaded_forbidden():
    """Loaded modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it (a card set below
    700 W runs slower under load)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = ROOT / "build" / "benchmark_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(cache / sub)
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark.harness import cell, manifest

    chips = int(manifest.workload(args.workload).get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: cell {args.workload} needs {chips} CUDA card(s); this machine has {n}", file=sys.stderr)
        return 2
    result = cell.run(args.workload, args.seed, args.seconds, bool(args.trace), device="cuda", t_start=T_START)
    leaked = loaded_forbidden()
    if leaked:
        print(f"benchmark: JAX modules loaded in the measured process: {', '.join(leaked)}", file=sys.stderr)
        return 2
    result["device"]["power_limit"] = power_limit()
    checks = result.pop("checks")
    result["checks"] = checks  # the last key of the line
    if "error" in result:
        print(result["error"], file=sys.stderr)
    print(f"device: {result['device']['kind']}, {result['device']['power_limit']}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0 if result["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
