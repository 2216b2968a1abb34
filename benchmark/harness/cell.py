"""One run of one cell: set-up, the measured window, the traced reduction,
the check against the reference, and the result line's fields.

A driver (``drivers/<name>.py``) defines ``Driver(run)``, which builds the
program from the seed and warms every shape the cell uses, and has
``images_per_call``, ``E2E`` (the end-to-end metrics it reports beyond
``setup_s``), ``call(i)``, ``keep(i, out)``, ``sync()``, ``end_to_end(window_s,
calls, latencies)``, ``release()`` (frees the program's state) and
``check()`` (name -> (value, limit), every number compared).

Where the cell states no quantized path (``quantize`` null), the run is also
held to the precision it states: no launch of the port's int8 kernels in the
window, and no int8 or fp8 tensor among what the program holds after set-up
(``program.precision_checks``).
"""

from __future__ import annotations

import contextlib
import gc
import time
import traceback
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from benchmark.harness import manifest, program, trace as tr


@dataclass
class Run:
    workload: Dict[str, Any]
    config: Dict[str, Any]
    seed: int
    device: torch.device
    dtype: torch.dtype
    trace: bool
    # filled by the window: what the per-layer metrics read
    images: int = 0
    window_s: float = 0.0
    busy_s: float = 0.0

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def device_info(device: torch.device, chips: int) -> Dict[str, Any]:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run(name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda", t_start: Optional[float] = None,
        overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Run cell ``name`` once -> the result line's fields (``checks`` last).
    ``overrides`` replace keys of the cell's workload file (tests run the
    same code at small sizes)."""
    t_start = time.perf_counter() if t_start is None else t_start
    wl = {**manifest.workload(name), **(overrides or {})}
    cfg = wl["config"] if isinstance(wl["config"], dict) else manifest.config(wl["config"])
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ctx = Run(wl, cfg, int(seed), dev, program.DTYPES[wl["dtype"]], bool(trace))
    drv = manifest.driver(wl["driver"]).Driver(ctx)
    ctx.sync()
    setup_s = time.perf_counter() - t_start
    held = None if wl.get("quantize") else program.low_precision_elements(drv)

    bench = manifest.manifest()
    readers, specs = [], {}
    if trace:
        specs.update(getattr(drv, "SPANS", {}))
        for m in manifest.per_layer_metrics(name, bench):
            mod = manifest.metric(m["name"])
            readers.append((m, mod))
            specs.update(getattr(mod, "SPANS", {}))

    latencies: List[float] = []
    failed, first_error = 0, None
    prof = tr.profiler() if trace else None
    int8_before = program.int8_launches()
    if prof is not None:
        prof.start()
    try:
        with tr.installed(specs) if trace else contextlib.nullcontext():
            with tr.span("window") if trace else contextlib.nullcontext():
                t0 = time.perf_counter()
                i = 0
                while time.perf_counter() - t0 < seconds:
                    t = time.perf_counter()
                    try:
                        with tr.span("call") if trace else contextlib.nullcontext():
                            out = drv.call(i)
                    except Exception:  # an answer that never comes: counted, and the run is not correct
                        failed += 1
                        first_error = first_error or traceback.format_exc()
                        out = None
                    latencies.append(time.perf_counter() - t)
                    drv.keep(i, out)
                    i += 1
                drv.sync()
                window_s = time.perf_counter() - t0
    finally:
        if prof is not None:
            prof.stop()
    int8_window = program.int8_launches() - int8_before  # read with the spans' wrappers restored
    ctx.images, ctx.window_s = i * drv.images_per_call, window_s

    result: Dict[str, Any] = {"correct": False, "attempted": i, "failed": failed}
    device = device_info(dev, int(wl.get("chips", 1)))
    if trace:
        t = tr.reduce(prof)
        del prof
        ctx.window_s, ctx.busy_s = t.window_s, t.busy_s
        metrics = {}
        for m, mod in readers:
            value = mod.read(t, ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        device.update(busy_s=t.busy_s, window_s=t.window_s)
        result["breakdown"] = t.breakdown()
        result["trace"] = {"device_ops": len(t.ops), "unplaced": t.unplaced,
                           "spans": {m["name"]: len(t.under(s)) for m, mod in readers for s in getattr(mod, "SPANS", {})}}
    else:
        wanted = {m["name"] for m in manifest.end_to_end_metrics(name, bench)}
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        for k, (v, unit) in drv.end_to_end(window_s, i, latencies).items():
            if k in wanted:  # the cell's own end-to-end metrics
                metrics[k] = {"value": v, "unit": unit}
    result["metrics"] = metrics
    result["device"] = device

    drv.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = drv.check()
    if held is not None:
        checks.update(program.precision_checks(int8_window, held))
    result["correct"] = failed == 0 and all(v <= lim for v, lim in checks.values())
    if first_error:
        result["error"] = first_error[-2000:]
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result
