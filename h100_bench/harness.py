"""The benchmark's generic part: one run of one cell.

A run
  1. reads `BENCHMARK.json`, finds the cell (`--workload`), its configuration
     file and its traffic file `h100_bench/traffic/<traffic>.json`, whose
     `driver` names `h100_bench/drivers/<driver>.py`;
  2. refuses to run without as many CUDA devices as the cell asks for;
  3. lets the driver load the program and warm the cell's shapes (set-up);
  4. issues whole requests, one after another, until `--seconds` have passed
     and finishes the one in flight (the window); with `--trace 1` under
     `torch.profiler` (host and device), else under a device-only profiler
     where an end-to-end metric of the cell reads the device (or where the
     traffic's `trace_host` is false: its work runs on threads the
     profiler's host side does not see);
  5. frees the program's state and lets the driver compare what the window
     produced with the plain reference (`correct`);
  6. computes the cell's metrics, each by its own reader
     `h100_bench/metrics/<name>.py` (`read(run)` returns a number or None),
     the end-to-end ones with `--trace 0`, the per-layer ones with
     `--trace 1`, and prints one JSON line last on standard output.

A driver module defines `Driver(ctx)` with `setup()`, `request(index)` →
a record (a dict with at least `attempted` and `failed`), `release()` and
`check(records)` → a list of `Check`.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "etude_tpu")


@dataclasses.dataclass
class Check:
    """One number compared with its limit: `ok` when it is finite and at
    most the limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value is not None and math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell, its configuration and traffic, the seed,
    the device, and where the checkout is."""
    root: Path
    workload: dict
    config: dict
    traffic: dict
    seed: int
    device: object


@dataclasses.dataclass
class Run:
    """What a metric reader gets."""
    ctx: Context
    driver: object
    records: List[dict]
    window_s: float
    setup_s: float
    traced: Optional[object]          # trace.Trace of the profiled requests
    traced_records: List[dict]
    memory_peak_bytes: int


def load_module(path: Path, name: str):
    """Import a file by path (names may hold dots, as metric names do)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json", encoding="utf-8") as f:
        return json.load(f)


def cell_entries(manifest: dict, workload: str):
    """(workload entry, configuration, traffic) of a cell, found by name."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    config_entry = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    with open(ROOT / config_entry["file"], encoding="utf-8") as f:
        config = json.load(f)
    with open(BENCH_DIR / "traffic" / f"{cell['traffic']}.json", encoding="utf-8") as f:
        traffic = json.load(f)
    return cell, config, traffic


def end_to_end_metrics(manifest: dict, workload: str) -> List[dict]:
    return [m for m in manifest["end_to_end"]
            if "workloads" not in m or workload in m["workloads"]]


def per_layer_metrics(manifest: dict, workload: str) -> List[dict]:
    reported = {m["name"] for m in end_to_end_metrics(manifest, workload)}
    chosen = []
    for m in manifest["per_layer"]:
        if "workloads" in m:
            if workload in m["workloads"]:
                chosen.append(m)
        elif m["moves"] in reported:
            chosen.append(m)
    return chosen


def process_age_s() -> Optional[float]:
    """Seconds since this process started, from the kernel's record of its
    start (10 ms ticks); None where /proc is not there."""
    try:
        with open("/proc/self/stat", encoding="ascii") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime", encoding="ascii") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_loaded() -> List[str]:
    """Modules of JAX or of the JAX package loaded in this process, compared
    by whole top-level name (`etude_tpu_torch` is not `etude_tpu`)."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN_MODULES})


def device_info(torch, chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}


def _power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"
    return out.replace("\n", "; ")


def synchronize(device) -> None:
    """Wait for the device's work (nothing to wait for on the CPU, where the
    tests drive a run)."""
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


_T0 = time.perf_counter()


def note(message: str) -> None:
    print(f"note: [{time.perf_counter() - _T0:.1f} s] {message}", file=sys.stderr, flush=True)


def run_window(driver, seconds: float, profile_mode: str, trace_requests: Optional[int]):
    """Issue requests until `seconds` have passed, finishing the one in
    flight. `profile_mode`: "none", "device" (CUDA activity only) or "full"
    (host and device); the profiler covers the first `trace_requests`
    requests (all when None), and the pause to stop it between two requests
    is left out of the window. Returns (records, window_s, trace or None,
    traced records)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from h100_bench.trace import Trace

    prof = stopped = None
    if profile_mode != "none":
        activities = [ProfilerActivity.CUDA]
        if profile_mode == "full":
            activities.insert(0, ProfilerActivity.CPU)
        prof = profile(activities=activities)
        prof.__enter__()
    records: List[dict] = []
    n_traced = 0
    paused = 0.0
    t0 = time.perf_counter()
    try:
        while not records or time.perf_counter() - t0 - paused < seconds:
            record = driver.request(len(records))
            record["t_end"] = time.perf_counter() - t0 - paused
            records.append(record)
            note(f"request {len(records) - 1}: {record['seconds']:.3f} s, "
                 f"{record.get('summary', '')}")
            if prof is not None and len(records) == trace_requests:
                t_pause = time.perf_counter()
                torch.cuda.synchronize()
                prof.__exit__(None, None, None)
                stopped, prof, n_traced = prof, None, len(records)
                paused += time.perf_counter() - t_pause
        window_s = time.perf_counter() - t0 - paused
    finally:
        if prof is not None:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            stopped, n_traced = prof, len(records)
    if stopped is not None:
        note("profiler stopped; reading its trace")
    traced = (Trace.of(stopped, getattr(driver, "spans", ()))
              if stopped is not None else None)
    if traced is not None:
        linked = float((traced.launchers() >= 0).mean()) if traced.dev_name else 0.0
        note(f"trace: {len(traced.dev_name)} device operations, {len(traced.host_name)} "
             f"host events, {100 * linked:.1f}% of device operations linked to their launch")
    return records, window_s, traced, records[:n_traced]


def main(argv: List[str], t_start: float) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    manifest = load_manifest()
    cell, config, traffic = cell_entries(manifest, args.workload)
    age = process_age_s()
    wall_at_age = time.time()

    import torch

    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"error: the cell needs {chips} CUDA device(s), found {found}; "
              "the benchmark does not run on the CPU", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    note(f"card: {_power_limit()}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    ctx = Context(root=ROOT, workload=cell, config=config, traffic=traffic, seed=args.seed,
                  device=device)
    driver = load_module(BENCH_DIR / "drivers" / f"{traffic['driver']}.py",
                         f"h100_bench_driver_{traffic['driver']}").Driver(ctx)
    driver.setup()
    torch.cuda.synchronize()
    start = (wall_at_age - age) if age is not None else t_start
    setup_s = time.time() - start
    note(f"set-up {setup_s:.3f} s")

    e2e = end_to_end_metrics(manifest, args.workload)
    if args.trace:
        mode = "full" if traffic.get("trace_host", True) else "device"
    elif any(m["source"] == "device_trace" for m in e2e):
        mode = "device"
    else:
        mode = "none"
    trace_requests = traffic.get("trace_requests") if args.trace else None
    records, window_s, traced, traced_records = run_window(
        driver, args.seconds, mode, trace_requests)
    memory_peak = device_info(torch, chips)
    note(f"window {window_s:.3f} s, {len(records)} requests")

    run = Run(ctx=ctx, driver=driver, records=records, window_s=window_s,
              setup_s=setup_s, traced=traced, traced_records=traced_records,
              memory_peak_bytes=memory_peak["memory_peak_bytes"])
    wanted = per_layer_metrics(manifest, args.workload) if args.trace else e2e
    metrics: Dict[str, dict] = {}
    for spec in wanted:
        reader = load_module(BENCH_DIR / "metrics" / f"{spec['name']}.py",
                             f"h100_bench_metric_{spec['name'].replace('.', '_')}")
        value = reader.read(run)
        if value is not None:
            metrics[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    result = {
        "correct": False,
        "attempted": sum(r["attempted"] for r in records),
        "failed": sum(r["failed"] for r in records),
        "metrics": metrics,
        "device": memory_peak,
    }
    if args.trace:
        result["device"]["busy_s"] = traced.busy_s()
        result["device"]["window_s"] = traced_records[-1]["t_end"]
        result["breakdown"] = traced.breakdown()

    driver.release()
    torch.cuda.empty_cache()
    checks = driver.check(records)
    loaded = forbidden_loaded()
    if loaded:
        print(f"error: modules of JAX or the JAX package are loaded: {loaded}",
              file=sys.stderr)
        return 4
    result["correct"] = result["failed"] == 0 and bool(checks) and all(
        c.ok for c in checks)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    print(f"correct: {result['correct']} ({result['failed']} of "
          f"{result['attempted']} failed)", file=sys.stderr)
    for c in checks:
        print(f"check {c.name}: {c.value!r} (limit <= {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
