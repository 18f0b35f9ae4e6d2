"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with an NVIDIA GPU. The cell
(BENCHMARK.json's `workloads`) names its configuration file and its traffic
mix (benchmark/traffic/<mix>.json, whose `driver` is the module of
benchmark/drivers that runs it); its check settings and limits are benchmark/checks/<cell>.json
and each per-layer metric's reader is benchmark/metrics/<metric>.py.

A run sets up (loads the package, builds its kernels on a checkout's first
run, makes the scene and the seeded inputs, warms up the cell's own
shapes), measures units of work back to back for --seconds (the clock
stops at the end of the last unit that completes), reads the peak memory,
with --trace 1 takes the per-layer metrics, then checks what the timed
path produced against the plain reference. The last lines on standard
error give each number compared beside its limit; the last line on
standard output is the result as JSON. Without a GPU it exits 2 and prints
no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from .common import BENCH, ROOT, cell_files, forbidden_modules  # noqa: E402


def _environment() -> None:
    """Keep every kernel cache inside the checkout, at fixed paths, and the
    host's side to one thread: the card's work is launched by one thread,
    and idle worker threads only contend with it for the host's cores."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build"
                                             / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")


def reader(metric: str):
    """The `read(job)` of benchmark/metrics/<metric>.py."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, workload: str, reported: set) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric["moves"] in reported


def execute(workload: str, seed: int, seconds: float, trace: bool,
            device="cuda", manifest=None, files=None, t0: float = T0):
    """Run the cell; returns (result, checks). `manifest` / `files` (cell,
    configuration, traffic, checks) replace the checkout's files, for the
    benchmark's own tests."""
    import torch

    from .common import load_manifest, sync
    man = manifest or load_manifest()
    cell, conf, traffic, checks = files or cell_files(man, workload)
    drv = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    job = drv.Job(conf, traffic, checks, seed, dev)
    job.setup()
    sync(dev)
    w0 = time.perf_counter()
    setup_s = w0 - t0
    work = units = 0
    walls, last = [], w0
    while True:
        work += job.unit()
        units += 1
        sync(dev)
        now = time.perf_counter()
        walls.append(now - last)
        last = now
        if now - w0 >= seconds:
            break
    window_s = now - w0
    steps = work // conf["particles"]
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    job.window = (work, steps, window_s)

    e2e = [m for m in man["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    reported = {m["name"] for m in e2e}
    rate = work / window_s
    values = {"setup_s": setup_s, "peak_gib": peak / 2 ** 30}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda
                   else "cpu", "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        metrics = {}
        with torch.no_grad():
            for m in man["per_layer"]:
                if _applies(m, workload, reported):
                    v = reader(m["name"])(job)
                    if v is not None:
                        metrics[m["name"]] = {"value": float(v),
                                              "unit": m["unit"]}
        t = job.traced()
        if t is not None:
            print(f"traced: {t['steps']} steps, unprofiled walls "
                  f"{t['walls']} s, profiled busy {t['busy_s']:.6f} s "
                  f"of {t['window_s']:.6f} s, {t['count']} device "
                  "operations", file=sys.stderr)
            device_info.update(busy_s=t["busy_s"], window_s=t["window_s"])
            breakdown = {"device_ops": t["ops"], "idle_gaps": t["idle_gaps"]}
    else:
        metrics = {}
        for m in e2e:
            v = rate if m["unit"] == "particle-steps/s" else values.get(
                m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    print(f"window: {units} units, {steps} steps, {window_s:.3f} s; set-up "
          f"{setup_s:.3f} s; unit walls {[round(w, 4) for w in walls]}",
          file=sys.stderr)
    c0 = time.perf_counter()
    checks = job.check()
    print(f"check: {time.perf_counter() - c0:.3f} s", file=sys.stderr)
    correct = all(v <= lim for _, v, lim in checks)
    result = {"correct": correct, "attempted": units, "failed": 0,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checked"] = {name: {"value": v, "limit": lim}
                         for name, v, lim in checks}
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    _environment()
    import torch
    torch.set_num_threads(1)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in manifest["workloads"]}.get(a.workload)
    if cell is None:
        print(f"unknown workload {a.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"the benchmark measures an NVIDIA GPU: torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" CUDA device(s), the cell asks for {cell['chips']}",
              file=sys.stderr)
        return 2
    result, checks = execute(a.workload, a.seed, a.seconds, bool(a.trace),
                             manifest=manifest)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark measures the PyTorch "
              "port alone", file=sys.stderr)
        return 3
    for name, v, lim in checks:
        print(f"check {name}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
