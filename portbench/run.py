"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (`chatterbox_embed_tpu_torch`)
and `BENCHMARK.json`. The cell is `portbench/workloads/<cell>.json`; it
names its configuration (`portbench/configs/<name>.json`) and its driver
(`portbench/drivers/<driver>.py`), which builds the system from the seed,
warms it, serves the cell's traffic for the window and hands back what it
served. With --trace 0 the line carries the cell's end-to-end metrics;
with --trace 1 its per-layer metrics, each read by `portbench/metrics/
<metric>.py` from a window under the profiler and the benchmark's
wrappers. Every run judges what it served against the plain reference
(`portbench/reference`); `correct` says whether each number stayed under
its limit.

Exit codes: 0 a result was printed (correct or not); 2 no card, or fewer
than the cell asks for; 3 JAX or the JAX package was loaded; 1 anything
else.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "chatterbox_embed_tpu")
CACHE = HERE / "_cache"
THREADS = 2              # host threads of a run: load from one process, few threads


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name only begins with the package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def manifest_entries(manifest: dict, cell: str):
    """The cell's manifest entry, and its end-to-end and per-layer metrics
    (a metric without `workloads` belongs to every cell)."""
    entry = next((w for w in manifest["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise SystemExit(f"BENCHMARK.json has no workload {cell!r}")
    mine = lambda m: cell in m.get("workloads", [cell])
    return (entry, [m for m in manifest["end_to_end"] if mine(m)],
            [m for m in manifest["per_layer"] if mine(m)])


def metric_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Ctx:
    """What a driver gets: the cell, its configuration, the run's settings
    and the window's bookkeeping."""

    def __init__(self, name, cell, cfg, seed, seconds, trace, device):
        import torch

        from portbench.lib.trace import Profile
        self.name, self.cell, self.cfg = name, cell, cfg
        self.seed, self.trace = int(seed), bool(trace)
        self.seconds = float(seconds)
        self.device = torch.device(device)
        self.profile = Profile(self.trace and self.device.type == "cuda")
        self.trace_data = None
        self.profile_stop_s = 0.0
        self.setup_s = None
        self.memory_peak = 0

    def _sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def reset_peak(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def open_window(self, patches, snapshot=dict) -> float:
        """Start the window (and, in a traced run, the profiler over its
        first `profile_seconds`). snapshot() gives the driver's counters;
        `mark` holds them, the wrappers' seconds and the time at which the
        profiler stopped: the host-clock metrics of a traced run are read
        between the mark and the window's end, where no profiler runs."""
        self._sync()
        self._patches, self._snapshot = patches, snapshot
        self.profile.start()
        patches.recording = self.trace
        self.setup_s = time.time() - T_START
        self.t0 = time.perf_counter()
        self.mark = None
        if not self.profile.enabled:
            self._mark()
        return self.t0

    def _mark(self):
        self.mark = SimpleNamespace(t=time.perf_counter(), counters=dict(self._snapshot()),
                                    seconds=dict(self._patches.seconds))

    def tick(self, ready: bool = True):
        """Called by the driver between its steps: ends the profiled part
        once it has lasted `profile_seconds` and holds what the cell's
        metrics read (`ready`, the driver's say)."""
        if (self.mark is None and ready
                and time.perf_counter() >= self.t0 + self.cell["profile_seconds"]):
            self._patches.recording = False
            t = time.perf_counter()
            self.profile.stop()
            self.profile_stop_s = time.perf_counter() - t
            self._mark()

    def close_window(self, patches):
        if self.mark is None:
            patches.recording = False
            self.profile.stop()
            self._mark()
        self.t_end = time.perf_counter()
        self.trace_data = self.profile.read_trace()

    def layer_inputs(self, counters: dict, patches) -> dict:
        """What the metric readers get: the part of the window after the
        mark, its length, the counters' and the wrappers' growth over it."""
        m = self.mark
        return dict(window_s=max(self.t_end - m.t, 1e-9), patches=patches,
                    counters={k: v - m.counters.get(k, 0) for k, v in counters.items()},
                    seconds={k: v - m.seconds.get(k, 0.0) for k, v in patches.seconds.items()})

    def read_memory(self):
        import torch
        self._sync()
        if self.device.type == "cuda":
            self.memory_peak = int(torch.cuda.max_memory_allocated(self.device))

    def judge(self, numbers_of):
        return numbers_of("fp32")


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda", cell=None,
             cfg=None, manifest=None) -> tuple:
    """Run the cell once. Returns (result dict, the lines of numbers and
    limits). cell / cfg / manifest default to the files of that name."""
    import torch

    from portbench.lib import check, model, trace as tracing
    cell = cell or load_json(HERE / "workloads" / f"{name}.json")
    cfg = cfg or model.load_config(cell["config"])
    manifest = manifest or load_json(ROOT / "BENCHMARK.json")
    entry, e2e, layer = manifest_entries(manifest, name)
    torch.set_num_threads(THREADS)
    driver = importlib.import_module(f"portbench.drivers.{cell['driver']}")
    ctx = Ctx(name, cell, cfg, seed, seconds, trace, device)
    res = driver.run(ctx)
    gc.collect()
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    metrics = {}
    if not trace:
        values = dict(res["e2e"], setup_s=ctx.setup_s)
        for m in e2e:
            v = values[m["name"]]
            metrics[m["name"]] = {"value": v if math.isfinite(v) else 1e30, "unit": m["unit"]}
    else:
        run = SimpleNamespace(cell=cell, cfg=cfg, trace=ctx.trace_data or {},
                              **res["layer"])
        for m in layer:
            v = metric_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    correct, rows = check.verdict(res["numbers"], cell["check"]["limits"])
    dev = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
           "kind": (torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda"
                    else "cpu"),
           "count": int(entry["chips"]), "memory_peak_bytes": ctx.memory_peak}
    out = {"correct": bool(correct), "attempted": int(res["attempted"]),
           "failed": int(res["failed"]), "metrics": metrics, "device": dev}
    if trace and ctx.trace_data:
        dev["busy_s"] = ctx.trace_data["busy_s"]
        dev["window_s"] = ctx.trace_data["window_s"]
        out["breakdown"] = tracing.breakdown(ctx.trace_data)
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    if trace:
        res["log"].append(f"profiled {ctx.mark.t - ctx.t0:.3f} s (stopping took "
                          f"{ctx.profile_stop_s:.3f} s), then {ctx.t_end - ctx.mark.t:.3f} s "
                          "without the profiler")
    lines = res["log"] + [f"check {k} {v!r} limit {lim!r}" for k, v, lim in rows]
    return out, lines


class ForbiddenModules(RuntimeError):
    pass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    found = forbidden_modules()
    if found:
        print(f"refusing to start: {found} loaded", file=sys.stderr)
        return 3
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_ext")):
        os.environ[var] = str(CACHE / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(THREADS)
    sys.path.insert(0, str(ROOT))
    import torch
    manifest = load_json(ROOT / "BENCHMARK.json")
    entry, _, _ = manifest_entries(manifest, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        print(f"needs {entry['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present",
              file=sys.stderr)
        return 2
    try:
        out, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              manifest=manifest)
    except ForbiddenModules as e:
        print(f"after the window, modules of JAX or the JAX package are loaded: {e}",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
