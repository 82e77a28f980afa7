"""One run of one cell: set-up, the measured window, the traced stretch, the
check against the reference, the metrics.  `run.py` parses the command line
and calls `run_cell`; the tests call it on the CPU at small sizes.

A cell is found by name: `workloads/<cell>.json` names its configuration
(`configs/<config>.json`) and its traffic (`traffic/<traffic>.json`), whose
`kind` names the module `kinds/<kind>.py` that drives the entry.  The
metrics a run reports come from BENCHMARK.json, and each is read by
`metrics/<name>.py`."""
from __future__ import annotations

import gc
import importlib.util
import json
import pathlib
import statistics
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent.parent      # portbench/
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "aspire_tpu"}


def load_json(*parts) -> dict:
    with open(HERE.joinpath(*parts)) as f:
        return json.load(f)


def load_module(folder: str, name: str):
    """portbench/<folder>/<name>.py, loaded by its path (a metric's name may
    hold dots)."""
    path = HERE / folder / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {folder} module named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"portbench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(cell: str) -> dict:
    """The workload file with its configuration and traffic resolved."""
    spec = load_json("workloads", f"{cell}.json")
    spec["name"] = cell
    spec["config_spec"] = load_json("configs", f"{spec['config']}.json")
    spec["traffic_spec"] = load_json("traffic", f"{spec['traffic']}.json")
    return spec


def metric_names(cell: str, bench: dict, trace: bool) -> list:
    """The end-to-end metrics (trace off) or per-layer ones (trace on) that
    BENCHMARK.json gives this cell."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def forbidden_modules(names=None) -> list:
    """Top-level names of loaded modules (or of `names`) that are JAX's or
    the JAX package's, compared whole: aspire_tpu_torch is not aspire_tpu."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & FORBIDDEN)


class Run:
    """What a run measured, handed to the metrics' readers."""

    def __init__(self):
        self.setup_s = None
        self.starts, self.ends, self.items = [], [], []
        self.latencies = []          # seconds, one an item
        self.failed = 0
        self.spans: dict = {}        # name -> [ms a call]
        self.trace = None            # lib.trace.Trace of the profiled stretch
        self.work: list = []         # the profiled calls' work (lib.work)

    @property
    def window_s(self) -> float:
        return self.ends[-1] - self.starts[0]

    @property
    def attempted(self) -> int:
        return int(sum(self.items))

    def percentile_ms(self, p: float) -> float:
        lat = sorted(self.latencies)
        if len(lat) < 2:
            return 1e3 * lat[0]
        return 1e3 * statistics.quantiles(lat, n=100, method="inclusive")[int(p) - 1]


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, overrides: dict | None = None,
             bench: dict | None = None, faults=None) -> dict:
    """One run; returns the result object that run.py prints.

    overrides: {"config": {...}, "traffic": {...}} merged over the files'
    values (the tests' small sizes).  faults: a callable given the kind's
    state after set-up, which may break the timed path (the tests)."""
    import torch
    from . import trace as tracing

    spec = cell_spec(cell)
    overrides = overrides or {}
    cfg = {**spec["config_spec"], **overrides.get("config", {})}
    traffic = {**spec["traffic_spec"], **overrides.get("traffic", {})}
    limits = spec["limits"]
    bench = bench if bench is not None else json.loads((ROOT / "BENCHMARK.json").read_text())
    kind = load_module("kinds", traffic["kind"])
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    t_setup = time.perf_counter()
    state = kind.setup(cfg, traffic, seed, device)
    if faults is not None:
        faults(state)
    run = Run()
    gc.collect()
    gc.freeze()        # set-up's objects out of the collector's way
    run.setup_s = time.perf_counter() - t_start
    print(f"setup: {t_setup - t_start:.3f} s to the kind's set-up, "
          f"{run.setup_s - (t_setup - t_start):.3f} s in it "
          f"({', '.join(f'{k} {v:.3f} s' for k, v in state.setup_phases.items())})",
          file=sys.stderr)

    # the window: calls back to back, each ending with its results on the host
    i, t_end = 0, time.perf_counter() + seconds
    if trace:
        n_prof = traffic["trace_calls"]
        if on_card:
            run.trace = tracing.profile_calls(lambda j: _timed(state, j, run), 0, n_prof)
        else:
            for j in range(n_prof):
                _timed(state, j, run)
        i = n_prof
        state.spans.enabled = True
    while True:
        _timed(state, i, run)
        i += 1
        if run.ends[-1] >= t_end:
            break
    if on_card:
        torch.cuda.synchronize(device)
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    run.spans = state.spans.read()
    if trace:
        run.work = [state.work(j) for j in range(traffic["trace_calls"])]
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or of the JAX package are loaded: {found}")

    state.free_program()
    numbers = state.check(lower=False)
    checks = {name: {"value": value, "limit": limits[name]}
              for name, value in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    for m in metric_names(cell, bench, trace):
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    out = {"correct": bool(correct), "attempted": run.attempted,
           "failed": int(run.failed), "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.top_ops(),
                            "idle_gaps": run.trace.top_gaps()}
    out["checks"] = checks
    gc.unfreeze()
    return out


def _timed(state, i: int, run: Run) -> None:
    t0 = time.perf_counter()
    items = state.step(i)
    t1 = time.perf_counter()
    run.starts.append(t0)
    run.ends.append(t1)
    run.items.append(items)
    run.latencies.extend([t1 - t0] * items)
    run.failed += state.failed(i)
