"""One run of one cell: set-up, the measured window, the check, the result.

A cell of ``BENCHMARK.json`` is resolved by name alone (:func:`load_cell`):
its configuration file, ``traffic/<traffic>.json``, the driver that file
names in ``drivers/<driver>.py``, and for each of the cell's metrics the
reader ``metrics/<metric>.py``. A later cell, configuration, traffic mix or
metric is files and entries; no file here changes.

A driver module defines ``Driver(run)``, whose ``setup()`` makes the inputs
from the seed and the program's standing state and warms up, ``serve(client)``
drives requests through :meth:`Client.request` in a closed loop with one
caller until the window closes, ``after_window()`` frees the program's
state, and ``check()`` returns the numbers compared with the plain
reference, each with its limit. ``hooks(spans)`` wraps, in a traced run
only, the calls into the program's layers that the per-layer metrics read.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "pbwt_tpu")


class WindowClosed(Exception):
    """Raised by :meth:`Client.request` once the window's time is spent."""


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """The module in file ``path``, loaded under ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


@dataclass
class Cell:
    name: str
    home: str                       # the benchmark's folder it was found in
    entry: dict
    config: dict
    traffic: dict
    driver: object                  # the driver's module
    end_to_end: list
    per_layer: list


def load_cell(name: str, base: str = ROOT) -> Cell:
    """The cell ``name`` of ``base``/BENCHMARK.json, every file found by name
    under ``base``: its configuration where the entry says, its traffic,
    driver and metric readers in ``base``/benchmark/."""
    spec = load_json(os.path.join(base, "BENCHMARK.json"))
    home = os.path.join(base, "benchmark")
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    config = load_json(os.path.join(base, conf["file"]))
    traffic = load_json(os.path.join(home, "traffic", f"{entry['traffic']}.json"))
    driver = load_module(os.path.join(home, "drivers", f"{traffic['driver']}.py"),
                         f"benchmark_driver_{traffic['driver']}")
    return Cell(name, home, entry, config, traffic, driver,
                [m for m in spec["end_to_end"] if _applies(m, name)],
                [m for m in spec["per_layer"] if _applies(m, name)])


def metric_reader(cell: Cell, metric: str):
    return load_module(os.path.join(cell.home, "metrics", f"{metric}.py"),
                       "benchmark_metric_" + metric.replace(".", "_"))


@dataclass
class Check:
    """A number compared with the plain reference, and its limit: the run
    is correct only where value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclass
class Request:
    start: float
    end: float
    work: dict


class Client:
    """One caller in a closed loop. :meth:`request` times fn() on the host
    clock, from its call to its return (every driver's fn returns with its
    result on the host), and raises WindowClosed after the request that
    ends at or past the window's length. The window runs from the first
    request's call to the last one's return."""

    def __init__(self, seconds: float, traced: bool):
        self.seconds = seconds
        self.traced = traced
        self.requests: list[Request] = []
        self.start: float | None = None

    def request(self, fn, on_result=None, **work):
        if self.start is None:
            self.start = time.perf_counter()
        t0 = time.perf_counter()
        if self.traced:
            with torch.profiler.record_function("request"):
                out = fn()
        else:
            out = fn()
        t1 = time.perf_counter()
        self.requests.append(Request(t0, t1, work))
        if on_result is not None:
            on_result(out)
        if t1 - self.start >= self.seconds:
            raise WindowClosed
        return out

    @property
    def window_s(self) -> float:
        return self.requests[-1].end - self.start

    def total(self, key: str) -> float:
        return sum(r.work.get(key, 0) for r in self.requests)


@dataclass
class Spans:
    """Spans and counters of a traced run, recorded from outside the
    program: :meth:`wrap` replaces a module's function by one that times
    each call on the host clock (with a ``record_function`` of the span's
    name, so that the trace names the host's work) and may count from its
    result."""
    durations: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    _undo: list = field(default_factory=list)

    def wrap(self, module, attr: str, name: str, count=None) -> None:
        real = getattr(module, attr)
        spent = self.durations.setdefault(name, [])

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            with torch.profiler.record_function(name):
                out = real(*args, **kwargs)
            spent.append(time.perf_counter() - t0)
            if count is not None:
                count(self.counters, out)
            return out
        setattr(module, attr, timed)
        self._undo.append((module, attr, real))

    def unwrap(self) -> None:
        for module, attr, real in reversed(self._undo):
            setattr(module, attr, real)
        self._undo.clear()


@dataclass
class Run:
    """What a driver is given: the cell, the seed, the device, and the
    spans of a traced run."""
    cell: Cell
    seed: int
    device: torch.device
    spans: Spans | None
    shapes: dict = field(default_factory=dict)   # what the readers need

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic


@dataclass
class Context:
    """What a metric reader is given."""
    run: Run
    client: Client
    setup_s: float
    trace: object | None            # trace.Trace of a traced run


def free_device(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def forbidden_modules(names=None) -> list[str]:
    """Modules loaded in this process (or among ``names``) whose top-level
    name is one of FORBIDDEN, compared whole."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def device_record(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader", "-i", str(device.index)],
                             capture_output=True, text=True, timeout=30)
        limit = smi.stdout.strip() or "not read"
    except (OSError, subprocess.TimeoutExpired):
        limit = "not read"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
            "power_limit": limit}


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device: torch.device, t_start: float, log=print,
             control: bool = False) -> dict:
    """Set-up, window, check; returns the result line's object (checks
    last). ``t_start``: the host clock at the process's start. control:
    also the numbers of the driver's control, put in the program's place,
    under ``control`` (readings.py; the runs of run.py never do)."""
    spans = Spans() if traced else None
    run = Run(cell, seed, device, spans)
    driver = cell.driver.Driver(run)
    driver.setup()
    client = Client(seconds, traced)
    prof = contextlib.nullcontext()
    if traced:
        driver.hooks(spans)
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            *([torch.profiler.ProfilerActivity.CUDA]
              if device.type == "cuda" else [])])
    try:
        with prof:
            try:
                driver.serve(client)
            except WindowClosed:
                pass
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    finally:
        if spans is not None:
            spans.unwrap()
    if not client.requests:
        raise RuntimeError("the window served no request")
    setup_s = client.start - t_start
    secs = sorted(r.end - r.start for r in client.requests)
    log(f"setup_s {setup_s:.3f}, window_s {client.window_s:.3f}, "
        f"requests {len(secs)}, request s min {secs[0]:.4f} median "
        f"{secs[len(secs) // 2]:.4f} max {secs[-1]:.4f}", file=sys.stderr)
    dev_rec = device_record(device)
    trace = None
    if traced:
        from benchmark.trace import Trace
        trace = Trace(prof.events())
        dev_rec.update(busy_s=trace.busy_s, window_s=trace.window_s)
    ctx = Context(run, client, setup_s, trace)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = metric_reader(cell, m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    driver.after_window()
    free_device(device)
    t0 = time.perf_counter()
    checks = driver.check()
    log(f"reference: {time.perf_counter() - t0:.2f} s", file=sys.stderr)
    # a request that raises ends the run with no result: none failed here
    result = {"correct": all(c.ok for c in checks) and bool(checks),
              "attempted": len(client.requests), "failed": 0,
              "metrics": metrics, "device": dev_rec}
    if trace is not None:
        result["breakdown"] = {"device_ops": trace.device_ops,
                               "idle_gaps": trace.idle_gaps}
    if control:
        result["control"] = {c.name: {"value": c.value, "limit": c.limit}
                             for c in driver.control()}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result
