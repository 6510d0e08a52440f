"""The benchmark's core: one run of one cell, driven by data.

``BENCHMARK.json`` names the cell's configuration and traffic; the harness
reads ``configs/<config>.json`` (the sizes, as run), ``traffic/<traffic>.json``
(the entry and its parameters) and ``limits/<cell>.json`` (the limit of
each number that decides ``correct``), imports ``entries/<entry>.py`` and,
with ``--trace 1``, ``metrics/<metric>.py`` for each per-layer metric the
cell lists. A later cell, configuration or metric is new files and new
entries; no file here names one.

An entry's ``setup(ctx)`` builds the system under test from ``--seed`` and
warms up every shape the cell uses; the harness then times ``--seconds``
of its ``unit()`` calls (``--trace 0``) or profiles a bounded number of
them (``--trace 1``), reads the peak memory, and calls ``check()``, which
frees the program's state and compares what the window produced with the
plain reference. See ``README.md`` for the entry's interface.
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import probes

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "dr4sr_tpu")
NAME_CHARS = 160  # a breakdown keeps this much of a kernel's name
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchCooperativeKernel", "cudaGraphLaunch", "cuGraphLaunch")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Phases:
    """Set-up's phases, each logged on standard error with its seconds."""

    def __init__(self) -> None:
        self.t = time.perf_counter()

    def done(self, name: str) -> None:
        now = time.perf_counter()
        log(f"setup phase {name} {now - self.t:.3f} s")
        self.t = now


def boot_seconds() -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME)


def process_start() -> float:
    """This process's start on the CLOCK_BOOTTIME scale (``/proc/self/stat``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Spec:
    """One cell as ``BENCHMARK.json`` and the files it names describe it."""

    workload: dict
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def _reported(metrics: Sequence[dict], cell: str) -> List[dict]:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def load_spec(workload: str, bench_path: str = os.path.join(ROOT, "BENCHMARK.json")) -> Spec:
    bench = load_json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(ROOT, configs[cell["config"]]["file"])
    return Spec(cell, config, load_json(HERE, "traffic", cell["traffic"] + ".json"),
                load_json(HERE, "limits", workload + ".json"),
                _reported(bench["end_to_end"], workload), _reported(bench["per_layer"], workload))


@dataclasses.dataclass
class Context:
    """What an entry's ``setup`` gets: the seed, the device, the sizes and
    the traffic's parameters, and a scratch directory under ``TMPDIR``."""

    seed: int
    device: str
    config: dict
    traffic: dict
    workdir: str


class Trace:
    """A profiled slice of the window, reduced: the device's activity as
    (name, start, end) in µs, its union, the host's launch calls, the
    host's ops, the entry's account of the work the slice did, and the
    kernels that each of the entry's probes launched (``probes.py``)."""

    def __init__(self, prof, window_s: float, work: dict,
                 probed: Optional[Dict[str, frozenset]] = None) -> None:
        import torch

        self.window_s = window_s
        self.work = work
        self.probed = probed or {}
        self.kernels: List[Tuple[str, float, float]] = []
        self.launches = 0
        self.host_ops: List[Tuple[float, float, str]] = []
        for e in prof.events():
            start, end = e.time_range.start, e.time_range.end
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if not getattr(e, "is_user_annotation", False):
                    self.kernels.append((e.name, start, end))
            elif e.name in LAUNCH_CALLS:
                self.launches += 1
            else:
                self.host_ops.append((start, end, e.name))
        self.kernels.sort(key=lambda k: k[1])
        self.host_ops.sort()
        self.busy = _union(self.kernels)
        self.busy_s = sum(b - a for a, b in self.busy) / 1e6

    def probed_kernels(self, probe: str) -> List[Tuple[str, float, float]]:
        """The slice's kernels of the names that ``probe`` launched."""
        names = self.probed.get(probe, frozenset())
        return [k for k in self.kernels if k[0] in names]

    def probed_device_s(self, probe: str) -> float:
        return sum(end - start for _, start, end in self.probed_kernels(probe)) / 1e6

    def breakdown(self) -> dict:
        """The 10 device operations that took most time, and the 10 host ops
        under which the device idled longest (each idle gap goes to the
        innermost host op running at its middle)."""
        ops: Dict[str, float] = {}
        for name, start, end in self.kernels:
            name = name[:NAME_CHARS]
            ops[name] = ops.get(name, 0.0) + (end - start) / 1e6
        gaps: Dict[str, float] = {}
        starts = [s for s, _, _ in self.host_ops]
        for (_, a), (b, _) in zip(self.busy, self.busy[1:]):
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid) - 1
            owner = "host outside any op"
            for j in range(i, max(i - 200, -1), -1):
                if self.host_ops[j][1] >= mid:
                    owner = self.host_ops[j][2][:NAME_CHARS]
                    break
            gaps[owner] = gaps.get(owner, 0.0) + (b - a) / 1e6
        return {"device_ops": _top(ops), "idle_gaps": _top(gaps)}


def _top(seconds: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(seconds.items(), key=lambda kv: -kv[1])[:n]]


def _union(intervals: Sequence[Tuple[str, float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for _, start, end in intervals:
        if out and start <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], end))
        else:
            out.append((start, end))
    return out


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def judge(values: Dict[str, float], limits: Dict[str, float], failed: int = 0):
    """(each number beside its limit, whether every one is within it): the
    expression that decides ``correct``, for the program and its control."""
    checks = {name: {"value": value, "limit": limits.get(name)} for name, value in values.items()}
    return checks, (failed == 0 and bool(checks) and
                    all(c["limit"] is not None and c["value"] <= c["limit"]
                        for c in checks.values()))


def read_per_layer(spec: Spec, trace: Trace) -> Dict[str, float]:
    """Each per-layer metric of the cell, read from ``trace`` by its reader.
    A metric that the cell lists and that reads nothing ends the run: the
    line would lack it."""
    metrics, unread = {}, []
    for m in spec.per_layer:
        reader = load_module(os.path.join(HERE, "metrics", m["name"] + ".py"),
                             "bench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(trace)
        if value is None:
            unread.append(m["name"])
        else:
            metrics[m["name"]] = value
    if unread:
        log(f"{spec.workload['name']} lists {unread}, which read nothing in this trace")
        raise SystemExit(4)
    return metrics


def run_cell(spec: Spec, seed: int, seconds: float, trace: bool, device: str = "cuda",
             start: Optional[float] = None, control: bool = False) -> dict:
    """One run of ``spec``'s cell; returns the result line's object. ``start``
    is the process's start (CLOCK_BOOTTIME seconds) for ``setup_s``. With
    ``control`` the cell's control and faults (``cell.control()``) are
    judged after the program, as it is, under ``controls``; the
    benchmark's own runs never take them."""
    import torch

    start = boot_seconds() if start is None else start
    on_card = device == "cuda"
    if trace and not on_card:
        raise ValueError("a traced run reads the card's trace: it needs the card")
    entry = load_module(os.path.join(HERE, "entries", spec.traffic["entry"] + ".py"),
                         "bench_entry_" + spec.traffic["entry"])
    with tempfile.TemporaryDirectory(prefix="bench_") as workdir:
        cell = entry.setup(Context(seed, device, spec.config, spec.traffic, workdir))
        if on_card:
            torch.cuda.synchronize()
        setup_s = boot_seconds() - start
        probed = probes.kernels(cell.probes()) if trace and hasattr(cell, "probes") else None
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        if trace:
            prof, window_s = _traced(cell)
        else:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                cell.unit()
            if on_card:
                torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
        found = forbidden_modules()
        if found:
            log(f"the run holds {found} in sys.modules once its window has closed")
            raise SystemExit(3)
        result: dict = {"correct": False, "attempted": cell.attempted, "failed": cell.failed}
        device_info = {"platform": "gpu" if on_card else "cpu",
                       "kind": torch.cuda.get_device_name() if on_card else "cpu", "count": 1,
                       "memory_peak_bytes": torch.cuda.max_memory_allocated() if on_card else 0}
        if trace:
            reduced = Trace(prof, window_s, cell.trace_work(), probed)
            del prof
            metrics = read_per_layer(spec, reduced)
            result["breakdown"] = reduced.breakdown()
            device_info.update(busy_s=reduced.busy_s, window_s=window_s)
            units = {m["name"]: m["unit"] for m in spec.per_layer}
        else:
            metrics = {"setup_s": setup_s, **cell.end_to_end(window_s)}
            units = {m["name"]: m["unit"] for m in spec.end_to_end}
        result["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in metrics.items()
                             if k in units}
        result["device"] = device_info
        card = power_limit() if on_card else None
        if card:
            result["card"] = card
        t0 = time.perf_counter()
        checks, result["correct"] = judge(cell.check(), spec.limits, cell.failed)
        log(f"check: the reference took {time.perf_counter() - t0:.3f} s")
        if control:
            result["controls"] = {}
            for name, values in cell.control().items():
                judged, ok = judge(values, spec.limits)
                result["controls"][name] = {"correct": ok, "checks": judged}
        result["checks"] = checks
    return result


def _traced(cell):
    """The entry's ``trace_units()`` units under ``torch.profiler``, each in
    a span named for it; returns (profile, wall seconds of the slice)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(cell.trace_units()):
            with record_function(f"bench.{cell.unit_name}"):
                cell.unit()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    return prof, window_s


def print_result(result: dict) -> None:
    """The checks as the last lines on standard error, then the result as
    the last line of standard output, its ``checks`` key last."""
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    log(f"correct {result['correct']}")
    checks = result.pop("checks")
    result["checks"] = checks
    print(json.dumps(result), flush=True)
