"""One run of one cell: find its parts by name, set up, measure the
window, judge the outputs, read the metrics, assemble the result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; the
harness finds, by those names, ``configs/<config>.json``,
``reference/<config>.py``, ``traffic/<traffic>.json``, the loop of the
traffic's kind ``kinds/<kind>.py``, the configuration's adapter for that
kind ``systems/<config>/<kind>.py``, ``limits/<cell>.json`` and, for each
per-layer metric, ``metrics/<metric>.py``.  Adding a cell, a
configuration, a traffic mix, a kind of traffic or a metric adds files and
entries; it edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from . import tracing

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: top-level module names that no run may hold once its window has closed:
#: the JAX stack, the JAX package, and the JAX-era measurement scripts
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "epgpy_tpu", "bench",
                       "chip_smoke", "tools"})


def forbidden_modules(names=None):
    """The forbidden top-level names among `names` (default: every module
    loaded), compared whole: the part before the first dot."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & FORBIDDEN)


def load_benchmark(root=ROOT):
    with open(Path(root) / "BENCHMARK.json") as fh:
        return json.load(fh)


def _json(*parts):
    with open(HERE.joinpath(*parts)) as fh:
        return json.load(fh)


def _file_module(path, name):
    """A module from a file whose name may hold dots (a metric's name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench, cell, kind):
    """The cell's metrics of `kind` ("end_to_end" or "per_layer"): those
    that list it under "workloads", or list no workloads at all."""
    return [m for m in bench[kind]
            if cell in m.get("workloads", [cell])]


def load_cell(bench, cell):
    """Every part of `cell` found by name; raises KeyError for an unknown
    cell."""
    work = {w["name"]: w for w in bench["workloads"]}[cell]
    conf = work["config"]
    traffic = _json("traffic", f"{work['traffic']}.json")
    kind = traffic["kind"]
    return {
        "cell": work,
        "config": _json("configs", f"{conf}.json"),
        "traffic": traffic,
        "limits": _json("limits", f"{cell}.json"),
        "reference": importlib.import_module(f"perfbench.reference.{conf}"),
        "kind": importlib.import_module(f"perfbench.kinds.{kind}"),
        "system_module": importlib.import_module(
            f"perfbench.systems.{conf}.{kind}"),
        "end_to_end": cell_metrics(bench, cell, "end_to_end"),
        "per_layer": cell_metrics(bench, cell, "per_layer"),
        "readers": {m["name"]: _file_module(HERE / "metrics" /
                                            f"{m['name']}.py",
                                            f"perfbench_metric_{m['name']}")
                    for m in cell_metrics(bench, cell, "per_layer")},
    }


class RunView:
    """What a per-layer reader may read of a finished run."""

    def __init__(self, loop, spans, trace, peaks):
        self.spans = spans
        self.trace = trace
        self.calls = loop.attempted
        self.shapes = loop.shapes
        self.system = loop.system
        self.peaks = peaks

    def counts(self, kernel):
        return importlib.import_module(f"perfbench.counts.{kernel}")


def device_info(device, peak):
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1, "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": int(peak)}


def run_cell(parts, *, seed, seconds, trace, device, t_start,
             system=None, check_paths=True):
    """Run one cell once; returns the result dict (the checks last).

    `system` replaces the program's adapter (the precision control);
    `t_start` is the host clock at process start, from which setup_s
    runs to the first timed call."""
    import epgpy_torch as epg

    device = torch.device(device)
    epg.config.set_device(device)
    epg.config.set_precision(parts["config"]["precision"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    ref = parts["reference"]
    if system is None:
        system = parts["system_module"].System(ref.train(parts["config"]),
                                               device)
    loop_parts = dict(parts, system=system)
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else None
    spans = tracing.Spans(trace, sync)
    loop = parts["kind"].Loop(loop_parts, seed, device, spans,
                              check_paths=check_paths)
    loop.setup()
    setup_s = time.perf_counter() - t_start
    spans.items.clear()          # the per-layer spans cover the window alone
    prof = tracing.Profile(device.type == "cuda") if trace else None
    if prof is not None:
        with prof:
            e2e = loop.window(seconds)
    else:
        e2e = loop.window(seconds)
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    loop.release()
    t_check = time.perf_counter()
    numbers = loop.check(parts["limits"])
    print(f"perfbench: set-up {setup_s:.3f} s, check "
          f"{time.perf_counter() - t_check:.3f} s, peak {peak} B",
          file=sys.stderr)
    dev = device_info(device, peak)
    out = {"correct": False, "attempted": loop.attempted,
           "failed": loop.failed, "metrics": {}, "device": dev}
    if trace:
        tr = prof.reduce() if prof is not None else None
        view = RunView(loop, spans, tr, _json("peaks.json"))
        for m in parts["per_layer"]:
            v = parts["readers"][m["name"]].read(view)
            if v is not None:
                out["metrics"][m["name"]] = {"value": float(v),
                                             "unit": m["unit"]}
        dev["busy_s"] = tr.busy_s if tr is not None else 0.0
        dev["window_s"] = tr.window_s if tr is not None else 0.0
        if tr is not None:
            out["breakdown"] = tr.breakdown()
    else:
        values = dict(e2e, setup_s=setup_s)
        for m in parts["end_to_end"]:
            out["metrics"][m["name"]] = {"value": float(values[m["name"]]),
                                         "unit": m["unit"]}
    limits = parts["limits"]
    within = all(numbers[k] <= limits[k] for k in numbers)
    out["correct"] = bool(loop.failed == 0 and within
                          and loop.attempted > 0)
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                     for k in numbers}
    return out


class ForbiddenImport(RuntimeError):
    def __init__(self, found):
        super().__init__("forbidden modules loaded: " + ", ".join(found))
        self.found = found
