"""The harness without a card: arguments, finding every part by name, the
contract's shape of BENCHMARK.json, and the import check."""

import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import harness, run

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_arguments_parse():
    a = run.parse(["--workload", "mrf_fisp.dict", "--seed", str(2**33 + 1),
                   "--seconds", "40", "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == (
        "mrf_fisp.dict", 2**33 + 1, 40.0, 1)
    assert run.parse(["--workload", "x", "--seed", "3", "--seconds",
                      "1"]).trace == 0
    with pytest.raises(SystemExit):
        run.parse(["--workload", "x", "--seed", "3", "--seconds", "1",
                   "--trace", "2"])


def test_contract_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    assert bench["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    cells = 24
    total = ((2 + 14 * cells) * (bench["run_seconds"] + 60)
             + cells * 2 * 90 + 1200)
    assert total <= 43200
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("perfbench/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == \
            c["reduced"]
        names.add(c["name"])
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in e2e
        for w in m["workloads"]:
            # every cell that reports it reports what it moves
            assert w in e2e[m["moves"]].get("workloads", [w])
    seen = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
        mine = harness.cell_metrics(bench, w["name"], "end_to_end")
        assert "setup_s" in [m["name"] for m in mine] and len(mine) >= 2
        assert harness.cell_metrics(bench, w["name"], "per_layer")
    for m in bench["end_to_end"] + bench["per_layer"] + bench["workloads"] \
            + bench["configs"]:
        assert NAME.match(m["name"]), m["name"]
        if "unit" in m:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                               "higher")
    roof = [m for m in bench["per_layer"] if m["name"].endswith("_roofline")]
    assert roof and all(m["unit"] == "%" for m in roof)
    assert len(json.dumps(bench)) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.load_benchmark()["workloads"]])
def test_every_part_found_by_name(bench, cell):
    parts = harness.load_cell(bench, cell)
    assert parts["config"]["name"] == parts["cell"]["config"]
    assert parts["kind"].__name__ == \
        f"perfbench.kinds.{parts['traffic']['kind']}"
    assert hasattr(parts["kind"], "Loop") and len(parts["kind"].CONTROL) == 2
    assert set(parts["readers"]) == {m["name"] for m in parts["per_layer"]}
    assert all(callable(r.read) for r in parts["readers"].values())
    assert hasattr(parts["system_module"], "System")
    assert callable(parts["reference"].fingerprints)
    assert all(isinstance(v, float) for v in parts["limits"].values())


def test_unknown_cell_raises(bench):
    with pytest.raises(KeyError):
        harness.load_cell(bench, "no_such.cell")


def test_forbidden_names_compared_whole():
    names = ["jax.numpy", "jaxlib", "epgpy_tpu.models", "epgpy_torch",
             "epgpy_torch.models", "benchmark", "bench", "tools.x",
             "chip_smoke_notes", "flax.linen", "jaxtyping"]
    assert harness.forbidden_modules(names) == [
        "bench", "epgpy_tpu", "flax", "jax", "jaxlib", "tools"]
    assert harness.forbidden_modules(["epgpy_torch", "numpy"]) == []


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_nothing_forbidden():
    """No file of the benchmark imports the JAX stack or the JAX-era
    scripts; the references import neither those nor the program."""
    for f in (ROOT / "perfbench").rglob("*.py"):
        mods = list(_imports(f))
        assert not harness.forbidden_modules(mods), f
        if f.parent.name == "reference":
            assert {m.split(".")[0] for m in mods} <= {
                "__future__", "math", "numpy", "torch"}, f


def test_a_run_loads_nothing_forbidden():
    """The run's own process, with the harness, every cell's parts and the
    port imported, holds no forbidden top-level module."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from perfbench import harness, control\n"
            "b = harness.load_benchmark()\n"
            "[harness.load_cell(b, w['name']) for w in b['workloads']]\n"
            "import epgpy_torch, epgpy_torch.parallel, epgpy_torch.models\n"
            "print(harness.forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _run(cwd, *args):
    return subprocess.run([sys.executable, "perfbench/run.py", *args],
                          capture_output=True, text=True, cwd=cwd,
                          timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run(ROOT, "--workload", "mrf_fisp.dict", "--seed", "5",
               "--seconds", "1")
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_unknown_workload_no_result():
    out = _run(ROOT, "--workload", "nope", "--seed", "5", "--seconds", "1")
    assert out.returncode != 0 and out.stdout == ""


def test_bare_benchmark_directory_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    files (no program) gives no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, "--workload", "mrf_fisp.dict", "--seed", "5",
               "--seconds", "1")
    assert out.returncode != 0 and out.stdout == ""


def test_caches_inside_the_checkout(monkeypatch, tmp_path):
    monkeypatch.delenv("TORCH_EXTENSIONS_DIR", raising=False)
    monkeypatch.delenv("TRITON_CACHE_DIR", raising=False)
    run.use_checkout_caches(tmp_path)
    import os
    for k in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR"):
        assert Path(os.environ[k]).parent == tmp_path / "build"
