"""Whole runs of each cell at a size the CPU holds, the port's plain twins
standing in for its kernels (the harness's look for a card skipped): the
result line's schema, ``correct`` on sound runs, and ``correct`` false
with the timed path broken underneath, once for each fault a cell can
have.  The precision controls are here too: the reference put in the
program's place in the precision below comes out not correct."""

import numpy as np
import pytest
import torch
from conftest import run_small, small

from perfbench import control, harness

CELLS = ["mrf_fisp.dict", "mrf_bssfp.dict", "mrf_fisp.serve"]


def _schema(out, parts, trace):
    assert list(out)[-1] == "checks"
    assert set(out) - {"breakdown"} == {"correct", "attempted", "failed",
                                        "metrics", "device", "checks"}
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert out["attempted"] > 0 and out["failed"] >= 0
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        allowed = {m["name"]: m["unit"] for m in parts["per_layer"]}
        b = out["breakdown"]
        assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    else:
        allowed = {m["name"]: m["unit"] for m in parts["end_to_end"]}
        assert set(out["metrics"]) == set(allowed)
        assert all(m["value"] > 0 for m in out["metrics"].values())
    for name, m in out["metrics"].items():
        assert m["unit"] == allowed[name]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(bench, cpu_port, cell, trace):
    parts = small(harness.load_cell(bench, cell))
    out = run_small(parts, trace=trace)
    _schema(out, parts, trace)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    if trace and cell == "mrf_fisp.serve":
        # host spans are read on the CPU too; device metrics are not
        assert {"match_ms.serve", "jac_call_ms.serve", "op_build_ms.serve",
                "gn_solve_ms.serve", "batch_p95_ms.serve"} <= set(
                    out["metrics"])


def test_spans_cover_the_window_alone(bench, cpu_port, monkeypatch):
    """The warm-up batch's spans are not read: each per-layer span is
    counted once per timed batch or Gauss-Newton iteration."""
    from perfbench import tracing

    made, real = [], tracing.Spans

    def spans(*a, **k):
        made.append(real(*a, **k))
        return made[-1]

    monkeypatch.setattr(tracing, "Spans", spans)
    parts = small(harness.load_cell(bench, "mrf_fisp.serve"))
    out = run_small(parts, trace=True)
    n, iters = out["attempted"], parts["traffic"]["gn_iters"]
    d = made[0].durations
    assert len(d("prog.match")) == len(d("bench.batch")) == n
    assert len(d("prog.jac_call")) == len(d("prog.op_build")) == n * iters


def test_serving_setup_fills_the_memos(bench, cpu_port):
    """Set-up makes the warm-up batch's Gauss-Newton calls and then
    `warmup_gn_calls` more; the window, gn_iters per batch."""
    from epgpy_torch import fisp_dispatch

    parts = small(harness.load_cell(bench, "mrf_fisp.serve"))
    tf = parts["traffic"]
    before = fisp_dispatch.DISPATCH_COUNTS.get("jac:fisp", 0)
    out = run_small(parts)
    assert fisp_dispatch.DISPATCH_COUNTS["jac:fisp"] - before == (
        (out["attempted"] + 1) * tf["gn_iters"] + tf["warmup_gn_calls"])


def test_same_seed_same_inputs(bench, cpu_port):
    parts = small(harness.load_cell(bench, "mrf_fisp.serve"))
    a = run_small(parts, seed=2**40 + 3, seconds=0.0)
    b = run_small(parts, seed=2**40 + 3, seconds=0.0)
    assert a["checks"] == b["checks"]


# -- faults planted under the timed path ------------------------------------

def _dict_fault(monkeypatch, cell, kind):
    """Break the dictionary entry's CPU route (the kernels' stand-in)."""
    from epgpy_torch.models import cuda_bssfp, cuda_fisp, mrf

    if cell.startswith("mrf_fisp"):
        mod, name = mrf, "fisp_full_ladder_plain"
    else:
        mod, name = cuda_bssfp, "bssfp_echoes_plain"
    fn = getattr(mod, name)

    def broken(*a, **k):
        re, im = fn(*a, **k)
        re, im = re.clone(), im.clone()
        # fisp_full_ladder_plain gives (B, P) rows; the echoes (P, B)
        atoms = 0 if mod is mrf else 1
        B = re.shape[atoms]
        if kind == "half":
            # half of the atoms left out: their rows never computed
            sl = [slice(None)] * 2
            sl[atoms] = slice(B // 2, None)
            re[tuple(sl)] = 0.0
            im[tuple(sl)] = 0.0
        else:
            # one answer altered where it is produced
            re.select(atoms, B // 3).mul_(1.01)
        return re, im

    monkeypatch.setattr(mod, name, broken)


@pytest.mark.parametrize("kind", ["half", "altered"])
@pytest.mark.parametrize("cell", ["mrf_fisp.dict", "mrf_bssfp.dict"])
def test_dictionary_faults_fail(bench, cpu_port, monkeypatch, cell, kind):
    parts = small(harness.load_cell(bench, cell))
    _dict_fault(monkeypatch, cell, kind)
    out = run_small(parts)
    assert not out["correct"] and out["failed"] > 0


def test_dictionary_missed_kernel_fails(bench, cpu_port, monkeypatch):
    """A call that does not reach the kernel (its launch counter does not
    move) is counted as failed."""
    from epgpy_torch.models import cuda_fisp

    parts = small(harness.load_cell(bench, "mrf_fisp.dict"))
    real = cuda_fisp.LAUNCHES
    monkeypatch.setattr(parts["system_module"].System, "dictionary_launches",
                        lambda self: real)
    out = run_small(parts)
    assert not out["correct"] and out["failed"] == out["attempted"]


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_serving_faults_fail(bench, cpu_port, monkeypatch, kind):
    from epgpy_torch.parallel import match, recon

    parts = small(harness.load_cell(bench, "mrf_fisp.serve"))
    if kind == "unchanged":
        # a Gauss-Newton step that returns its state unchanged
        monkeypatch.setattr(recon, "_gn_step", lambda theta, *a, **k: theta)
    elif kind == "half":
        # half of the batch left out of the refinement: its voxels keep
        # the step of the other half's mean
        step = recon._gn_step

        def half(theta, *a, **k):
            new = step(theta, *a, **k)
            V = theta.shape[1]
            d = (new - theta)[:, :V // 2].mean(dim=1, keepdim=True)
            return torch.cat([new[:, :V // 2], theta[:, V // 2:] + d], 1)

        monkeypatch.setattr(recon, "_gn_step", half)
    else:
        # one answer altered where it is produced: a voxel's matched atom
        local = match._local_match

        def altered(*a, **k):
            best, val = local(*a, **k)
            best = best.clone()
            best[3] = (best[3] + 7) % a[0].shape[0]
            return best, val

        monkeypatch.setattr(match, "_local_match", altered)
    out = run_small(parts)
    assert not out["correct"] and out["failed"] > 0, out["checks"]


@pytest.mark.parametrize("cell", ["mrf_fisp.dict", "mrf_bssfp.dict"])
def test_dictionary_control_fails(bench, cpu_port, cell):
    """The reference in bfloat16 in the program's place is not correct."""
    parts = small(harness.load_cell(bench, cell), npulse=200)
    system = control.ReferenceSystem(parts["reference"], parts["config"],
                                     parts["traffic"], torch.bfloat16)
    out = run_small(parts, system=system, check_paths=False)
    assert not out["correct"]
    assert out["checks"]["fingerprint_err"]["value"] > 10 * \
        parts["limits"]["fingerprint_err"]


def test_tf32_rounding():
    from perfbench.reference.serving import tf32

    x = torch.randn(1000)
    r = tf32(x)
    rel = ((r - x).abs() / x.abs()).max()
    assert 0 < rel <= 2.0 ** -11
    assert torch.equal(tf32(r), r)
    # 10 mantissa bits are left: the low 13 bits are zero
    assert int((r.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert np.isfinite(float(rel))


def _near_ties(parts):
    """A grid of near-duplicate atoms (T1 950-1050 ms, T2 95-105 ms, B1
    0.95-1.05) with the truth drawn inside it: as on the cell's fine
    2^20-atom grid, neighbouring atoms' correlations differ by less than
    TF32's rounding moves them."""
    g = parts["config"]["grid"]
    g["T1"][:2], g["T2"][:2], g["B1"][:2] = [950.0, 1050.0], [95.0,
                                                             105.0], [0.95,
                                                                      1.05]
    parts["traffic"] = dict(parts["traffic"], truth={
        "T1": [950.0, 1050.0], "T2": [95.0, 105.0], "t2_max_over_t1": 0.5,
        "B1": [0.95, 1.05]})
    return parts


@pytest.mark.parametrize("side", ["program", "control"])
def test_serving_control_fails(bench, cpu_port, side):
    """On near-duplicate atoms the program's float32 match passes
    match_gap, and the reference in its place with TF32 products (the
    precision below the program's float32 with TF32 off) fails it."""
    parts = _near_ties(small(harness.load_cell(bench, "mrf_fisp.serve"),
                             npulse=200, points=(12, 12, 4)))
    kw = {}
    if side == "control":
        assert parts["kind"].CONTROL == (torch.float32, True)
        kw = dict(system=control.ReferenceSystem(
            parts["reference"], parts["config"], parts["traffic"],
            *parts["kind"].CONTROL), check_paths=False)
    out = run_small(parts, seconds=1.0, **kw)
    c = out["checks"]["match_gap"]
    if side == "program":
        assert out["correct"] and c["value"] < c["limit"] / 3, out["checks"]
    else:
        assert not out["correct"] and c["value"] > c["limit"], out["checks"]
