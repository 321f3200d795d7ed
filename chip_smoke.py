#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (epgpy_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each raises on failure: a failure exits non-zero with no result):

1. environment: the card's name and power limit, torch/CUDA versions,
   nvcc; requires a CUDA device;
2. build: compiles the kernel library from epgpy_torch/csrc into
   build/epgpy_torch/ (first use) and loads it;
3. the FISP kernel against its plain PyTorch twin on the card, over a
   covering set of option cases at 4096 atoms x 1000 pulses (plus one
   case at nstate 40, beyond 48 KB of shared memory per block);
4. the main path at full size: the FISP MR-fingerprinting dictionary
   train [T(FA_i*B1, 90), E(5, T1, T2), ADC, E(7, T1, T2), S(1)] x 1000
   over 102,400 atoms (T1 x T2 x B1 grid) through
   ``epgpy_torch.simulate(seq, max_nstate=10)``; checks that it went
   through the kernel and matches the float64 reference probe of the
   first 8 atoms (bench_baseline.json);
5. numbers: kernel and plain twin at the main-path shape, simulate() end
   to end (first call with the host-side match, then memoized), the
   general operator loop at 4096 atoms x 100 TRs.

The second-to-last lines are the card's name and power limit and a JSON
object of per-kernel results; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TR, TE, NSTATE = 12.0, 5.0, 10
NATOMS, NPULSE = 102400, 1000

#: CUDA kernel vs its plain twin on the card, both float32 with the same
#: operation order: they differ by FMA contraction and libm rounding only
TOL_KERNEL = 2e-6
#: float32 main path vs the float64 reference probe over 1000 pulses
TOL_PROBE = 1e-6

#: covering set of the kernel's options: every value of each option
#: appears at least once (var_te: per-pulse TE; inversion: TI in ms;
#: diffusion: with/without the gradient-ramp 1/3 term)
OPTION_CASES = [
    dict(name="base"),
    dict(name="var_te", var_te=True),
    dict(name="inv", inversion=20.0),
    dict(name="inv_df", inversion=20.0, df=True, inversion_df=True),
    dict(name="inv_df_off", inversion=20.0, df=True, inversion_df=False),
    dict(name="df_demod", df=True, demodulate=True),
    dict(name="demod", demodulate=True),
    dict(name="diff_ramp", diffusion="ramp"),
    dict(name="diff_noramp", diffusion="noramp", var_te=True),
    dict(name="normalize", normalize=True),
    dict(name="nstate6", nstate=6, df=True),
    dict(name="all", var_te=True, inversion=15.0, df=True, demodulate=True,
         diffusion="ramp", normalize=True),
]


def make_case(case, natoms, npulse, seed=0):
    """Numpy inputs of one option case: (args, kwargs) of
    fisp_dictionary_{cuda,plain,pallas} (FA, phi, TR, TE, T1s, T2s, B1s,
    dfs; nstate and the options)."""
    rng = np.random.default_rng(seed)
    FA = 10.0 + 50.0 * np.abs(np.sin(np.arange(npulse) * 2 * np.pi / 500.0))
    FA += rng.uniform(0, 2, npulse)
    phi = rng.uniform(0.0, 180.0, npulse)
    TRs = rng.uniform(11.0, 16.0, npulse)
    TEs = rng.uniform(2.0, 5.0, npulse) if case.get("var_te") else TE
    T1 = rng.uniform(200.0, 2500.0, natoms)
    T2 = np.minimum(rng.uniform(20.0, 250.0, natoms), 0.8 * T1)
    B1 = rng.uniform(0.7, 1.3, natoms)
    df = rng.uniform(-0.05, 0.05, natoms) if case.get("df") else None
    kw = dict(nstate=case.get("nstate", NSTATE),
              demodulate=case.get("demodulate", False),
              inversion=case.get("inversion"),
              inversion_df=case.get("inversion_df", True),
              normalize=case.get("normalize", False))
    if case.get("diffusion"):
        kw["diffusion"] = (6.0, 4.0, rng.uniform(0.5e-3, 3e-3, natoms))
        kw["diff_ramp"] = case["diffusion"] == "ramp"
    return (FA, phi, TRs, TEs, T1, T2, B1, df), kw


def make_train(npulse):
    """The benchmark's flip-angle train (bench.py:make_train)."""
    rng = np.random.default_rng(42)
    FA = 10.0 + 50.0 * np.abs(np.sin(np.arange(npulse) * 2 * np.pi / 500.0))
    FA += rng.uniform(0, 2, npulse)
    return FA.astype(np.float64)


def make_atoms(natoms):
    """The benchmark's T1 x T2 x B1 grid (bench.py:make_atoms)."""
    n1 = max(int(round(natoms ** (1 / 3))), 2)
    n2 = max(int(round((natoms / n1) ** 0.5)), 2)
    n3 = max(natoms // (n1 * n2), 1)
    T1 = np.linspace(100.0, 3000.0, n1)
    T2 = np.linspace(10.0, 300.0, n2)
    B1 = np.linspace(0.7, 1.3, n3)
    g = np.stack(np.meshgrid(T1, T2, B1, indexing="ij"), -1).reshape(-1, 3)
    if len(g) < natoms:
        g = np.tile(g, (-(-natoms // len(g)), 1))
    g = g[:natoms]
    g[:, 1] = np.minimum(g[:, 1], 0.8 * g[:, 0])
    return g[:, 0], g[:, 1], g[:, 2]


def fisp_sequence(epg, FA, T1, T2, B1):
    """The main-path train as plain operators, as a user writes it."""
    seq = []
    for fa in FA:
        seq += [epg.T((fa * B1).astype(np.float32), 90), epg.E(TE, T1, T2),
                epg.ADC, epg.E(TR - TE, T1, T2), epg.S(1)]
    return seq


def _tensors(torch, args, kw, device):
    """Numpy case inputs -> float32 tensors on `device`."""
    def t(x):
        if x is None or np.ndim(x) == 0:
            return x
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    kw = dict(kw)
    if "diffusion" in kw:
        bT, bL, Dc = kw["diffusion"]
        kw["diffusion"] = (bT, bL, t(Dc))
    return tuple(t(a) for a in args), kw


def _cuda_ms(torch, fn, reps=5):
    """Best of `reps` timed runs (CUDA events) after one warm-up, in ms."""
    fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        best = min(best, start.elapsed_time(stop))
    return best


def _host_s(torch, fn, reps=5):
    """Best of `reps` host-clock runs ending in a device sync, in s."""
    best = math.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def phase_environment(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available"
                         "() is false); this smoke test runs on the GPU only")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[env] card: {card}")
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__},"
          f" CUDA {torch.version.cuda}, device "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    print(f"[env] nvcc: {shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build():
    from epgpy_torch import _build

    _build.load()
    info = _build.build_info()
    secs = info["seconds"]
    print(f"[build] {info['path']} "
          f"({'already built' if secs is None else f'{secs:.1f} s'})")
    for line in info["log"].splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"[build] {line.strip()}")


def phase_cases(torch, natoms=4096, npulse=NPULSE):
    """Kernel vs plain twin over the option cases; returns max |delta|."""
    from epgpy_torch.models import cuda_fisp

    worst = 0.0
    for case in OPTION_CASES + [dict(name="nstate40", nstate=40,
                                     inversion=20.0, df=True)]:
        args, kw = _tensors(torch, *make_case(case, natoms, npulse), "cuda")
        kre, kim = cuda_fisp.fisp_dictionary_cuda(*args, **kw)
        pre, pim = cuda_fisp.fisp_dictionary_plain(*args, **kw)
        delta = max(float((kre - pre).abs().max()),
                    float((kim - pim).abs().max()))
        ok = bool(torch.isfinite(kre).all() and torch.isfinite(kim).all())
        print(f"[cases] {case['name']:12s} nstate={kw['nstate']:2d} "
              f"max|kernel - plain| = {delta:.3e}")
        if not ok or not delta <= TOL_KERNEL:
            raise AssertionError(f"case {case['name']}: kernel vs plain twin "
                                 f"{delta:.3e} > {TOL_KERNEL} or not finite")
        worst = max(worst, delta)
    return worst


def phase_main_path(torch, epg):
    """The full-size dictionary through simulate(); returns the run's
    facts (sequence, launches, first-call time, probe error)."""
    from epgpy_torch import fisp_dispatch
    from epgpy_torch.models import cuda_fisp

    with open(os.path.join(HERE, "bench_baseline.json")) as fh:
        baseline = json.load(fh)
    ref8 = (np.asarray(baseline["probe_re"])
            + 1j * np.asarray(baseline["probe_im"])).T          # (8, P)
    FA = make_train(NPULSE)
    T1, T2, B1 = make_atoms(NATOMS)
    seq = fisp_sequence(epg, FA, T1, T2, B1)

    fisp_dispatch.clear_cache()
    fisp_dispatch.DISPATCH_COUNTS.clear()
    cuda_fisp.LAUNCHES = 0
    t0 = time.perf_counter()
    out = epg.simulate(seq, max_nstate=NSTATE, asarray=False)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = cuda_fisp.LAUNCHES
    dispatched = fisp_dispatch.DISPATCH_COUNTS.get("fisp", 0)

    print(f"[main] simulate(): {NPULSE} pulses x {NATOMS} atoms -> "
          f"{tuple(out.shape)} {out.dtype}; dispatch fisp={dispatched}, "
          f"kernel launches={launches}")
    if dispatched < 1 or launches < 1:
        raise AssertionError("the main path did not go through the kernel")
    if tuple(out.shape) != (NPULSE, NATOMS) or out.dtype != torch.complex64:
        raise AssertionError(f"unexpected output {tuple(out.shape)} "
                             f"{out.dtype}")
    if not bool(torch.isfinite(torch.view_as_real(out)).all()):
        raise AssertionError("non-finite values in the dictionary")
    ours = out[:, :8].cpu().numpy().T
    probe_err = float(np.abs(ours - ref8).max())
    print(f"[main] max|simulate - f64 reference probe| (8 atoms) = "
          f"{probe_err:.3e} (limit {TOL_PROBE})")
    if not probe_err <= TOL_PROBE:
        raise AssertionError(f"probe error {probe_err:.3e} > {TOL_PROBE}")
    return dict(seq=seq, launches=launches, first_s=first_s,
                probe_err=probe_err)


def phase_numbers(torch, epg, card, run):
    """Times at the main-path shape; returns the kernel's JSON entry."""
    from epgpy_torch import fisp_dispatch
    from epgpy_torch.models import cuda_fisp

    seq = run["seq"]
    params = fisp_dispatch.match_fisp(seq)          # memoized
    d = fisp_dispatch.device_params(params)
    args = (d["FA"], d["phi"], d["TR"], d["TE"], d["T1"], d["T2"], d["B1"],
            d["df"])

    def kernel():
        return cuda_fisp.fisp_echoes(*args, nstate=NSTATE)

    def plain():
        return cuda_fisp.fisp_echoes_plain(*args, nstate=NSTATE)

    kre, kim = kernel()
    pre, pim = plain()
    err = max(float((kre - pre).abs().max()), float((kim - pim).abs().max()))
    print(f"[numbers] main-path shape: max|kernel - plain| = {err:.3e}")
    if not err <= TOL_KERNEL:
        raise AssertionError(f"kernel vs plain twin {err:.3e} > {TOL_KERNEL}")
    del kre, kim, pre, pim

    k_ms = _cuda_ms(torch, kernel)
    p_ms = _cuda_ms(torch, plain)
    memo_s = _host_s(torch, lambda: epg.simulate(
        seq, max_nstate=NSTATE, asarray=False))

    g_atoms, g_pulses = 4096, 100
    T1, T2, B1 = make_atoms(NATOMS)
    gseq = fisp_sequence(epg, make_train(g_pulses), T1[:g_atoms],
                         T2[:g_atoms], B1[:g_atoms])
    gen_s = _host_s(torch, lambda: epg.simulate(
        gseq, max_nstate=NSTATE, asarray=False, fisp_kernel=False))

    tag = f"({card})"
    print(f"[numbers] fisp_half kernel, {NATOMS} atoms x {NPULSE} pulses: "
          f"{k_ms:.3f} ms = {NATOMS / (k_ms / 1e3):.4g} atoms/s {tag}")
    print(f"[numbers] plain twin on the card, same shape: {p_ms:.3f} ms = "
          f"{NATOMS / (p_ms / 1e3):.4g} atoms/s {tag}")
    print(f"[numbers] simulate() end to end, first call (match + kernel): "
          f"{run['first_s']:.3f} s; memoized match: {memo_s:.4f} s "
          f"= {NATOMS / memo_s:.4g} atoms/s {tag}")
    print(f"[numbers] general op loop, {g_atoms} atoms x {g_pulses} TRs: "
          f"{gen_s:.4f} s = {g_atoms / gen_s:.4g} atoms/s {tag}")
    return {"name": "fisp_half", "route": "cuda",
            "source": "epgpy_torch/csrc/fisp_half.cu",
            "replaces": "epgpy_tpu/models/pallas_fisp.py:270",
            "launches": run["launches"], "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms}


def main():
    import torch

    card = phase_environment(torch)
    import epgpy_torch as epg

    epg.config.set_device("cuda")
    epg.config.set_precision("float32")
    phase_build()
    worst = phase_cases(torch)
    print(f"[cases] worst max|kernel - plain| = {worst:.3e} "
          f"(limit {TOL_KERNEL})")
    main_run = phase_main_path(torch, epg)
    entry = phase_numbers(torch, epg, card, main_run)
    print(card)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
