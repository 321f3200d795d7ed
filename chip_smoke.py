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
3b. the same for the FISP Jacobian kernel (fingerprints + dS/dT1, dT2,
   dB1[, dD]), per tangent column relative to the column's largest value;
4. the main path at full size: the FISP MR-fingerprinting dictionary
   train [T(FA_i*B1, 90), E(5, T1, T2), ADC, E(7, T1, T2), S(1)] x 1000
   over 102,400 atoms (T1 x T2 x B1 grid) through
   ``epgpy_torch.simulate(seq, max_nstate=10)``; checks that it went
   through the kernel and matches the float64 reference probe of the
   first 8 atoms (bench_baseline.json);
4b. the same train with T1/T2 tracked on the E ops and B1 on the T ops,
   through ``simulate(seq, probe=[ADC, Jacobian(["magnitude", "T1",
   "T2", "B1"])])``: it must reach the Jacobian kernel, its signal match
   the float64 probe, and its columns the port's float64
   ``fisp_mrf_jacobian`` for the first 8 atoms;
5. numbers: kernel and plain twin at the main-path shape, simulate() end
   to end (first call with the host-side match, then memoized), the
   general operator loop at 4096 atoms x 100 TRs, and the same for the
   Jacobian kernel;
5b. serving: 8,192 off-grid voxels (seeded truth, noise 0.002, random
   complex PD) matched against the unnormalized phase-4 dictionary with
   ``parallel.mrf_reconstruct``, then 5 Gauss-Newton iterations whose
   Jacobians come through ``simulate()`` and the Jacobian kernel; the
   refined T1 and T2 RMSE must beat the match-only RMSE;
3c. the per-pulse Hessian kernel against its plain twin over every
   option (4-op/5-op form, inversion, second order, nstate 6/10, phi
   90/30) at 400 TRs x 64 atoms, per output block, and its pulse > echo
   entries exactly zero;
4c. the flagship Hessian through ``simulate()``: the 400-TR train
   [T(a_i, 90), E(tau_i, T1, T2), ADC, S(1)] with alpha/tau aliases over
   256 atoms, probes [ADC, Jacobian([mag, T1, T2]), Hessian([mag, T1, T2],
   alphas + taus)]; it must reach the Hessian kernel, agree with the
   float64 twin on 8 atoms and with a finite difference of it;
5c. CRLB design: the Hessian kernel against its twin at the design's own
   shape (5-op form after an inversion, 256 atoms),
   ``mrf_design_loss_grad_fused`` at 256 atoms, its first 8 atoms against
   float64 autograd of ``mrf_design_loss``, then 5 SLSQP iterations
   (``engine="fused"``, one kernel launch per evaluation) whose loss must
   not rise;
5d. numbers for the Hessian: kernel and twin at the flagship shape,
   ``simulate()`` first call and memoized, the assembly's device share
   (``torch.profiler``), the design iteration times.

The second-to-last lines are the card's name and power limit and a JSON
object of per-kernel results; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import cProfile
import json
import math
import os
import pstats
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
#: Jacobian kernel vs its plain twin, per tangent column relative to the
#: column's largest value (the tangents sum more terms than the primal)
TOL_JAC_KERNEL = 1e-5
#: float32 Jacobian columns vs the float64 model over 1000 pulses, relative
#: to the column's largest value (the JAX package's budget,
#: tests/test_pallas.py:83-88)
TOL_JAC_MODEL = 1e-4
#: serving: measured voxels, their noise level and seed
NVOX, NOISE, SEED = 8192, 0.002, 0
JAC_NAMES = ["magnitude", "T1", "T2", "B1"]
#: the flagship Hessian (examples/profiling_differentiation_mrf.py) and the
#: design (examples/optim_mrf.py): pulses, atoms, design TE and TI
HESS_N, HESS_ATOMS, DESIGN_TE, DESIGN_TI = 400, 256, 5.0, 20.0
#: Hessian kernel vs its plain twin, per output block relative to the
#: block's largest magnitude (float32 both, same operation order)
TOL_HESS_KERNEL = 1e-5
#: float32 flagship blocks vs the float64 twin, per block (400 pulses)
TOL_HESS_F64 = 1e-5
#: d2S/dT2 dalpha_5 vs a central difference, absolute (the example's)
TOL_HESS_FD = 1e-5
#: fused design loss and gradients vs float64 autograd, relative (the JAX
#: package's budget, tests/test_hessian_dispatch.py:248-250)
TOL_DESIGN = 2e-5

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


#: covering set of the Jacobian kernel's options (no normalize; the
#: diffusion case without the ramp term also tracks D: 30 planes)
JAC_CASES = [
    dict(name="base"),
    dict(name="var_te", var_te=True),
    dict(name="inv", inversion=20.0),
    dict(name="inv_df", inversion=20.0, df=True, inversion_df=True),
    dict(name="inv_df_off", inversion=20.0, df=True, inversion_df=False),
    dict(name="df_demod", df=True, demodulate=True),
    dict(name="demod", demodulate=True),
    dict(name="diff_ramp", diffusion="ramp"),
    dict(name="diff_noramp_d", diffusion="noramp", var_te=True, track_d=True),
    dict(name="nstate6", nstate=6, df=True),
    dict(name="all", var_te=True, inversion=15.0, df=True, demodulate=True,
         diffusion="ramp", track_d=True),
]


#: every option of the Hessian kernel: form (4-op: echo at tau; 5-op: echo
#: at TE 5), inversion (TI 20), second order, nstate, RF phase
HESS_CASES = [dict(name=f"{'5op' if te else '4op'}{'_inv' if inv else ''}"
                   f"{'' if so else '_o1'}_n{ns}_phi{phi}",
                   te=te, inversion=inv, second_order=so, nstate=ns, phi=phi)
              for te in (None, 5.0) for inv in (None, 20.0)
              for so in (True, False) for ns in (6, 10) for phi in (90, 30)]


def make_hess_case(case, natoms, npulse, seed=0):
    """Numpy inputs of one Hessian option case: (args, kwargs) of
    fisp_hessian_{cuda,plain,pallas} (FA, phi, TAU, T1s, T2s)."""
    rng = np.random.default_rng(seed)
    FA = rng.uniform(10.0, 60.0, npulse)
    TAU = rng.uniform(11.0, 16.0, npulse)
    if case.get("te") is not None:
        TAU = TAU - case["te"]
    T1 = rng.uniform(400.0, 1600.0, natoms)
    T2 = rng.uniform(40.0, 120.0, natoms)
    kw = dict(te=case.get("te"), inversion=case.get("inversion"),
              nstate=case.get("nstate", NSTATE),
              second_order=case.get("second_order", True))
    return (FA, float(case.get("phi", 90)), TAU, T1, T2), kw


def hess_block_errors(got, want):
    """Per output block max |delta| relative to the block's largest
    magnitude, over the keys of `want` ((re, im) tensor pairs)."""
    errs = {}
    for key, (wre, wim) in want.items():
        gre, gim = got[key]
        scale = max(float(wre.abs().max()), float(wim.abs().max()), 1e-30)
        errs[key] = max(float((gre.double() - wre.double()).abs().max()),
                        float((gim.double() - wim.double()).abs().max())) \
            / scale
    return errs


def make_jac_case(case, natoms, npulse, seed=0):
    """Numpy inputs of one Jacobian option case: (args, kwargs) of
    fisp_jacobian_{cuda,plain,pallas}."""
    args, kw = make_case(case, natoms, npulse, seed)
    del kw["normalize"]
    kw["track_diffusivity"] = case.get("track_d", False)
    return args, kw


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


def fisp_sequence(epg, FA, T1, T2, B1, tracked=False):
    """The main-path train as plain operators, as a user writes it; with
    `tracked`, the E ops track T1 and T2 and the T ops track B1 (chain
    rule d(alpha_i)/dB1 = FA_i)."""
    o1 = ["T1", "T2"] if tracked else False
    seq = []
    for fa in FA:
        seq += [epg.T((fa * B1).astype(np.float32), 90,
                      order1={"B1": {"alpha": float(fa)}} if tracked
                      else False),
                epg.E(TE, T1, T2, order1=o1), epg.ADC,
                epg.E(TR - TE, T1, T2, order1=o1), epg.S(1)]
    return seq


def reference_probe():
    """The float64 reference signal of the first 8 main-path atoms,
    (8, P) complex (bench_baseline.json)."""
    with open(os.path.join(HERE, "bench_baseline.json")) as fh:
        baseline = json.load(fh)
    return (np.asarray(baseline["probe_re"])
            + 1j * np.asarray(baseline["probe_im"])).T


def col_errors(got, want):
    """Per-column max |delta| of (..., k) arrays relative to the column's
    largest magnitude."""
    return [float(np.abs(got[..., c] - want[..., c]).max()
                  / np.abs(want[..., c]).max()) for c in range(want.shape[-1])]


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

    ref8 = reference_probe()                                   # (8, P)
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
                probe_err=probe_err, dictionary=out)


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


def phase_jac_cases(torch, natoms=4096, npulse=NPULSE):
    """Jacobian kernel vs plain twin over the option cases; returns the
    worst fingerprint |delta| and the worst per-column relative error."""
    from epgpy_torch.models import cuda_fisp

    worst_sig = worst_col = 0.0
    for case in JAC_CASES + [dict(name="nstate40", nstate=40,
                                  inversion=20.0, df=True)]:
        args, kw = _tensors(torch, *make_jac_case(case, natoms, npulse),
                            "cuda")
        (kre, kim), (kd_re, kd_im) = cuda_fisp.fisp_jacobian_cuda(*args, **kw)
        (pre, pim), (pd_re, pd_im) = cuda_fisp.fisp_jacobian_plain(*args,
                                                                   **kw)
        sig = max(float((kre - pre).abs().max()),
                  float((kim - pim).abs().max()))
        cols = col_errors(torch.complex(kd_re, kd_im).cpu().numpy(),
                          torch.complex(pd_re, pd_im).cpu().numpy())
        ok = all(bool(torch.isfinite(t).all())
                 for t in (kre, kim, kd_re, kd_im))
        print(f"[jac-cases] {case['name']:14s} nstate={kw['nstate']:2d} "
              f"max|kernel - plain| = {sig:.3e}, per column "
              f"{', '.join(f'{c:.2e}' for c in cols)}")
        if not ok or not sig <= TOL_KERNEL or not max(cols) <= TOL_JAC_KERNEL:
            raise AssertionError(
                f"case {case['name']}: Jacobian kernel vs plain twin "
                f"{sig:.3e} / {max(cols):.3e} over {TOL_KERNEL} / "
                f"{TOL_JAC_KERNEL} or not finite")
        worst_sig, worst_col = max(worst_sig, sig), max(worst_col, max(cols))
    return worst_sig, worst_col


def phase_jac_path(torch, epg):
    """The full-size Jacobian through simulate(); returns the run's facts
    (sequence, launches, first-call time, errors)."""
    from epgpy_torch import config, fisp_dispatch
    from epgpy_torch.models import cuda_fisp, mrf

    FA = make_train(NPULSE)
    T1, T2, B1 = make_atoms(NATOMS)
    seq = fisp_sequence(epg, FA, T1, T2, B1, tracked=True)
    probes = [epg.ADC, epg.Jacobian(JAC_NAMES)]

    fisp_dispatch.clear_cache()
    fisp_dispatch.DISPATCH_COUNTS.clear()
    cuda_fisp.JAC_LAUNCHES = 0
    t0 = time.perf_counter()
    sig, jac = epg.simulate(seq, max_nstate=NSTATE, asarray=False,
                            probe=probes)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = cuda_fisp.JAC_LAUNCHES
    dispatched = fisp_dispatch.DISPATCH_COUNTS.get("jac:fisp", 0)
    print(f"[jac] simulate(probe=[ADC, Jacobian({JAC_NAMES})]): {NPULSE} "
          f"pulses x {NATOMS} atoms -> {tuple(sig.shape)}, "
          f"{tuple(jac.shape)} {jac.dtype}; dispatch jac:fisp="
          f"{dispatched}, Jacobian kernel launches={launches}")
    if dispatched < 1 or launches < 1:
        raise AssertionError("the Jacobian did not go through the kernel")
    if (tuple(sig.shape) != (NPULSE, NATOMS)
            or tuple(jac.shape) != (NPULSE, NATOMS, len(JAC_NAMES))
            or jac.dtype != torch.complex64):
        raise AssertionError(f"unexpected outputs {tuple(sig.shape)}, "
                             f"{tuple(jac.shape)} {jac.dtype}")
    for t in (sig, jac):
        if not bool(torch.isfinite(torch.view_as_real(t)).all()):
            raise AssertionError("non-finite values in the Jacobian path")
    ours = sig[:, :8].cpu().numpy().T                          # (8, P)
    probe_err = float(np.abs(ours - reference_probe()).max())
    mag_err = float((jac[..., 0] - sig).abs().max())
    # the float64 oracle: the port's full-ladder model, jvp'd, on the CPU
    old = (config.device(), config.precision())
    config.set_device("cpu")
    config.set_precision("float64")
    try:
        _, (dre, dim) = mrf.fisp_mrf_jacobian(
            FA, TR, TE, T1[:8], T2[:8], B1[:8], phi=90.0,
            variables=("T1", "T2", "B1"), nstate=NSTATE)
    finally:
        config.set_device(old[0])
        config.set_precision(old[1])
    want = (dre.numpy() + 1j * dim.numpy()).transpose(1, 0, 2)  # (P, 8, 3)
    cols = col_errors(jac[:, :8, 1:].cpu().numpy(), want)
    print(f"[jac] max|signal - f64 reference probe| (8 atoms) = "
          f"{probe_err:.3e} (limit {TOL_PROBE}); magnitude column = signal "
          f"to {mag_err:.1e}; T1/T2/B1 columns vs f64 fisp_mrf_jacobian: "
          f"{', '.join(f'{c:.3e}' for c in cols)} (limit {TOL_JAC_MODEL})")
    if not probe_err <= TOL_PROBE or mag_err != 0.0:
        raise AssertionError(f"Jacobian-path signal error {probe_err:.3e}")
    if not max(cols) <= TOL_JAC_MODEL:
        raise AssertionError(f"Jacobian column error {max(cols):.3e} > "
                             f"{TOL_JAC_MODEL}")
    del sig, jac
    memo_s = _host_s(torch, lambda: epg.simulate(
        seq, max_nstate=NSTATE, asarray=False, probe=probes), reps=2)
    return dict(seq=seq, launches=launches, first_s=first_s, memo_s=memo_s,
                probe_err=probe_err, col_err=max(cols))


def phase_serving(torch, epg, dictionary):
    """Match + Gauss-Newton refinement of NVOX off-grid voxels against
    the phase-4 dictionary; returns the run's facts (launches, timings,
    RMSEs)."""
    from epgpy_torch import fisp_dispatch
    from epgpy_torch.models import cuda_fisp
    from epgpy_torch.parallel import gauss_newton_refine, mrf_reconstruct

    rng = np.random.default_rng(SEED)
    T1t = rng.uniform(300.0, 2500.0, NVOX)
    T2t = np.minimum(rng.uniform(30.0, 200.0, NVOX), 0.5 * T1t)
    B1t = rng.uniform(0.75, 1.25, NVOX)
    truth = np.stack([T1t, T2t, B1t])
    pd = rng.uniform(0.5, 2.0, NVOX) * np.exp(2j * np.pi * rng.random(NVOX))
    noise = NOISE * (rng.standard_normal((NPULSE, NVOX))
                     + 1j * rng.standard_normal((NPULSE, NVOX)))
    FA = make_train(NPULSE)
    T1, T2, B1 = make_atoms(NATOMS)
    grid = np.stack([T1, T2, B1], -1)

    fisp_dispatch.DISPATCH_COUNTS.clear()
    cuda_fisp.LAUNCHES = cuda_fisp.JAC_LAUNCHES = 0
    clean = epg.simulate(fisp_sequence(epg, FA, T1t, T2t, B1t),
                         max_nstate=NSTATE, asarray=False)       # (P, V)
    meas = (clean * torch.as_tensor(pd.astype(np.complex64),
                                    device=clean.device)
            + torch.as_tensor(noise.astype(np.complex64), device=clean.device))
    sre, sim = meas.real.T.contiguous(), meas.imag.T.contiguous()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = mrf_reconstruct(sre, sim, dictionary.real.T, dictionary.imag.T,
                          grid, atom_chunk=16384)
    torch.cuda.synchronize()
    match_s = time.perf_counter() - t0
    theta0 = rec["maps"].T.cpu().numpy()

    split = {"host": 0.0, "simulate": 0.0}

    def signal_and_jac(theta):
        t0 = time.perf_counter()
        seq = fisp_sequence(epg, FA, *theta, tracked=True)
        fisp_dispatch.match_fisp(seq)           # memoized for simulate()
        t1 = time.perf_counter()
        sig, jac = epg.simulate(seq, max_nstate=NSTATE, asarray=False,
                                probe=[epg.ADC, epg.Jacobian(JAC_NAMES[1:])])
        torch.cuda.synchronize()
        split["host"] += t1 - t0
        split["simulate"] += time.perf_counter() - t1
        return (sig.real, sig.imag), (jac.real, jac.imag)

    iters = 5
    t0 = time.perf_counter()
    theta = gauss_newton_refine(
        signal_and_jac, theta0, meas.real, meas.imag, iters=iters,
        bounds=[(100.0, 4000.0), (5.0, 400.0), (0.5, 1.5)], solve_scale=True)
    gn_s = time.perf_counter() - t0
    launches = dict(fisp_half=cuda_fisp.LAUNCHES,
                    fisp_jac=cuda_fisp.JAC_LAUNCHES)
    dispatched = fisp_dispatch.DISPATCH_COUNTS.get("jac:fisp", 0)

    def rmse(est):
        return np.sqrt(np.mean((est - truth) ** 2, axis=1))

    r0, r1 = rmse(theta0), rmse(theta)
    print(f"[serve] {NVOX} voxels x {NATOMS} atoms: match "
          f"{match_s * 1e3:.1f} ms; match-only RMSE T1 {r0[0]:.3f} ms, T2 "
          f"{r0[1]:.3f} ms, B1 {r0[2]:.5f}")
    print(f"[serve] Gauss-Newton x{iters}: RMSE T1 {r1[0]:.3f} ms, T2 "
          f"{r1[1]:.3f} ms, B1 {r1[2]:.5f}; dispatch jac:fisp={dispatched}, "
          f"launches {launches}")
    if dispatched != iters or launches["fisp_jac"] != iters:
        raise AssertionError("a Gauss-Newton iteration missed the kernel")
    if not (r1[0] < r0[0] and r1[1] < r0[1]):
        raise AssertionError("refinement did not beat the grid match")
    per = {k: v / iters for k, v in split.items()}
    per["solve"] = gn_s / iters - per["host"] - per["simulate"]
    return dict(launches=launches, match_s=match_s, per_iter=per,
                gn_s=gn_s, rmse0=r0, rmse1=r1)


def phase_jac_numbers(torch, epg, card, run):
    """Jacobian kernel and plain twin at the main-path shape; returns the
    kernel's JSON entry."""
    from epgpy_torch import fisp_dispatch
    from epgpy_torch.models import cuda_fisp

    params = fisp_dispatch.match_fisp(run["seq"])          # memoized
    d = fisp_dispatch.device_params(params)
    args = (d["FA"], d["phi"], d["TR"], d["TE"], d["T1"], d["T2"], d["B1"],
            d["df"])

    def kernel():
        return cuda_fisp.fisp_jacobian_echoes(*args, nstate=NSTATE)

    def plain():
        return cuda_fisp.fisp_jacobian_echoes_plain(*args, nstate=NSTATE)

    (kre, kim), (kdre, kdim) = kernel()
    (pre, pim), (pdre, pdim) = plain()
    err = max(float((a - b).abs().max())
              for a, b in ((kre, pre), (kim, pim), (kdre, pdre),
                           (kdim, pdim)))
    cols = [max(float((kdre[..., c] - pdre[..., c]).abs().max()),
                float((kdim[..., c] - pdim[..., c]).abs().max()))
            / max(float(pdre[..., c].abs().max()),
                  float(pdim[..., c].abs().max())) for c in range(3)]
    print(f"[numbers] Jacobian main-path shape: max|kernel - plain| = "
          f"{err:.3e}, per column {', '.join(f'{c:.2e}' for c in cols)}")
    if not max(cols) <= TOL_JAC_KERNEL:
        raise AssertionError(f"Jacobian kernel vs plain twin {max(cols):.3e}")
    del kre, kim, kdre, kdim, pre, pim, pdre, pdim
    k_ms = _cuda_ms(torch, kernel)
    p_ms = _cuda_ms(torch, plain, reps=1)
    tag = f"({card})"
    print(f"[numbers] fisp_jac kernel, {NATOMS} atoms x {NPULSE} pulses: "
          f"{k_ms:.3f} ms = {NATOMS / (k_ms / 1e3):.4g} atoms/s {tag}")
    print(f"[numbers] Jacobian plain twin on the card, same shape: "
          f"{p_ms:.3f} ms {tag}")
    print(f"[numbers] simulate() Jacobian end to end, first call (match + "
          f"kernel): {run['first_s']:.3f} s; memoized match: "
          f"{run['memo_s']:.4f} s {tag}")
    return {"name": "fisp_jac", "route": "cuda",
            "source": "epgpy_torch/csrc/fisp_jac.cu",
            "replaces": "epgpy_tpu/models/pallas_fisp.py:458",
            "launches": run["launches"], "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms}


def phase_hess_cases(torch, natoms=64):
    """Hessian kernel vs plain twin over every option; returns the worst
    per-block relative error."""
    from epgpy_torch.models import cuda_hessian

    worst = 0.0
    for case in HESS_CASES:
        args, kw = make_hess_case(case, natoms, HESS_N)
        targs, _ = _tensors(torch, args, {}, "cuda")
        k = cuda_hessian.fisp_hessian_cuda(*targs, **kw)
        p = cuda_hessian.fisp_hessian_plain(*targs, **kw)
        errs = hess_block_errors(k, p)
        parts = [t for pair in k.values() for t in pair]
        ok = all(bool(torch.isfinite(t).all()) for t in parts)
        upper = max(float(torch.triu(t, diagonal=1).abs().max())
                    for t in parts if t.ndim == 3)
        err = max(errs.values())
        print(f"[hess-cases] {case['name']:22s} max per-block |kernel - "
              f"plain| = {err:.3e}; pulse > echo entries max {upper:.1e}")
        if not ok or not err <= TOL_HESS_KERNEL or upper != 0.0:
            raise AssertionError(
                f"case {case['name']}: Hessian kernel vs plain twin "
                f"{err:.3e} > {TOL_HESS_KERNEL}, non-finite, or nonzero "
                f"pulse > echo entries ({upper:.1e})")
        worst = max(worst, err)
    return worst


def flagship_train():
    """The flagship differentiation train: FA ~ U(10, 60), tau ~ U(11, 16)
    (examples/profiling_differentiation_mrf.py:36-54)."""
    rng = np.random.default_rng(0)
    return rng.uniform(10, 60, HESS_N), rng.uniform(11, 16, HESS_N)


def design_atoms():
    """The design atoms: T1 ~ U(400, 1600), T2 ~ U(40, 120)
    (examples/optim_mrf.py:main)."""
    rng = np.random.default_rng(1)
    return (rng.uniform(400.0, 1600.0, HESS_ATOMS),
            rng.uniform(40.0, 120.0, HESS_ATOMS))


def initial_train(n):
    """The design's start: sine FA ramp + smooth TR noise
    (examples/optim_mrf.py:48-64)."""
    rng = np.random.RandomState(0)
    nFA = 300
    FA = []
    for _ in range(n // nFA + 1):
        ramp = np.sin(np.arange(1, 1 + nFA) * np.pi / nFA) * 50 + 10
        ramp[-10:] = 10
        FA.extend(ramp.tolist())
    FA = np.clip(FA[:n], 10.0, 60.0)
    knots = rng.uniform(11.5, 14.5, n // 10 + 2)
    x = np.arange(n) / 10.0
    i = x.astype(int)
    s = x - i
    h = 3 * s**2 - 2 * s**3
    TR = knots[i] * (1 - h) + knots[i + 1] * h
    return np.asarray(FA), np.clip(TR, 11.0, 16.0)


def hessian_sequence(epg, FA, TAU, T1, T2):
    """The flagship train as a user writes it: each T tracks its alpha
    alias, each E T1, T2 and its tau alias."""
    alphas = [f"alpha_{i:03d}" for i in range(len(FA))]
    taus = [f"tau_{i:03d}" for i in range(len(FA))]
    seq = []
    for i in range(len(FA)):
        seq += [epg.T(float(FA[i]), 90, order1={alphas[i]: "alpha"}),
                epg.E(float(TAU[i]), T1, T2,
                      order1={"T1": "T1", "T2": "T2", taus[i]: "tau"}),
                epg.ADC, epg.S(1)]
    probes = [epg.ADC, epg.Jacobian(["magnitude", "T1", "T2"]),
              epg.Hessian(["magnitude", "T1", "T2"], alphas + taus)]
    return seq, probes


def phase_hess_path(torch, epg):
    """The flagship Hessian through simulate(); returns the run's facts."""
    from epgpy_torch import fisp_dispatch
    from epgpy_torch.models import cuda_hessian

    N = HESS_N
    FA, TAU = flagship_train()
    T1, T2 = design_atoms()
    seq, probes = hessian_sequence(epg, FA, TAU, T1, T2)

    fisp_dispatch.clear_cache()
    fisp_dispatch.DISPATCH_COUNTS.clear()
    cuda_hessian.HESS_LAUNCHES = 0
    t0 = time.perf_counter()
    sig, jac, hes = epg.simulate(seq, max_nstate=NSTATE, asarray=False,
                                 probe=probes)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = cuda_hessian.HESS_LAUNCHES
    dispatched = fisp_dispatch.DISPATCH_COUNTS.get("hessian", 0)
    print(f"[hess] simulate(probe=[ADC, Jacobian, Hessian(3 x {2 * N})]): "
          f"{N} pulses x {HESS_ATOMS} atoms -> {tuple(hes.shape)} "
          f"{hes.dtype}; dispatch hessian={dispatched}, Hessian kernel "
          f"launches={launches}")
    if dispatched != 1 or launches < 1:
        raise AssertionError("the Hessian did not go through the kernel")
    if (tuple(sig.shape) != (N, HESS_ATOMS)
            or tuple(jac.shape) != (N, HESS_ATOMS, 3)
            or tuple(hes.shape) != (N, HESS_ATOMS, 3, 2 * N)
            or hes.dtype != torch.complex64):
        raise AssertionError(f"unexpected outputs {tuple(sig.shape)}, "
                             f"{tuple(jac.shape)}, {tuple(hes.shape)}")
    for t in (sig, jac, hes):
        if not bool(torch.isfinite(torch.view_as_real(t)).all()):
            raise AssertionError("non-finite values in the Hessian path")
    if not bool((jac[..., 0] == sig).all()):
        raise AssertionError("the magnitude column is not the signal")

    # the float64 twin on the first 8 atoms, on the card
    d64 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float64,  # noqa
                                    device="cuda")
    ref = cuda_hessian.fisp_hessian_plain(d64(FA), 90.0, d64(TAU),
                                          d64(T1[:8]), d64(T2[:8]),
                                          nstate=NSTATE)
    h8 = hes[:, :8].permute(1, 0, 2, 3)                    # (8, j, 3, 2N)

    def pair(t):
        return t.real, t.imag

    got = {"sig": pair(sig[:, :8].T), "dT1": pair(jac[:, :8, 1].T),
           "dT2": pair(jac[:, :8, 2].T)}
    for r, pre in enumerate(("d", "dT1d", "dT2d")):
        got[pre + "alpha"] = pair(h8[:, :, r, :N])
        got[pre + "tau"] = pair(h8[:, :, r, N:])
    errs = hess_block_errors(got, ref)
    err = max(errs.values())

    # the example's check: d2S/dT2 dalpha_5 vs a central difference of the
    # float64 twin's dalpha_5 column in T2, at one atom
    eps = 1e-4
    side = [cuda_hessian.fisp_hessian_plain(
        d64(FA), 90.0, d64(TAU), d64(T1[:1]), d64(T2[:1] + s * eps),
        nstate=NSTATE, second_order=False)["dalpha"] for s in (1, -1)]
    fd = torch.complex(side[0][0][0, :, 5] - side[1][0][0, :, 5],
                       side[0][1][0, :, 5] - side[1][1][0, :, 5]) / (2 * eps)
    fd_err = float((hes[:, 0, 2, 5].to(torch.complex128) - fd).abs().max())
    print(f"[hess] first 8 atoms vs the float64 twin, per block: "
          f"{', '.join(f'{k} {v:.2e}' for k, v in errs.items())} (limit "
          f"{TOL_HESS_F64}); d2S/dT2 dalpha_5 vs central difference "
          f"{fd_err:.3e} (limit {TOL_HESS_FD})")
    if not err <= TOL_HESS_F64 or not fd_err <= TOL_HESS_FD:
        raise AssertionError(f"Hessian path error {err:.3e} / FD "
                             f"{fd_err:.3e}")
    del sig, jac, hes, h8, got
    memo_s = _host_s(torch, lambda: epg.simulate(
        seq, max_nstate=NSTATE, asarray=False, probe=probes), reps=3)
    return dict(seq=seq, probes=probes, launches=launches, first_s=first_s,
                memo_s=memo_s, f64_err=err, fd_err=fd_err)


def phase_design(torch, epg):
    """CRLB design: the kernel at the design's shape against its twin, the
    fused loss and gradient at 256 atoms, checked on 8 atoms against
    float64 autograd, then SLSQP; returns the facts."""
    from epgpy_torch import config
    from epgpy_torch.models import cuda_hessian
    from epgpy_torch.parallel import (mrf_design_loss,
                                      mrf_design_loss_grad_fused,
                                      mrf_design_slsqp)

    FA0, TR0 = initial_train(HESS_N)
    T1, T2 = design_atoms()
    kw = dict(TE=DESIGN_TE, nstate=NSTATE, inversion=DESIGN_TI, sigma2=10.0)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32),  # noqa: E731
                                    device="cuda")
    fa0, tr0, t1s, t2s = f32(FA0), f32(TR0), f32(T1), f32(T2)

    # the kernel against its plain twin on the inputs the design launches:
    # the 5-op form after an inversion, 256 atoms
    hargs = (fa0, 90.0, tr0 - DESIGN_TE, t1s, t2s)
    hkw = dict(te=DESIGN_TE, inversion=DESIGN_TI, nstate=NSTATE)
    errs = hess_block_errors(cuda_hessian.fisp_hessian_cuda(*hargs, **hkw),
                             cuda_hessian.fisp_hessian_plain(*hargs, **hkw))
    herr = max(errs.values())
    print(f"[design] kernel vs plain twin, 5-op form with inversion, "
          f"{HESS_ATOMS} atoms x {HESS_N} pulses: max per-block "
          f"|kernel - plain| = {herr:.3e} (limit {TOL_HESS_KERNEL})")
    if not herr <= TOL_HESS_KERNEL:
        raise AssertionError(f"Hessian kernel vs plain twin at the design "
                             f"shape {herr:.3e}")

    # the float64 autograd oracle on the first 8 atoms, on the CPU
    fused8 = mrf_design_loss_grad_fused(fa0, tr0, t1s[:8], t2s[:8], **kw)
    old = (config.device(), config.precision())
    config.set_device("cpu")
    config.set_precision("float64")
    try:
        fa = torch.tensor(FA0, requires_grad=True)
        tr = torch.tensor(TR0, requires_grad=True)
        loss = mrf_design_loss(fa, tr, T1[:8], T2[:8], ridge=0.0, **kw)
        oracle = (loss.detach(),) + torch.autograd.grad(loss, (fa, tr))
    finally:
        config.set_device(old[0])
        config.set_precision(old[1])
    rel = [float((g.double().cpu() - o).abs().max() / o.abs().max())
           for g, o in zip(fused8, oracle)]
    print(f"[design] 8 atoms, fused vs float64 autograd: loss {rel[0]:.2e},"
          f" gFA {rel[1]:.2e}, gTR {rel[2]:.2e} (limit {TOL_DESIGN})")
    if not max(rel) <= TOL_DESIGN:
        raise AssertionError(f"fused design gradient {max(rel):.3e} > "
                             f"{TOL_DESIGN}")

    loss0, gfa, gtr = mrf_design_loss_grad_fused(fa0, tr0, t1s, t2s, **kw)
    torch.cuda.synchronize()
    vals = [float(loss0)] + [float(v.abs().max()) for v in (gfa, gtr)]
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError("non-finite design loss or gradient")
    fused_ms = _host_s(torch, lambda: mrf_design_loss_grad_fused(
        fa0, tr0, t1s, t2s, **kw), reps=3) * 1e3

    # per iteration: the loss SLSQP evaluated at the iterate (the callback
    # launches nothing) and the wall time since the previous callback;
    # cProfile times the evaluations (costjac: kernel, contraction and the
    # copy to the host) against the whole run
    last, losses, iter_s = [0.0], [], []

    def record(intermediate_result):
        iter_s.append(time.perf_counter() - last[0])
        losses.append(float(intermediate_result.fun))
        last[0] = time.perf_counter()

    prof = cProfile.Profile()
    cuda_hessian.HESS_LAUNCHES = 0
    last[0] = t0 = time.perf_counter()
    prof.enable()
    fa, tr, res = mrf_design_slsqp(FA0, TR0, t1s, t2s, engine="fused",
                                   maxiter=5, callback=record, **kw)
    prof.disable()
    slsqp_s = time.perf_counter() - t0
    launches = cuda_hessian.HESS_LAUNCHES
    evals = [(v[1], v[3]) for k, v in pstats.Stats(prof).stats.items()
             if k[2] == "costjac"]
    n_eval, eval_s = (sum(x) for x in zip(*evals)) if evals else (0, 0.0)
    print(f"[design] {HESS_ATOMS} atoms x {HESS_N} pulses: fused loss + "
          f"2x{HESS_N} gradient {fused_ms:.2f} ms; loss {vals[0]:.6g}")
    for k, (v, dt) in enumerate(zip(losses, iter_s)):
        print(f"[design] SLSQP iteration {k + 1}: loss {v:.6g}, "
              f"{dt:.3f} s")
    print(f"[design] SLSQP: {res.nit} iterations, {res.nfev} evaluations, "
          f"status {res.status} ({res.message}); Hessian kernel launches="
          f"{launches}, evaluation calls={n_eval}")
    print(f"[design] SLSQP wall {slsqp_s:.3f} s: evaluations {eval_s:.3f} s,"
          f" scipy and the rest {slsqp_s - eval_s:.3f} s "
          f"({100 * (slsqp_s - eval_s) / slsqp_s:.1f}%, cProfile)")
    if launches < 1 or launches != n_eval or n_eval < res.nfev:
        raise AssertionError(
            f"the design's launches ({launches}) are not one per evaluation "
            f"({n_eval} calls, {res.nfev} counted by SLSQP)")
    if not losses or not losses[-1] <= vals[0]:
        raise AssertionError(f"the design loss rose: {vals[0]:.6g} -> "
                             f"{losses[-1] if losses else None}")
    return dict(launches=launches, fused_ms=fused_ms, iter_s=iter_s,
                losses=losses, rel=max(rel), loss0=vals[0], herr=herr,
                slsqp_s=slsqp_s, eval_s=eval_s)


def _device_us(event):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def phase_hess_numbers(torch, epg, card, run):
    """Hessian kernel and plain twin at the flagship shape, the
    assembly's share; returns the kernel's JSON entry."""
    from epgpy_torch import fisp_dispatch
    from epgpy_torch.models import cuda_hessian
    from torch.profiler import ProfilerActivity, profile

    params = fisp_dispatch.match_fisp_hessian(run["seq"])      # memoized
    d = fisp_dispatch.hess_device_params(params)
    args = (d["FA"], d["phi"], d["TAU"], d["T1"], d["T2"])

    def kernel():
        return cuda_hessian.fisp_hessian_cuda(*args, nstate=NSTATE)

    def plain():
        return cuda_hessian.fisp_hessian_plain(*args, nstate=NSTATE)

    k, p = kernel(), plain()
    errs = hess_block_errors(k, p)
    err = max(max(float((a - b).abs().max()) for a, b in zip(k[n], p[n]))
              for n in p)
    print(f"[numbers] Hessian main-path shape: max|kernel - plain| = "
          f"{err:.3e}, per block <= {max(errs.values()):.2e}")
    if not max(errs.values()) <= TOL_HESS_KERNEL:
        raise AssertionError(f"Hessian kernel vs plain twin "
                             f"{max(errs.values()):.3e}")
    del k, p
    k_ms = _cuda_ms(torch, kernel)
    p_ms = _cuda_ms(torch, plain, reps=1)

    seq, probes = run["seq"], run["probes"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        epg.simulate(seq, max_nstate=NSTATE, asarray=False, probe=probes)
        torch.cuda.synchronize()
    events = prof.key_averages()
    total = sum(_device_us(e) for e in events)
    kern = sum(_device_us(e) for e in events if "fisp_hess" in e.key)
    tag = f"({card})"
    print(f"[numbers] fisp_hess kernel, {HESS_ATOMS} atoms x {HESS_N} "
          f"pulses (3 x {2 * HESS_N}): {k_ms:.3f} ms = "
          f"{HESS_ATOMS / (k_ms / 1e3):.4g} atoms/s {tag}")
    print(f"[numbers] Hessian plain twin on the card, same shape: "
          f"{p_ms:.3f} ms {tag}")
    print(f"[numbers] simulate() Hessian end to end, first call (match + "
          f"kernel + assembly): {run['first_s']:.3f} s; memoized match: "
          f"{run['memo_s'] * 1e3:.2f} ms {tag}")
    if total > 0:
        print(f"[numbers] simulate() Hessian device time (torch.profiler): "
              f"{total / 1e3:.3f} ms, fisp_hess kernel {kern / 1e3:.3f} ms, "
              f"output assembly and the rest {(total - kern) / 1e3:.3f} ms "
              f"({100 * (total - kern) / total:.1f}%) {tag}")
    else:
        print("[numbers] simulate() Hessian device time: not measured "
              "(the profiler reported no device time)")
    return {"name": "fisp_hess", "route": "cuda",
            "source": "epgpy_torch/csrc/fisp_hess.cu",
            "replaces": "epgpy_tpu/models/pallas_hessian.py:83",
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
    worst_sig, worst_col = phase_jac_cases(torch)
    print(f"[jac-cases] worst max|kernel - plain| = {worst_sig:.3e} (limit "
          f"{TOL_KERNEL}), worst column {worst_col:.3e} (limit "
          f"{TOL_JAC_KERNEL})")
    worst_hess = phase_hess_cases(torch)
    print(f"[hess-cases] worst per-block |kernel - plain| = {worst_hess:.3e} "
          f"(limit {TOL_HESS_KERNEL}) over {len(HESS_CASES)} cases")
    main_run = phase_main_path(torch, epg)
    jac_run = phase_jac_path(torch, epg)
    serve = phase_serving(torch, epg, main_run.pop("dictionary"))
    hess_run = phase_hess_path(torch, epg)
    design = phase_design(torch, epg)
    entry = phase_numbers(torch, epg, card, main_run)
    jac_entry = phase_jac_numbers(torch, epg, card, jac_run)
    hess_entry = phase_hess_numbers(torch, epg, card, hess_run)
    # launches on the Hessian's main paths: the flagship (4c) and the SLSQP
    # run of the design (5c)
    hess_entry["launches"] += design["launches"]
    # launches on the main paths: the dictionary (4), the Jacobian (4b)
    # and serving (5b: truth fingerprints, one Jacobian per iteration)
    entry["launches"] += serve["launches"]["fisp_half"]
    jac_entry["launches"] += serve["launches"]["fisp_jac"]
    per = serve["per_iter"]
    print(f"[numbers] serving, {NVOX} voxels x {NATOMS} atoms: match "
          f"{serve['match_s'] * 1e3:.1f} ms; Gauss-Newton per iteration "
          f"{serve['gn_s'] / 5:.3f} s = host build + match "
          f"{per['host']:.3f} s + simulate (kernel + assembly) "
          f"{per['simulate']:.3f} s + update/solve {per['solve']:.3f} s "
          f"({card})")
    its = design["iter_s"]
    print(f"[numbers] design, {HESS_ATOMS} atoms x {HESS_N} pulses: fused "
          f"loss + gradient {design['fused_ms']:.2f} ms; SLSQP "
          f"{len(its)} iterations, {sum(its) / max(len(its), 1):.3f} s per "
          f"iteration ({design['eval_s'] / design['slsqp_s']:.1%} of the "
          f"run in evaluations), loss {design['loss0']:.6g} -> "
          f"{design['losses'][-1]:.6g} ({card})")
    print(card)
    print(json.dumps({"kernels": [entry, jac_entry, hess_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
