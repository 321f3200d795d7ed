"""Time the segmented kernels of several checkouts on one card.

    python3 tools/jac_kernel_ab.py ROOT [ROOT ...] [--reps N]
                                   [--kernels NAME [NAME ...]]
                                   [--rounds N] [--fits]
                                   [--rows R [R ...]] [--nstates N [N ...]]

Runs one turn per checkout -- each ROOT, then this checkout -- and then
the same turns in reverse order (A, B, B, A for one ROOT), `rounds` times
over (default 1), each turn in
its own process, which imports that checkout's ``epgpy_torch``
(building its CUDA kernels from that checkout's sources) and its
``chip_smoke.py`` input makers, and times by CUDA events (best of `reps`
after one warm-up, ``chip_smoke._cuda_ms``) at the main-path shapes:

* ``fisp_jac``: the FISP headline train, 102,400 atoms x 1000 pulses,
  nstate 10 (``chip_smoke.make_train`` / ``make_atoms``);
* ``fisp_jac`` with the dD group: the same train with DW-FISP's
  attenuation (``chip_smoke.DWF_KVALUE``'s b-value bases, D 1e-3);
* ``megre_jac``: 262,144 atoms x 200 TRs x 3 echoes, nstate 8
  (``chip_smoke.make_megre_case``);
* ``fisp_hess``: the flagship per-pulse Hessian, 256 atoms x 400 pulses,
  nstate 10, second order (``chip_smoke.flagship_train`` /
  ``design_atoms``);
* ``composite_jac``: the MPRAGE Jacobian of ``chip_smoke.py`` 4o, 102,400
  atoms x 156 stages, nstate 8, all four groups (``comp_jac_draws`` /
  ``comp_jac_sequence`` through ``fisp_dispatch.match_composite``);
* ``xgre_jac``: the qMT fit's Jacobian, 262,144 voxels x 48 TRs, two pools,
  two variables, nstate 10, at the fit's true (f, T2f) draws
  (``chip_smoke.qmt_problem`` / ``qmt_jac_args``): the wrapper call and,
  by CUDA events around the launch (``chip_smoke._launch_ms``), the
  kernel alone;
* ``dess_jac``: the DESS mapping train, 262,144 voxels x 48 TRs, nstate 8
  (``chip_smoke.dess_truth`` / ``dess_map_sequence`` through
  ``fisp_dispatch.match_dess``): the wrapper call and the kernel alone;
* ``cpmg``: the published 18-echo CPMG train at 640,000 signals, nstate
  36 (``chip_smoke.mse_grid`` / ``mse_kernel_args`` at ``MSE_SCALED``),
  and the same with DW-TSE attenuation on both stages (b-value bases 3,
  4, 5, 6, D 1e-3): the wrapper call (one launch, nothing around it);
* ``xcomposite_jac``: the exchange-rate fit's Jacobian, 65,536 voxels x
  156 stages, two pools, one variable, nstate 8, four table entries, at
  the fit's truth (``chip_smoke.phase_kfit``'s arguments): the wrapper
  call and the kernel alone;
* ``fisp_half``: the FISP dictionary of the headline train, 102,400 atoms
  x 1000 pulses, nstate 10; ``fisp_half_dw`` the same with DW-FISP's
  attenuation (the ``fisp_jac`` dD group's b-value bases, D 1e-3): the
  wrapper call and the kernel alone;
* ``composite``: the cardiac MRF dictionary, 127,988 atoms x 275 stages,
  nstate 10 (``chip_smoke.cardiac_grid`` / ``cardiac_train`` through
  ``fisp_dispatch.match_composite``), and the MPRAGE mapping's truth train
  over its 262,144 voxels, nstate 8 (``chip_smoke.mprage_train``): the
  wrapper calls and the kernel alone;
* ``xgre``: the bench's spoiled MT-GRE train, 262,144 atoms x 100 TRs, two
  pools, nstate 10 (``chip_smoke.xgre_bench_sequence`` through
  ``fisp_dispatch.match_xgre``, as ``phase_xgre_path``); ``xgre_bssfp``
  its balanced train, 163,840 atoms x 200 TRs, nstate 0
  (``xbssfp_bench_sequence``, as ``phase_xbssfp_path``); ``xcomposite``
  the MT-prepared train, 131,072 atoms x 108 stages, nstate 8
  (``xcomp_bench_sequence`` through ``fisp_dispatch.match_xcomposite``, as
  ``phase_xcomp_path``): the wrapper calls and the kernel alone;
* ``megre``: the bench's ME-GRE train, 262,144 atoms x 200 TRs x 3
  echoes, nstate 8 (``chip_smoke.megre_atoms`` / ``megre_sequence``
  through ``fisp_dispatch.match_megre``, as ``phase_megre_path``: TR and
  echo times repeat every TR), and ``megre_var`` the option case of
  ``chip_smoke.make_megre_case`` at the same shape (TR and RF phase
  drawn per TR); ``bssfp``: the bench's IR-prepped bSSFP train, 163,840
  atoms x 500 pulses (``chip_smoke.bssfp_atoms`` /
  ``bssfp_bench_sequence`` through ``fisp_dispatch.match_bssfp``, as
  ``phase_bssfp_path``: TR varies every pulse): the wrapper calls and
  the kernel alone;
* ``fisp_full``: ``fisp_dictionary_cuda(nstate=0)`` on the FISP headline
  train's matched parameters, 102,400 atoms x 1000 pulses
  (``chip_smoke.fisp_sequence`` through ``fisp_dispatch.match_fisp``, as
  ``phase_full_path``: TR and TE repeat every pulse); ``dess``: the DESS
  mapping train, 262,144 voxels x 48 TRs, nstate 8 (``chip_smoke.
  dess_truth`` / ``dess_map_sequence`` through ``fisp_dispatch.
  match_dess``): the wrapper calls and the kernel alone.

``--kernels`` times only the named ones (default: all).  ``--fits`` also
runs, twice per turn, the end-to-end fits and calls that take the chosen
kernels -- the qMT (f, T2f) fit (``chip_smoke.phase_qmt_fit``: match and
8 Gauss-Newton iterations) for ``xgre_jac``, the DESS T1/T2 mapping
(``chip_smoke.phase_dess_mapping``: 10 iterations) for ``dess_jac``, the
exchange-rate fit (``chip_smoke.phase_kfit``: 8 iterations) for
``xcomposite_jac``, the CPMG T2/B1 mapping (``chip_smoke.phase_t2b1``:
dictionary, match and Gauss-Newton) for ``cpmg``, the memoized
``simulate()`` of the FISP dictionary for ``fisp_half`` and of DW-FISP's
for ``fisp_half_dw``, the memoized ``simulate(density=)`` of each EPG-X
train for ``xgre``, ``xgre_bssfp`` and ``xcomposite``, and for
``composite`` the memoized cardiac MRF
``simulate()``, the MPRAGE T1 mapping (``chip_smoke.
phase_mprage_mapping``) and the cardiac MRF T1/T2 mapping
(``phase_cardiac_mapping``), for ``megre`` the memoized ME-GRE
``simulate()`` and the T2/B0 mapping (``chip_smoke.phase_b0_mapping``: 8
iterations) and for ``bssfp`` the memoized bSSFP ``simulate()`` and the
bSSFP MRF serving (``chip_smoke.phase_bssfp_serving``: 4 starts x 10
Gauss-Newton iterations), for ``dess`` the memoized DESS mapping train's
``simulate()`` and the DESS T1/T2 mapping -- and keeps the second run's
host-clock times, in ms.

Two knobs time the primal kernels' geometry: ``--blocks N [N ...]`` times
``fisp_half`` and ``composite`` of a checkout whose kernels run one thread
per atom at N threads per block (its wrappers' ``block_size``), and
``--rows R [R ...]`` those of a checkout on the segmented layout at R rows
per lane (its ``half_rows``, in both wrappers' modules), and ``xgre``,
``xgre_bssfp`` and ``xcomposite`` at R rows per lane where the checkout's
EPG-X primal kernels are segmented (``x_rows`` of ``cuda_xgre`` and
``cuda_xcomposite``; a ladder longer than one lane holds takes R above 12
/ C / 2 rows, 4-6 at two pools), each beside the committed choice.
``--nstates N [N ...]`` also times ``xgre``'s MT-GRE train cut at each
ladder depth N (keys ``xgre_nN``), at the committed rows and at each R.
``--rows`` also times ``megre`` at R rows per lane where the checkout's
primal ME-GRE kernel is segmented (its ``megre_rows``), and ``--nstates``
its bench train at each ladder depth N (keys ``megre_nN``), at the
committed rows and at each R the kernel has an instance for: a ladder of
R rows on one lane, or R >= 7 across lanes (the rows ``megre_rows`` can
give a ladder longer than one lane holds).

Each turn prints one JSON line with its times and the kernels' ptxas lines
(registers, stack frame) where it built them; the last lines give the
card's name and power limit and, per checkout, the mean, least and
greatest of each time over its turns.
Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {"fisp": (102400, 1000), "megre": (262144, 200)}


KERNELS = ("fisp_jac", "megre_jac", "fisp_hess", "composite_jac",
           "xgre_jac", "dess_jac", "cpmg", "xcomposite_jac", "fisp_half",
           "fisp_half_dw", "composite", "xgre", "xgre_bssfp", "xcomposite",
           "megre", "bssfp", "fisp_full", "dess")


def turn(root, reps, kernels, fits, blocks=(), rows=(), nstates=()):
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    import epgpy_torch as epg
    from epgpy_torch import _build, fisp_dispatch
    from epgpy_torch.models import cuda_dess, cuda_mse, cuda_xcomposite, \
        cuda_xgre

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    dev = "cuda"
    epg.config.set_device(dev)
    epg.config.set_precision("float32")
    out = {"root": root}
    if "xgre_jac" in kernels:
        train, stage = cs.qmt_problem(torch, epg)
        rng = np.random.default_rng(17)
        f = torch.as_tensor(rng.uniform(0.08, 0.28, cs.QMT_NVOX),
                            dtype=torch.float32, device=dev)
        t2 = torch.as_tensor(rng.uniform(45.0, 115.0, cs.QMT_NVOX),
                             dtype=torch.float32, device=dev)
        xargs = cs.qmt_jac_args(torch, train, stage, f, t2)

        def xcall():
            return cuda_xgre.xgre_jacobian_echoes(*xargs,
                                                  nstate=cs.QMT_NSTATE)
        out["xgre_jac_ms"] = cs._cuda_ms(torch, xcall, reps)
        out["xgre_jac_kernel_ms"] = cs._launch_ms(torch, xcall,
                                                  "epg_xgre_jac", reps)
        del xargs
    if "dess_jac" in kernels:
        T1, T2, _, _ = cs.dess_truth()
        dargs = cs._match_args(fisp_dispatch, fisp_dispatch.match_dess(
            cs.dess_map_sequence(epg, T1, T2)))

        def dcall():
            return cuda_dess.dess_jacobian_echoes(*dargs,
                                                  nstate=cs.DESS_NSTATE)
        out["dess_jac_ms"] = cs._cuda_ms(torch, dcall, reps)
        out["dess_jac_kernel_ms"] = cs._launch_ms(torch, dcall,
                                                  "epg_dess_jac", reps)
        del dargs
    if "cpmg" in kernels:
        T2s, atts = cs.mse_grid(*cs.MSE_SCALED)
        margs = cs.mse_kernel_args(torch, T2s, atts)
        dc = torch.full((margs[5].shape[0],), 1e-3, device=dev)
        for key, kw in (("cpmg_ms", {}), ("cpmg_dw_ms", dict(
                diffusion=(3.0, 4.0, 5.0, 6.0, dc, dc)))):
            out[key] = cs._cuda_ms(torch, lambda kw=kw: cuda_mse.cpmg_echoes(
                *margs, nstate=cs.MSE_NSTATE, **kw), reps)
        del margs
    if "xcomposite_jac" in kernels:
        kf = cs.phase_kfit(torch, epg)

        def kcall():
            return cuda_xcomposite.xcomposite_jacobian_echoes(*kf["args"],
                                                              **kf["kw"])
        out["xcomposite_jac_ms"] = cs._cuda_ms(torch, kcall, reps)
        out["xcomposite_jac_kernel_ms"] = cs._launch_ms(
            torch, kcall, "epg_xcomposite_jac", reps)
    if fits:
        for _ in range(2):      # the first run warms the host paths
            if "xgre_jac" in kernels:
                q = cs.phase_qmt_fit(torch, epg)
                out["qmt_match_ms"] = 1e3 * q["match_s"]
                out["qmt_gn_ms"] = 1e3 * q["gn_s"]
                del q
            if "dess_jac" in kernels:
                out["dess_map_gn_ms"] = 1e3 * cs.phase_dess_mapping(
                    torch, epg)["gn_s"]
            if "xcomposite_jac" in kernels:
                out["kfit_gn_ms"] = 1e3 * cs.phase_kfit(torch, epg)["gn_s"]
            if "cpmg" in kernels:
                m = cs.phase_t2b1(torch, epg)
                out["t2b1_dict_ms"] = 1e3 * m["dict_s"]
                out["t2b1_gn_ms"] = 1e3 * m["gn_s"]
    _fisp_family(root, reps, kernels, out)
    _primal(root, reps, kernels, fits, out, blocks, rows)
    _xprimal(reps, kernels, fits, out, rows, nstates)
    _ssfp_primal(reps, kernels, fits, out, rows, nstates)
    _full_dess(reps, kernels, fits, out)
    log = _build.build_info()["log"].splitlines()
    out["ptxas"] = [f"{a.split('for')[-1].strip()[-48:]}: {b.strip()}; "
                    f"{c.strip()}"
                    for a, b, c in zip(log, log[1:], log[2:])
                    if "Function properties" in a
                    and any(k in a for k in ("fisp_jac", "megre_jac",
                                             "hess_", "composite_jac",
                                             "xgre_jac", "dess_jac",
                                             "cpmg_kernel", "xcomp_jac",
                                             "fisp_half_kernel",
                                             "composite_kernel",
                                             "xgre_kernel", "xcomp_kernel",
                                             "megre_kernel",
                                             "bssfp_kernel", "fisp_full",
                                             "dess_kernel"))]
    out["build_s"] = _build.build_info()["seconds"]
    print(json.dumps(out))


def _fisp_family(root, reps, kernels, out):
    """The first four kernels' times into `out`."""
    import numpy as np
    import torch

    import chip_smoke as cs
    import epgpy_torch as epg
    from epgpy_torch import fisp_dispatch
    from epgpy_torch.models import (cuda_composite, cuda_fisp, cuda_hessian,
                                    cuda_megre)

    dev = "cuda"
    natoms, npulse = SHAPES["fisp"]
    P = npulse
    FA = cs.make_train(P)
    T1, T2, B1 = cs.make_atoms(natoms)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    fargs = (t(FA), t(np.full(P, 90.0)), t(np.full(P, cs.TR)), cs.TE,
             t(T1), t(T2), t(B1), None)
    # the DW-FISP attenuation of the chip_smoke train: b-value bases
    # k^2 tau (k in rad/mm, tau in s), D 1e-3 mm^2/s
    b = (cs.DWF_KVALUE * 1e-3) ** 2 * cs.DWF_TAU * 1e-3
    dkw = dict(diffusion=(b, b, cs.DWF_D), diff_ramp=True,
               track_diffusivity=True)
    if "fisp_jac" in kernels:
        out["fisp_jac_ms"] = cs._cuda_ms(
            torch, lambda: cuda_fisp.fisp_jacobian_echoes(*fargs, nstate=10),
            reps)
        out["fisp_jac_dD_ms"] = cs._cuda_ms(
            torch, lambda: cuda_fisp.fisp_jacobian_echoes(*fargs, nstate=10,
                                                          **dkw), reps)
    if "megre_jac" in kernels:
        margs, mkw = cs._tensors(torch, *cs.make_megre_case(
            dict(m=3, nstate=8), SHAPES["megre"][0], SHAPES["megre"][1]),
            dev)
        out["megre_jac_ms"] = cs._cuda_ms(
            torch, lambda: cuda_megre.megre_jacobian_echoes(*margs, **mkw),
            reps)
        del margs
    if "fisp_hess" in kernels:
        hFA, hTAU = cs.flagship_train()
        hT1, hT2 = cs.design_atoms()
        hargs = (t(hFA), 90.0, t(hTAU), t(hT1), t(hT2))
        out["fisp_hess_ms"] = cs._cuda_ms(
            torch, lambda: cuda_hessian.fisp_hessian_cuda(*hargs, nstate=10),
            reps)
    if "composite_jac" in kernels:
        params = fisp_dispatch.match_composite(
            cs.comp_jac_sequence(epg, *cs.comp_jac_draws()), 1.0)
        cargs, ckw = fisp_dispatch._comp_call(params, cs.COMPJ_NSTATE)
        out["composite_jac_ms"] = cs._cuda_ms(
            torch, lambda: cuda_composite.composite_jacobian_echoes(*cargs,
                                                                    **ckw),
            reps)


def _primal(root, reps, kernels, fits, out, blocks, rows):
    """The primal kernels' times into `out`: ``fisp_half`` (and DW-FISP's)
    and ``composite`` (cardiac MRF and MPRAGE) at the committed geometry,
    then at each of `blocks` threads per block (a thread-per-atom
    checkout) or each of `rows` rows per lane (a segmented one); with
    `fits`, the end-to-end calls that take them."""
    import numpy as np
    import torch

    import chip_smoke as cs
    import epgpy_torch as epg
    from epgpy_torch import fisp_dispatch
    from epgpy_torch.models import cuda_composite, cuda_fisp

    want = [k for k in ("fisp_half", "fisp_half_dw", "composite")
            if k in kernels]
    if not want:
        return
    dev = "cuda"
    natoms, P = SHAPES["fisp"]
    T1, T2, B1 = cs.make_atoms(natoms)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    fargs = (t(cs.make_train(P)), t(np.full(P, 90.0)), t(np.full(P, cs.TR)),
             cs.TE, t(T1), t(T2), t(B1), None)
    b = (cs.DWF_KVALUE * 1e-3) ** 2 * cs.DWF_TAU * 1e-3
    calls = {}
    if "fisp_half" in want:
        calls["fisp_half"] = (lambda: cuda_fisp.fisp_echoes(
            *fargs, nstate=cs.NSTATE), "epg_fisp_half")
    if "fisp_half_dw" in want:
        calls["fisp_half_dw"] = (lambda: cuda_fisp.fisp_echoes(
            *fargs, nstate=cs.NSTATE, diffusion=(b, b, cs.DWF_D),
            diff_ramp=True), "epg_fisp_half")
    if "composite" in want:
        grid = cs.cardiac_grid()
        cseq = cs.cardiac_train(epg, grid[:, 0], grid[:, 1])
        cargs, ckw = fisp_dispatch._comp_call(
            fisp_dispatch.match_composite(cseq), cs.CMRF_NSTATE)
        rng = np.random.default_rng(cs.MPR_SEED)
        mseq = cs.mprage_train(epg, rng.uniform(350.0, 2900.0, cs.MPR_NVOX),
                               rng.uniform(55.0, 140.0, cs.MPR_NVOX))
        margs, mkw = fisp_dispatch._comp_call(
            fisp_dispatch.match_composite(mseq), cs.MPR_NSTATE)
        calls["composite"] = (lambda: cuda_composite.composite_echoes(
            *cargs, **ckw), "epg_composite")
        calls["composite_mprage"] = (lambda: cuda_composite.composite_echoes(
            *margs, **mkw), "epg_composite")

    def time_all(tag):
        for key, (fn, symbol) in calls.items():
            out[f"{key}{tag}_ms"] = cs._cuda_ms(torch, fn, reps)
            out[f"{key}{tag}_kernel_ms"] = cs._launch_ms(torch, fn, symbol,
                                                         reps)

    time_all("")
    segmented = hasattr(cuda_fisp, "half_rows")
    if blocks and not segmented:
        size_f, size_c = cuda_fisp.block_size, cuda_composite.block_size
        try:
            for n in blocks:
                cuda_fisp.block_size = cuda_composite.block_size = (
                    lambda nstate, n=n: n)
                time_all(f"_block{n}")
        finally:
            cuda_fisp.block_size, cuda_composite.block_size = size_f, size_c
    if rows and segmented:
        rows_of = cuda_fisp.half_rows
        try:
            for r in rows:
                cuda_fisp.half_rows = cuda_composite.half_rows = (
                    lambda n, r=r: r)
                time_all(f"_rows{r}")
        finally:
            cuda_fisp.half_rows = cuda_composite.half_rows = rows_of
    if not fits:
        return
    for _ in range(2):      # the first run warms the host paths
        if "fisp_half" in want:
            seq = cs.fisp_sequence(epg, cs.make_train(P), T1, T2, B1)
            out["fisp_simulate_ms"] = 1e3 * cs._host_s(
                torch, lambda: epg.simulate(seq, max_nstate=cs.NSTATE,
                                            asarray=False))
        if "fisp_half_dw" in want:
            dseq = cs.dwfisp_sequence(epg, cs.make_train(P), T1, T2, B1)
            out["dwfisp_simulate_ms"] = 1e3 * cs._host_s(
                torch, lambda: epg.simulate(dseq, max_nstate=cs.NSTATE,
                                            asarray=False,
                                            kvalue=cs.DWF_KVALUE))
        if "composite" in want:
            out["cardiac_simulate_ms"] = 1e3 * cs._host_s(
                torch, lambda: epg.simulate(cseq, max_nstate=cs.CMRF_NSTATE,
                                            asarray=False))
            mpr = cs.phase_mprage_mapping(torch, epg)
            out["mprage_map_gn_ms"] = 1e3 * mpr["gn_s"]
            comp = dict(grid=grid, dictionary=epg.simulate(
                cseq, max_nstate=cs.CMRF_NSTATE, asarray=False))
            cmrf = cs.phase_cardiac_mapping(torch, epg, comp)
            out["cardiac_map_gn_ms"] = 1e3 * cmrf["gn_s"]
            del comp


def _xprimal(reps, kernels, fits, out, rows, nstates=()):
    """The primal EPG-X kernels' times into `out`: ``xgre`` (the spoiled
    MT-GRE train, also at each ladder depth of `nstates`), ``xgre_bssfp``
    (its balanced train) and ``xcomposite`` (the MT-prepared train) at the
    committed geometry, then at each of `rows` rows per lane where the
    checkout's kernels are segmented; with `fits`, the memoized
    ``simulate(density=)`` of each train."""
    import numpy as np
    import torch

    import chip_smoke as cs
    import epgpy_torch as epg
    from epgpy_torch import fisp_dispatch
    from epgpy_torch.models import cuda_xcomposite, cuda_xgre

    want = [k for k in ("xgre", "xgre_bssfp", "xcomposite") if k in kernels]
    if not want:
        return
    calls, sims = {}, {}
    if "xgre" in want:
        seq = cs.xgre_bench_sequence(
            epg, np.linspace(40.0, 120.0, cs.XGRE_ATOMS))
        dens = list(cs.XGRE_DENS)
        params = fisp_dispatch.match_xgre(seq, (2, cs.XGRE_ATOMS), dens)
        for key, ns in [("xgre", cs.XGRE_NSTATE)] + [
                (f"xgre_n{n}", n) for n in nstates]:
            args, kw = cs._xgre_args(fisp_dispatch, params, ns)
            calls[key] = (
                lambda a=args, k=kw: cuda_xgre.xgre_dictionary_echoes(*a, **k),
                "epg_xgre")
        sims["xgre"] = (seq, dict(max_nstate=cs.XGRE_NSTATE, density=dens))
    if "xgre_bssfp" in want:
        FA, _, T2 = cs.families_draws(cs.XBSSFP_ATOMS)
        seq = cs.xbssfp_bench_sequence(epg, T2, FA)
        args, kw = cs._xgre_args(fisp_dispatch, fisp_dispatch.match_xgre(
            seq, (2, cs.XBSSFP_ATOMS), [0.85, 0.15]), 0)
        calls["xgre_bssfp"] = (
            lambda a=args, k=kw: cuda_xgre.xgre_dictionary_echoes(*a, **k),
            "epg_xgre")
        sims["xgre_bssfp"] = (seq, dict(density=[0.85, 0.15]))
    if "xcomposite" in want:
        FA, _, T2 = cs.families_draws(cs.XCOMP_NAT)
        T2f = np.concatenate([T2, T2])
        seq = cs.xcomp_bench_sequence(epg, T2f, FA)
        params = fisp_dispatch.match_xcomposite(seq, (2, len(T2f)),
                                                [0.85, 0.15])
        args, d, kw = fisp_dispatch._xcomp_call(params, cs.XCOMP_NSTATE)
        args = args + (params["taus"], params["khi"], d["T1"], d["T2"],
                       d["g"], d["B1"], d["b1u"])
        calls["xcomposite"] = (
            lambda a=args, k=kw: cuda_xcomposite.xcomposite_echoes(*a, **k),
            "epg_xcomposite")
        sims["xcomposite"] = (seq, dict(max_nstate=cs.XCOMP_NSTATE,
                                        density=[0.85, 0.15]))

    def time_all(tag):
        for key, (fn, symbol) in calls.items():
            out[f"{key}{tag}_ms"] = cs._cuda_ms(torch, fn, reps)
            out[f"{key}{tag}_kernel_ms"] = cs._launch_ms(torch, fn, symbol,
                                                         reps)

    time_all("")
    if rows and hasattr(cuda_xgre, "x_rows"):
        rows_of = cuda_xgre.x_rows
        try:
            for r in rows:
                cuda_xgre.x_rows = cuda_xcomposite.x_rows = (
                    lambda n, C, r=r: r)
                time_all(f"_rows{r}")
        finally:
            cuda_xgre.x_rows = cuda_xcomposite.x_rows = rows_of
    if not fits:
        return
    for _ in range(2):      # the first run warms the host paths
        for key, (seq, skw) in sims.items():
            out[f"{key}_simulate_ms"] = 1e3 * cs._host_s(
                torch, lambda: epg.simulate(seq, asarray=False, **skw))


def _ssfp_primal(reps, kernels, fits, out, rows, nstates=()):
    """The primal ME-GRE and bSSFP kernels' times into `out`: ``megre``
    (the bench's train; at each ladder depth of `nstates` too) and
    ``megre_var`` (TR and phase per TR), ``bssfp`` (the bench's train) at
    the committed geometry, then ``megre`` at each
    of `rows` rows per lane where the checkout's kernel is segmented; with
    `fits`, the memoized ``simulate()`` of both trains, the T2/B0 mapping
    and the bSSFP MRF serving."""
    import torch

    import chip_smoke as cs
    import epgpy_torch as epg
    from epgpy_torch import fisp_dispatch
    from epgpy_torch.models import cuda_bssfp, cuda_megre

    want = [k for k in ("megre", "bssfp") if k in kernels]
    if not want:
        return
    calls, sims, depth = {}, {}, {}
    if "megre" in want:
        FA, T1, T2, DF = cs.megre_atoms(cs.MEGRE_ATOMS)
        seq = cs.megre_sequence(epg, FA, T1, T2, DF)
        margs = cs._match_args(fisp_dispatch, fisp_dispatch.match_megre(seq))
        for key, ns in [("megre", cs.MEGRE_NSTATE)] + [
                (f"megre_n{n}", n) for n in nstates]:
            depth[key] = ns
            calls[key] = (lambda ns=ns: cuda_megre.megre_echoes(
                *margs, nstate=ns), "epg_megre")
        vargs, vkw = cs._tensors(torch, *cs.make_megre_case(
            dict(m=3, nstate=cs.MEGRE_NSTATE), *SHAPES["megre"]), "cuda")
        calls["megre_var"] = (lambda: cuda_megre.megre_echoes(*vargs, **vkw),
                              "epg_megre")
        sims["megre"] = (seq, dict(max_nstate=cs.MEGRE_NSTATE))
    if "bssfp" in want:
        T1b, T2b, DFb = cs.bssfp_atoms(cs.BSSFP_ATOMS)
        bseq = cs.bssfp_bench_sequence(epg, T1b, T2b, DFb)
        bargs = cs._match_args(fisp_dispatch, fisp_dispatch.match_bssfp(bseq))

        def bcall():
            return cuda_bssfp.bssfp_echoes(*bargs, demodulate=True,
                                           inversion=cs.BSSFP_TI)
        calls["bssfp"] = (bcall, "epg_bssfp")
        sims["bssfp"] = (bseq, {})

    def time_all(tag, keys):
        for key in keys:
            fn, symbol = calls[key]
            out[f"{key}{tag}_ms"] = cs._cuda_ms(torch, fn, reps)
            out[f"{key}{tag}_kernel_ms"] = cs._launch_ms(torch, fn, symbol,
                                                         reps)

    time_all("", list(calls))
    if rows and "megre" in want and hasattr(cuda_megre, "megre_rows"):
        rows_of = cuda_megre.megre_rows
        keys = [k for k in calls if k.startswith("megre")
                and k != "megre_var"]
        try:
            for r in rows:
                cuda_megre.megre_rows = lambda n, r=r: r
                time_all(f"_rows{r}", [
                    k for k in keys if r == max(depth[k], 1) + 1
                    or r >= cuda_megre.MEGRE_MAX_ROWS // 2 + 1])
        finally:
            cuda_megre.megre_rows = rows_of
    if not fits:
        return
    for _ in range(2):      # the first run warms the host paths
        for key, (sseq, skw) in sims.items():
            out[f"{key}_simulate_ms"] = 1e3 * cs._host_s(
                torch, lambda: epg.simulate(sseq, asarray=False, **skw))
        if "megre" in want:
            out["b0_map_gn_ms"] = 1e3 * cs.phase_b0_mapping(torch,
                                                            epg)["gn_s"]
        if "bssfp" in want:
            out["mrf_bssfp_gn_ms"] = 1e3 * cs.phase_bssfp_serving(
                torch, epg)["gn_s"]


def _full_dess(reps, kernels, fits, out):
    """The full-ladder kernel's and the primal DESS kernel's times into
    `out`: ``fisp_full`` (the dictionary's nstate-0 route on the FISP
    headline train) and ``dess`` (the DESS mapping train), the wrapper
    calls and the kernels alone; with `fits`, the memoized ``simulate()``
    of the DESS mapping train and the DESS T1/T2 mapping."""
    import torch

    import chip_smoke as cs
    import epgpy_torch as epg
    from epgpy_torch import fisp_dispatch
    from epgpy_torch.models import cuda_dess, cuda_fisp

    calls, dseq = {}, None
    if "fisp_full" in kernels:
        natoms, P = SHAPES["fisp"]
        T1, T2, B1 = cs.make_atoms(natoms)
        fseq = cs.fisp_sequence(epg, cs.make_train(P), T1, T2, B1)
        fargs = cs._match_args(fisp_dispatch, fisp_dispatch.match_fisp(fseq))
        calls["fisp_full"] = (lambda: cuda_fisp.fisp_dictionary_cuda(
            *fargs, nstate=0), "epg_fisp_full")
    if "dess" in kernels:
        T1, T2, _, _ = cs.dess_truth()
        dseq = cs.dess_map_sequence(epg, T1, T2)
        dargs = cs._match_args(fisp_dispatch, fisp_dispatch.match_dess(dseq))
        calls["dess"] = (lambda: cuda_dess.dess_echoes(
            *dargs, nstate=cs.DESS_NSTATE), "epg_dess")
    for key, (fn, symbol) in calls.items():
        out[f"{key}_ms"] = cs._cuda_ms(torch, fn, reps)
        out[f"{key}_kernel_ms"] = cs._launch_ms(torch, fn, symbol, reps)
    if not fits or dseq is None:
        return
    for _ in range(2):      # the first run warms the host paths
        out["dess_simulate_ms"] = 1e3 * cs._host_s(
            torch, lambda: epg.simulate(dseq, max_nstate=cs.DESS_NSTATE,
                                        asarray=False))
        out["dess_map_gn_ms"] = 1e3 * cs.phase_dess_mapping(torch,
                                                            epg)["gn_s"]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--kernels", nargs="+", choices=KERNELS,
                    default=list(KERNELS))
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--fits", action="store_true")
    ap.add_argument("--blocks", nargs="*", type=int, default=[])
    ap.add_argument("--rows", nargs="*", type=int, default=[])
    ap.add_argument("--nstates", nargs="*", type=int, default=[])
    ap.add_argument("--turn", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.turn:
        turn(os.path.abspath(a.roots[0]), a.reps, a.kernels, a.fits,
             a.blocks, a.rows, a.nstates)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    order = [os.path.abspath(r) for r in a.roots] + [HERE]
    runs = {}
    for root in (order + order[::-1]) * a.rounds:
        r = subprocess.run([sys.executable, os.path.abspath(__file__), root,
                            "--turn", "--reps", str(a.reps), "--kernels",
                            *a.kernels] + ["--fits"] * a.fits
                           + ["--blocks", *map(str, a.blocks)]
                           + ["--rows", *map(str, a.rows)]
                           + ["--nstates", *map(str, a.nstates)],
                           capture_output=True, text=True, cwd=root)
        if r.returncode != 0:
            print(r.stdout[-3000:], r.stderr[-3000:])
            raise SystemExit(f"turn in {root} failed")
        line = r.stdout.strip().splitlines()[-1]
        print(line)
        runs.setdefault(root, []).append(json.loads(line))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card)
    for root, rs in runs.items():
        keys = [k for k in rs[0] if k.endswith("_ms")]
        print(json.dumps({"root": root, "card": card, "turns": len(rs),
                          "mean_ms": {k: sum(r[k] for r in rs) / len(rs)
                                      for k in keys},
                          "min_ms": {k: min(r[k] for r in rs) for k in keys},
                          "max_ms": {k: max(r[k] for r in rs)
                                     for k in keys}}))


if __name__ == "__main__":
    main()
