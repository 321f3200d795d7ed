#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (epgpy_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each raises on failure: a failure exits non-zero with no result):

1. environment: the card's name and power limit, torch/CUDA versions,
   nvcc; requires a CUDA device;
2. build: compiles the kernel library from epgpy_torch/csrc into
   build/epgpy_torch/ (first use) and loads it;
3. the FISP kernel against its plain PyTorch twin on the card, over a
   covering set of option cases at 4096 atoms x 300 pulses (plus one
   case at nstate 40, beyond 48 KB of shared memory per block);
3b. the same for the FISP Jacobian kernel (fingerprints + dS/dT1, dT2,
   dB1[, dD]) at 80 pulses, per tangent column relative to the column's
   largest value;
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
5. (printed with 6) the FISP numbers: simulate() end to end (first call
   with the host-side match, then memoized) and the general operator loop
   at 4096 atoms x 100 TRs;
5b. serving: 8,192 off-grid voxels (seeded truth, noise 0.002, random
   complex PD) matched against the unnormalized phase-4 dictionary with
   ``parallel.mrf_reconstruct``, then 5 Gauss-Newton iterations whose
   Jacobians come through ``simulate()`` and the Jacobian kernel; the
   refined T1 and T2 RMSE must beat the match-only RMSE;
3c. the per-pulse Hessian kernel against its plain twin over every
   option (4-op/5-op form, inversion, second order, nstate 6/10, phi
   90/30) at 30 TRs x 64 atoms, per output block, and its pulse > echo
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
3d. the CPMG kernel against its plain twin over its options (per-echo
   spacings and phases, B1, DW-TSE stages with and without the ramp term,
   the Jacobian gate's deepest DW ladder) at 4096 atoms x 18 echoes;
3e. the same for the CPMG Jacobian kernel (echoes + dT1, dT2, dB1), also
   at the gate's edge (nstate 74) and at ragged shapes (1, 33 and 4,097
   atoms, a one-echo train);
3f. the per-echo design kernel against its twin, first and second order,
   32 echoes, nstate 64, the gates' edges (168 second order, 386 first)
   and ragged shapes (1, 33 and 4,097 atoms; 1, 13 and 33 echoes), per
   output block, variable > echo entries exactly zero;
4d. the published CPMG train (bench.py:563-594) through ``simulate()`` at
   100 T2 x 50 attenuations and at 200 x 3200 (640,000 signals), the
   latter also through ``cpmg_dictionary_cuda``; 8 signals of each against
   the float64 general path;
4e. its Jacobian (E ops tracking T1, T2) through ``simulate(probe=[ADC,
   Jacobian(["magnitude", "T1", "T2"])])`` on the 640,000 grid, against the
   float64 general diff path per column;
4f. a DW-TSE train (one D after each shift, ``kvalue`` set) through
   ``simulate()``, against the float64 general path;
5d. T2/B1 mapping (examples/mse_t2_b1_mapping.py) of 8,192 seeded voxels:
   mono-exponential, a match against a 32,000-atom dictionary and 12
   Gauss-Newton iterations on the CPMG Jacobian kernel; the truth trains,
   the dictionary and the first Jacobian are held against the plain twins
   on the same inputs, and the refined T2 RMSE must beat half the
   mono-exponential's and the match's;
5e. the variable-flip TSE design (examples/optim_tse.py): 60 SLSQP
   iterations of ``tse_design_slsqp`` (one design kernel launch per
   evaluation) under the SAR and flip-step constraints; the designed train
   must keep both and beat the constant train at the same SAR;
3g-3h. the bSSFP and DESS kernels against their twins over every option;
   the primal bSSFP kernel also over TR and TE runs across its 32-pulse
   chunks, inversion with and without df, a large df t (0.5 kHz over
   1,000 ms TRs) and ragged shapes (1-4,097 atoms, 1-33 pulses), each
   launched twice for the same bits;
4g-4i. the bSSFP dictionary (163,840 x 500, golden, drift) and its (T1, T2,
   g) Jacobian, DESS (golden, 262,144-voxel mapping train, Jacobian)
   through ``simulate()``; 5f-5g. bSSFP MRF serving and DESS T1/T2 mapping;
3i. the ME-GRE kernels (primal and (T1, T2, B1, df) Jacobian) against their
   twins over every option (m = 2 and 3, df, demodulation, a per-pulse
   echo-time matrix, a B1 batch, the df group at dfs=None); the primal
   kernel also on both sides of every change of its instance or rows per
   lane up to the gate's nstate 301, at 1-1,000 echoes (past the echo
   factors it holds in registers), over TR and echo-time runs across
   its chunks, ragged shapes and chunk edges, each launched twice for the
   same bits;
3j. the full-ladder FISP kernel against its twin at nstate 0, 10 and 150,
   against the folded kernel, and fisp_dictionary_cuda's nstate-0 route;
4j. the bench's ME-GRE train (200 TRs x 3 echoes) over 262,144 atoms
   through ``simulate()``, 8 atoms against the float64 general path, the
   golden megre.npz train on the card;
4k. its (T2, g)-tracked Jacobian through ``simulate()``;
5h. T2/B0 mapping (examples/megre_t2_b0_mapping.py) of 262,144 voxels:
   the two-echo phase start and 8 Gauss-Newton iterations on the ME-GRE
   Jacobian kernel, held to the example's two RMSE asserts;
4l. the full-ladder kernel on the FISP headline train: the nstate-0
   dictionary against its twin on the same tensors, and the nstate-10
   parity oracle of phase 4's dictionary;
4m. DW-FISP: the FISP headline train with one D after each S(1) through
   ``simulate(kvalue=...)`` and its (T1, T2, Dcoef) Jacobian, against the
   kernels' twins on the same tensors and the float64 general paths;
3k. the composite-GRE kernels (primal and Jacobian) against their twins
   over every option: shifts up, down and mixed, ADC phases, b1u stages,
   df, D stages with ramps -1/0/+1, stages without a readout and neutral
   stages, nstate 1; the Jacobian with no group, each group alone and all
   four;
4n. the cardiac MRF schedule (examples/cardiac_mrf_t1t2.py: 8 beats x 32
   readouts, IR and T2prep preps, 275 stages) over a 127,988-atom (T1, T2)
   dictionary through ``simulate()``, 8 atoms against the float64 general
   path, the golden mprage.npz and cardiac_mrf.npz trains on the card;
4o. an MPRAGE train (6 segments x 24 readouts, adiabatic inversions,
   B1-tracked flips, per-atom df) over 102,400 atoms through
   ``simulate(probe=[ADC, Jacobian([mag, T1, T2, B1, g])])``: the columns
   against the twin (8,192 atoms) and the float64 general diff path;
5i. MPRAGE T1 mapping (examples/mprage_t1_mapping.py) of 262,144 voxels:
   match and 6 Gauss-Newton iterations on the T1 group, the example's two
   asserts;
5j. cardiac MRF T1/T2 mapping (examples/cardiac_mrf_t1t2.py) of 8,192
   voxels against 4n's dictionary, 6 Gauss-Newton iterations of (T1, T2),
   the example's asserts;
3l-3m. the EPG-X GRE and composite EPG-X kernels (primal and, with two
   tangent variables, Jacobian) against their twins over every option:
   spoiled and balanced, one to four pools, two exchange stages, df, a
   rank-1 B1 batch, complex saturation, a deep ladder; MT prep, IR-MT with
   adiabatic stages, shifts up and down, ADC phases, sparse readouts; the
   segmented Jacobian kernels' edges and ragged shapes; the segmented
   primal kernels on both sides of every change of their rows per lane at
   one to four pools up to the gates' deepest ladders, chunk edges,
   identity and non-identity stages, both table modes and ragged shapes,
   and a repeated launch that must give the same bits;
4p. (a) the bench's spoiled two-pool MT-GRE train (bench.py:777-834: 100
   TRs, Graham bound-pool saturation) over 262,144 atoms through
   ``simulate(density=[0.8, 0.2])``, 8 atoms against the float64 general
   path, and (f) the goldens xgre_parity.npz, xbssfp.npz, xcomp_gre.npz
   through the kernels, exchange_gre.npz through the float64 general path
   on the card and the MT rates of mt_rates.npz;
4q. (b) the bench's balanced two-pool train (bench.py:1306-1323, 200 TRs)
   over 163,840 atoms through ``simulate(density=)``;
4r. (c) the bench's segmented MT-prepared train (bench.py:1258-1287: 4 x
   25 readouts) over 131,072 atoms through ``simulate(density=)``, and
   examples/mt_prep_gre.py's MTR asserts at that width;
5k. (d) examples/mt_qmt_fit_refine.py as published at 262,144 voxels:
   match and 8 Gauss-Newton iterations of (f, T2f) on the EPG-X Jacobian
   kernel, the example's asserts;
5l. (e) examples/mt_prep_gre.py's exchange-rate fit at 65,536 voxels on
   the composite EPG-X Jacobian kernel through
   ``parallel.gauss_newton_refine``, k RMSE < 2e-4;
6. numbers for every kernel at its main-path shape: kernel and twin times,
   launches on the main paths, and the bound (the twin's operations,
   counted by ``count_ops`` -- for the CPMG family over only the ladder
   rows each echo has reached, ``reached_ops`` -- over the FP32 peak, or
   the bytes moved over the HBM rate, whichever is longer); ``simulate()``
   first and memoized
   calls, the assembly's device share (``torch.profiler``), the design and
   serving splits; the CPMG Jacobian kernel also at the T2/B1 mapping's
   shape and inside ``simulate()`` by CUDA events, the design kernel also
   at the SLSQP's 4 atoms, and the registers (ptxas), shared memory per
   block and resident warps per SM of both.

Each phase prints its wall time (``[time]``).  The second-to-last lines
are the card's name and power limit and a JSON
object of per-kernel results; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

import cProfile
import contextlib
import json
import math
import os
import pstats
import re
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
#: where the phases put their tensors: the card
DEVICE = "cuda"
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

#: the published CPMG benchmark (bench.py:563-594, reference
#: docs/basics.md:250-267): 18 echoes, TE 9.5 ms, T1 1400 ms, 100 T2
#: (20-60 ms) x 50 attenuations (0.2-1); the scaled grid 200 x 3200;
#: simulate() sizes the train exactly (36 shifts -> nstate 36)
MSE_NECHO, MSE_TE, MSE_T1, MSE_NSTATE = 18, 9.5, 1400.0, 36
MSE_GRID, MSE_SCALED = (100, 50), (200, 3200)
EXC = (90.0, 90.0)
#: the DW-TSE train: one D(TE/2, 2e-3 mm^2/s, k=1) after each shift, a
#: crusher of one phase cycle per 100 um (kvalue in rad/m per state index)
DW_DCOEF, DW_KVALUE = 2e-3, 2 * np.pi / 100e-6
#: T2/B1 mapping (examples/mse_t2_b1_mapping.py): voxels, echoes, echo
#: spacing, Gauss-Newton iterations, noise and seed; the dictionary's
#: 200 T2 (log 10-300 ms) x 160 B1 (0.5-1.0)
MAP_NVOX, MAP_NECHO, MAP_ESP, MAP_ITERS, MAP_NOISE, MAP_SEED = (
    8192, 16, 9.5, 12, 0.003, 11)
MAP_DICT_T2, MAP_DICT_B1 = np.geomspace(10.0, 300.0, 200), \
    np.linspace(0.5, 1.0, 160)
#: the TSE design (examples/optim_tse.py): echoes, spacing, start flip,
#: its 4 tissue atoms, SLSQP iterations, flip-step bound and flip bounds
TSE_NECHO, TSE_ESP, TSE_FA0, TSE_ITERS, TSE_DFA = 32, 8.0, 120.0, 60, 25.0
TSE_T1, TSE_T2 = [800.0, 1200.0, 1600.0, 1100.0], [70.0, 95.0, 140.0, 55.0]
TSE_BOUNDS = (40.0, 180.0)
#: the design's timing grid: TSE_GRID T1 (600-1800) x TSE_GRID T2 (40-200)
TSE_GRID = 64
#: design kernel vs its plain twin, per output block relative to the
#: block's largest magnitude
TOL_DESIGN_KERNEL = 1e-5

#: balanced SSFP (bench.py:686-740): 500 pulses x 163,840 atoms, an
#: inversion prep (TI 18 ms) that precesses with df, sinusoidal flip lobes
#: and TR, alternating RF phase, demodulated readouts, per-atom df
BSSFP_N, BSSFP_ATOMS, BSSFP_TI = 500, 163840, 18.0
#: train lengths of the bSSFP drift curve (float32 path vs the float64
#: general path, 8 atoms), where a growth with the train would show
BSSFP_DRIFT = (48, 100, 200, 500)
#: float32 bSSFP path vs tests/golden/bssfp.npz (the JAX kernel's own
#: limit, tests/test_bssfp_dispatch.py:251; TPU parity 1.92e-5)
TOL_BSSFP_GOLDEN = 2e-5
#: float32 DESS path vs tests/golden/dess.npz (the TPU parity of the JAX
#: kernel, BENCH_r05.json; 1e-6 in interpret mode on the CPU)
TOL_DESS_GOLDEN = 2.14e-6
#: bSSFP MRF serving (examples/mrf_bssfp.py): pulses, the 64 T1 x 64 T2
#: x 40 df grid, compression rank, voxels, Gauss-Newton iterations per
#: start, the example's noise (relative to |PD|) and refinement bounds
MRFB_N, MRFB_GRID, MRFB_RANK = 400, (64, 64, 40), 32
MRFB_NVOX, MRFB_ITERS, MRFB_NOISE = 8192, 10, 2e-3
MRFB_BOUNDS = [(150.0, 2500.0), (15.0, 250.0), (-0.06, 0.06)]
#: DESS T1/T2 mapping (examples/dess_t1t2_mapping.py): TRs, TR, TE, flip
#: scale, ladder depth, voxels (four 256^2 slices), iterations, noise, seed
DESS_NTR, DESS_TR, DESS_TE, DESS_FA, DESS_NSTATE = 48, 18.0, 5.0, 30.0, 8
DESS_NVOX, DESS_ITERS, DESS_NOISE, DESS_SEED = 4 * 256 * 256, 10, 0.0015, 4
#: multi-echo GRE (bench.py:1162-1198): TRs, cumulative echo times, the
#: tail delay (TR 16 ms), ladder depth, its draw seed; four 256^2 slices
#: of atoms instead of the bench's 8,192
MEGRE_N, MEGRE_TES, MEGRE_TAIL, MEGRE_NSTATE, MEGRE_SEED = (
    200, (3.0, 7.0, 11.0), 5.0, 8, 12)
MEGRE_ATOMS = 4 * 256 * 256
#: TRs of the ME-GRE Jacobian's float64 oracle (a prefix of the train)
MEGRE_JAC_N = 50
#: float32 ME-GRE path vs tests/golden/megre.npz (the JAX test's own limit,
#: tests/test_megre_dispatch.py:235)
TOL_MEGRE_GOLDEN = 1e-6
#: T2/B0 mapping (examples/megre_t2_b0_mapping.py): TRs, the two echo
#: times, TR, T1, ladder depth, voxels (four 256^2 slices instead of its
#: 64), Gauss-Newton iterations, noise, seed and its two asserts (T2 RMSE
#: in ms, B0 RMSE in kHz)
B0_NTR, B0_TES, B0_TR, B0_T1, B0_NSTATE = 24, (4.0, 12.0), 22.0, 1200.0, 8
B0_NVOX, B0_ITERS, B0_NOISE, B0_SEED = 4 * 256 * 256, 8, 0.002, 9
B0_LIMITS = (2.0, 2e-4)
#: DW-FISP: the FISP headline train with one D(7 ms, 1e-3 mm^2/s, k=1)
#: after each S(1), at examples/mrf_dw.py:42's kvalue (a 40 mT/m, 7 ms
#: diffusion gradient, rad/m per state index); the float64 Jacobian
#: oracle runs over the train's first DWF_JAC_N pulses, the Jacobian
#: kernel's plain twin over its first DWF_TWIN_ATOMS atoms
DWF_TAU, DWF_D = 7.0, 1e-3
DWF_KVALUE = 2.675e8 * 40e-3 * DWF_TAU * 1e-3
DWF_JAC_N, DWF_TWIN_ATOMS = 200, 8192
#: depth of the twin checks of phases 3b and 3c (pulses), of the FISP
#: dictionary and full-ladder option cases (3, 3j), the bSSFP option cases
#: (3g) and the ME-GRE option cases (3i, TRs): the kernels' own loops are
#: depth-independent, the twins' Python loops are not (cut from 250, 100,
#: 1000, 500 and 200 to hold the script's time as the EPG-X primal edges
#: came in, and from 120, 50, 500, 200 and 100 as the ME-GRE and bSSFP
#: primal edges did); the Hessian edges keep 50 TRs at least
#: (HESS_EDGE_N)
JAC_CASE_N, HESS_CASE_N, CASE_NPULSE = 80, 30, 300
HESS_EDGE_N = 50
SSFP_CASE_N, MEGRE_CASE_N = 120, 60

#: cardiac MRF (examples/cardiac_mrf_t1t2.py as published, Hamilton 2017):
#: heartbeats, readouts per beat, FISP TE and TR, R-R interval (ms), the
#: cycled preparations and the ladder depth; the dictionary grid is 400 T1
#: (300-2000 ms) x 320 T2 (20-250 ms, log-spaced), kept where T2 < 0.8 T1
#: (127,988 atoms), instead of the example's 20 x 16
CMRF_NBEAT, CMRF_NREAD, CMRF_TE, CMRF_TRG, CMRF_RR = 8, 32, 1.4, 5.1, 800.0
CMRF_PREPS = ("ir", None, "t2prep30", "t2prep50", None, "t2prep80")
CMRF_NSTATE, CMRF_GRID, CMRF_EXAMPLE_GRID = 10, (400, 320), (20, 16)
#: cardiac MRF mapping: voxels (the FISP serving width instead of the
#: example's 48), Gauss-Newton iterations, noise and seed
CMRF_NVOX, CMRF_ITERS, CMRF_NOISE, CMRF_SEED = 8192, 6, 3e-4, 23
#: MPRAGE T1 mapping (examples/mprage_t1_mapping.py as published): T1
#: grid, segments, readouts per segment, Gauss-Newton iterations, ladder
#: depth, TI, TD, TE, TR and readout flip; voxels four 256^2 slices instead
#: of its 48; noise and seed
MPR_NT1, MPR_NSEG, MPR_NREAD, MPR_ITERS, MPR_NSTATE = 96, 6, 24, 6, 8
MPR_TI, MPR_TD, MPR_TE, MPR_TRG, MPR_FA = 650.0, 800.0, 3.0, 7.0, 8.0
MPR_NVOX, MPR_NOISE, MPR_SEED = 4 * 256 * 256, 2e-4, 17
#: the composite Jacobian's main path: tests/test_composite_jacobian.py's
#: MPRAGE train (_mprage_ops) at MPR_NSEG segments x MPR_NREAD readouts,
#: every group tracked; atoms, ladder depth, the twin's atoms, the float64
#: oracle's segments (a prefix) and the draw seed
COMPJ_ATOMS, COMPJ_NSTATE, COMPJ_TWIN, COMPJ_F64_SEG, COMPJ_SEED = (
    102400, 8, 8192, 2, 11)
COMPJ_NAMES = ["magnitude", "T1", "T2", "B1", "g"]
#: float32 composite path vs tests/golden/{mprage,cardiac_mrf}.npz (the
#: JAX tests' limit, tests/test_composite_dispatch.py:83, :115)
TOL_COMP_GOLDEN = 2e-6

#: EPG-X, two-pool MT (Malik 2018, Gloor 2008; reference workload
#: epgpy/exchange.py:89-120).  (a) the bench's spoiled MT-GRE train
#: (bench.py:777-834): TRs, atoms (four 256^2 slices, free-pool T2 40-120
#: ms; the bench's 32,768), ladder depth, densities, exchange rate, the X
#: stage's tau, the Graham saturation of a 5 ms, 10 uT pulse 2 kHz off
#: resonance on a super-Lorentzian line of T2 12 us, applied over 5 ms
XGRE_NTR, XGRE_ATOMS, XGRE_NSTATE = 100, 4 * 256 * 256, 10
XGRE_DENS, XGRE_K, XGRE_TAU, XGRE_SATDUR = (0.8, 0.2), 0.005, 10.0, 5.0
#: (b) the bench's balanced two-pool train (bench.py:1306-1323): TRs and
#: atoms (the bSSFP dictionary's width instead of the bench's 8,192)
XBSSFP_NTR, XBSSFP_ATOMS = 200, 163840
#: (c) the bench's segmented MT-prepared train (bench.py:1258-1287): 4
#: segments x 25 readouts over 131,072 atoms (2 x 65,536), nstate 8; the
#: MTR checks of examples/mt_prep_gre.py (6 segments x 24 readouts) at the
#: same width
XCOMP_NAT, XCOMP_NSEG, XCOMP_NSTATE = 65536, 4, 8
MTP_NSEG, MTP_NREAD, MTP_TE, MTP_TRG, MTP_TREC = 6, 24, 2.5, 8.0, 180.0
#: (d) examples/mt_qmt_fit_refine.py as published (NTR 48, nstate 10, 8
#: Gauss-Newton iterations of (f, T2f), noise 2e-4, seed 17) at four
#: 256^2 slices of voxels instead of its 48
QMT_NTR, QMT_NSTATE, QMT_ITERS, QMT_NVOX = 48, 10, 8, 4 * 256 * 256
#: voxels of the fits' Jacobians held against the twins on the card
QMT_TWIN = 8192
#: (e) examples/mt_prep_gre.py's exchange-rate fit (8 Gauss-Newton
#: iterations, noise 2e-4, seed 3): voxels instead of its 64
KFIT_NVOX = 65536
#: float32 EPG-X paths vs tests/golden/{xgre_parity,xbssfp,xcomp_gre}.npz,
#: relative to the golden's largest magnitude (the JAX tests' limit,
#: tests/test_xgre_dispatch.py:71, :477); the float64 general path on the
#: card vs exchange_gre.npz (tests/test_shiftnd.py:444)
TOL_X_GOLDEN, TOL_XCHG_GOLDEN = 2e-6, 1e-9
#: the EPG-X kernels' option cases (primal and, with two tangent
#: variables, Jacobian): spoiled and balanced, one to four pools, two
#: exchange stages, off-resonance, a rank-1 B1 batch, complex saturation,
#: a ladder beyond 48 KB of shared memory per block
XGRE_CASES = [
    dict(name="spoiled"),
    dict(name="balanced_df", balanced=True, g=True, two_stage=True),
    dict(name="two_stage_df", two_stage=True, g=True),
    dict(name="b1_csat", b1=True, csat=True),
    dict(name="three_pools", C=3, two_stage=True, g=True),
    dict(name="one_pool", C=1),
    dict(name="four_pools", C=4),
    dict(name="deep", nstate=40, two_stage=True),
]
#: the composite EPG-X kernels' option cases: MT prep (saturation), IR-MT
#: with adiabatic (b1u = 0) stages beside a B1 batch, balanced, shifts up
#: and down with ADC phases over three pools, sparse readouts with df
XCOMP_CASES = [
    dict(name="mt_prep", sat=True),
    dict(name="ir_b1u", b1u=True),
    dict(name="balanced", shift="none", nstate=1),
    dict(name="mixed_adcph_3", C=3, shift="mixed", adcph=True, sat=True),
    dict(name="sparse_df", shift="mixed", sparse=True, g=True),
    dict(name="all", shift="mixed", adcph=True, sat=True, b1u=True, g=True,
         sparse=True),
]
#: TRs / stages of the EPG-X option cases
XGRE_CASE_N, XCOMP_CASE_N = 60, 80
#: the segmented xgre Jacobian kernel's own edges (V variables, G = V + 1
#: groups), each held against its twin at XGRE_EDGE_SHAPE: the gate's
#: deepest ladders -- (C, G) = (1, 2) at nstate 150 (5 rows per lane),
#: (2, 3) at 49, (4, 3) at 24, (2, 5) at 29 -- the balanced family at four
#: pools (nstate 0: 32 ladders per warp, one warp per block), and a batch
#: whose stage A is the identity with zero tangents for the first half of
#: the atoms and every odd atom after (warps that skip stage A's mix beside
#: warps that hold both kinds)
XGRE_EDGE_CASES = [
    dict(name="gate_c1_g2_n150", C=1, V=1, nstate=150, two_stage=True,
         g=True),
    dict(name="gate_c2_g3_n49", nstate=49, two_stage=True, g=True, b1=True,
         csat=True),
    dict(name="gate_c4_g3_n24", C=4, nstate=24, two_stage=True),
    dict(name="gate_c2_g5_n29", V=4, nstate=29, two_stage=True, g=True),
    dict(name="balanced_c4", C=4, balanced=True, g=True, two_stage=True),
    dict(name="mixed_identity", two_stage=True, g=True, b1=True,
         mixed_identity=True),
]
XGRE_EDGE_SHAPE = (1000, 60)
#: ragged shapes (atoms, TRs) of the xgre Jacobian kernel, each run with
#: XGRE_RAGGED_CASE: 1, 33 and 4,097 atoms, 1 and 2 TRs
XGRE_SHAPES = [(1, 33), (33, 33), (4097, 33), (33, 1), (33, 2)]
XGRE_RAGGED_CASE = dict(name="ragged", two_stage=True, g=True, b1=True,
                        csat=True)
#: the segmented composite EPG-X Jacobian kernel's own edges (V variables,
#: G = V + 1 groups, shifts up, down and none), each held against its twin
#: at XCOMP_EDGE_SHAPE: the gate's deepest ladders -- (C, G) = (1, 2) at
#: nstate 150 (5 rows per lane), (2, 3) at 49, (4, 3) at 24, (2, 5) at 29,
#: (3, 4) at 24 -- and a table of 26 distinct taus at three pools, whose
#: records pass one warp's share of the block (the kernel's global-read
#: mode)
XCOMP_EDGE_CASES = [
    dict(name="gate_c1_g2_n150", C=1, V=1, nstate=150, shift="mixed",
         adcph=True, g=True),
    dict(name="gate_c2_g3_n49", nstate=49, shift="mixed", sat=True,
         b1u=True, g=True),
    dict(name="gate_c4_g3_n24", C=4, nstate=24, shift="mixed", sparse=True),
    dict(name="gate_c2_g5_n29", V=4, nstate=29, shift="mixed", adcph=True,
         g=True),
    dict(name="gate_c3_g4_n24", C=3, V=3, nstate=24, shift="mixed",
         sat=True),
    dict(name="global_taus26", C=3, nstate=4, shift="mixed", ntaus=26,
         adcph=True, sat=True, sparse=True),
]
XCOMP_EDGE_SHAPE = (1000, 80)
#: ragged shapes (atoms, stages) of the composite EPG-X Jacobian kernel,
#: each run with XCOMP_RAGGED_CASE: 1, 33 and 4,097 atoms, 1 and 2 stages
XCOMP_SHAPES = [(1, 33), (33, 33), (4097, 33), (33, 1), (33, 2)]
XCOMP_RAGGED_CASE = dict(name="ragged", shift="mixed", adcph=True, sat=True,
                         b1u=True, g=True, sparse=True)
#: nstates of the segmented primal EPG-X kernels' (xgre.cu, xcomposite.cu)
#: row edges per pool count C: both sides of every change of the rows per
#: lane (cuda_xgre.x_rows: one lane up to 12 / C rows, then the fewest
#: lanes) and the gate's deepest ladder; nstate 0 runs the balanced
#: (unshifted) train
X_ROW_EDGES = {
    1: (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18,
        19, 20, 21, 22, 23, 24, 26, 27, 29, 30, 32, 33, 35, 36, 39, 40,
        43, 44, 47, 48, 49, 50, 54, 55, 59, 60, 65, 66, 71, 72, 76, 77,
        83, 84, 87, 88, 95, 96, 98, 99, 107, 108, 109, 110, 119, 120, 121,
        301),
    2: (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 15, 17, 18, 19, 20,
        23, 24, 25, 150),
    3: (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 99),
    4: (0, 1, 2, 3, 4, 74),
}
#: every option of the primal EPG-X kernels' edges: two exchange stages
#: with df, a B1 batch and complex saturation (xgre); mixed shifts, ADC
#: phases, saturation, b1u, df and stages without a readout (xcomposite)
_XGRE_ALL = dict(two_stage=True, g=True, b1=True, csat=True)
_XCOMP_ALL = dict(shift="mixed", adcph=True, sat=True, b1u=True, g=True,
                  sparse=True)
#: the primal kernels' edges besides the row edges, at X_PRIMAL_ATOMS atoms
#: (XGRE_CASE_N TRs, XCOMP_CASE_N stages unless the case says): chunk
#: edges at 31, 32 and 33 TRs or stages at the main shapes; the gate's
#: deepest ladder at every pool count (C = 1..4: nstate 301, 150, 99, 74)
#: shifted up over H + 10 TRs or stages (the edges above reach row 60 or
#: 80 at most), so that the truncation at row H - 1 and the top lane's
#: shuffle run on state; trains whose
#: exchange stages are all the identity (every mix skipped) and none; the
#: bound pool unflipped and unsaturated (the MT trains' skipped rotations
#: and saturations); the options off (no saturation, ADC phase or b1u,
#: shifts up only); and the composite kernel's
#: device-memory table mode (4 pools: 8 taus on one lane at nstate 2, 26
#: taus on two lanes at nstate 5)
XGRE_PRIMAL_CASES = [
    dict(_XGRE_ALL, name=f"chunk_n{nstate}_tr{n}", nstate=nstate,
         balanced=nstate == 0, ntr=n)
    for nstate in (10, 0) for n in (31, 32, 33)] + [
    dict(name="identity", nstate=10, identity=True, b1=True),
    dict(_XGRE_ALL, name="no_identity", nstate=10),
    dict(name="bound_unflipped", nstate=10, bound0=True, b1=True),
    dict(_XGRE_ALL, name="gate_top_c1_n301", C=1, nstate=301, ntr=312),
    dict(_XGRE_ALL, name="gate_top_c2_n150", nstate=150, ntr=161),
    dict(_XGRE_ALL, name="gate_top_c3_n99", C=3, nstate=99, ntr=110),
    dict(_XGRE_ALL, name="gate_top_c4_n74", C=4, nstate=74, ntr=85),
]
XCOMP_PRIMAL_CASES = [
    dict(_XCOMP_ALL, name=f"chunk_n8_st{n}", nstate=8, nstage=n)
    for n in (31, 32, 33)] + [
    dict(_XCOMP_ALL, name="mix_identity", nstate=8, mix="identity"),
    dict(_XCOMP_ALL, name="mix_none", nstate=8, mix="none"),
    dict(_XCOMP_ALL, name="bound_unflipped", nstate=8, bound0=True),
    dict(name="options_off", nstate=8, shift="up"),
    dict(_XCOMP_ALL, name="global_c4_taus8", C=4, nstate=2, ntaus=8),
    dict(_XCOMP_ALL, name="global_c4_n5_taus26", C=4, nstate=5, ntaus=26),
    dict(_XCOMP_ALL, name="gate_top_c1_n301", C=1, nstate=301, shift="up",
         nstage=312),
    dict(_XCOMP_ALL, name="gate_top_c2_n150", nstate=150, shift="up",
         nstage=161),
    dict(_XCOMP_ALL, name="gate_top_c3_n99", C=3, nstate=99, shift="up",
         nstage=110),
    dict(_XCOMP_ALL, name="gate_top_c4_n74", C=4, nstate=74, shift="up",
         nstage=85),
]
X_PRIMAL_ATOMS = 1000

#: covering set of the bSSFP kernels' options (each also run through the
#: Jacobian kernel with and without the ddf group; b1 is the B1 batch
#: whose dB1 column a B1-tracked train reads)
BSSFP_CASES = [
    dict(name="base"),
    dict(name="inv", inversion=18.0),
    dict(name="inv_df", inversion=18.0, df=True),
    dict(name="df_demod", df=True, demodulate=True),
    dict(name="var_te", var_te=True, demodulate=True),
    dict(name="b1_all", b1=True, df=True, inversion=12.0, var_te=True,
         demodulate=True, normalize=True),
]

#: covering set of the DESS kernels' options at nstate 8 and 15
DESS_CASES = [
    dict(name="n8", nstate=8),
    dict(name="n15_df", nstate=15, df=True),
    dict(name="n8_df_demod", nstate=8, df=True, demodulate=True),
    dict(name="n15_var_te_b1", nstate=15, var_te=True, b1=True,
         demodulate=True),
    dict(name="n8_all", nstate=8, var_te=True, b1=True, df=True,
         demodulate=True),
]
#: the segmented DESS Jacobian kernel's own edges, every option on, each
#: held against its twin at DESS_EDGE_SHAPE: nstate 1 (16 ladders per
#: warp), 2 (R = 1 with 3 lanes), 64 / 65 (R changing from 2 to 3) and 74
#: (the gate's deepest ladder); ragged shapes (atoms, pulses) of the
#: option case with every option: 1, 33 and 4,097 atoms, 1 and 2 pulses
DESS_EDGE_CASES = [dict(name=f"edge_n{n}", nstate=n, var_te=True, b1=True,
                        df=True, demodulate=True)
                   for n in (1, 2, 64, 65, 74)]
DESS_EDGE_SHAPE = (1000, 100)
DESS_SHAPES = [(1, 33), (33, 33), (4097, 33), (33, 1), (33, 2)]

#: covering set of the ME-GRE kernels' options: m echoes, nstate, df,
#: demodulation, a per-pulse (m, P) echo-time matrix, a B1 batch; the
#: cases without df run the Jacobian's df group at dfs=None
MEGRE_CASES = [
    dict(name="m2_n8", m=2, nstate=8),
    dict(name="m3_n12_df", m=3, nstate=12, df=True),
    dict(name="m2_n8_df_demod", m=2, nstate=8, df=True, demodulate=True),
    dict(name="m3_n12_var_te_b1", m=3, nstate=12, var_te=True, b1=True,
         demodulate=True),
    dict(name="m3_n8_all", m=3, nstate=8, var_te=True, b1=True, df=True,
         demodulate=True),
]
#: the segmented Jacobian kernel's own edges (see JAC_EDGE_CASES): the
#: gate's deepest ladder (nstate 59, its df group at dfs=None), R changing
#: at nstate 31 / 32 / 33, nstate 1 (16 ladders per warp, one echo too
#: many for the segment's lanes: m = 3 > W = 2)
MEGRE_EDGE_CASES = [
    dict(name="gate_n59", m=3, nstate=59, var_te=True, b1=True,
         demodulate=True),
    dict(name="n31", m=2, nstate=31, df=True),
    dict(name="n32", m=3, nstate=32, var_te=True, b1=True, df=True,
         demodulate=True),
    dict(name="n33", m=2, nstate=33, df=True, demodulate=True),
    dict(name="n1", m=3, nstate=1, var_te=True, b1=True, df=True,
         demodulate=True),
]

#: nstates on both sides of every change of the primal ME-GRE kernel's
#: instance or rows per lane (cuda_megre.megre_rows: the one-lane instance
#: of each length at nstate 1-11, R = 7 on two lanes from 12, ..., 12 rows
#: on 11 lanes from 120) and the gate's deepest ladder, 301
MEGRE_ROW_EDGES = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
                   17, 18, 19, 20, 21, 22, 23, 24, 26, 27, 29, 30, 32, 33,
                   35, 36, 39, 40, 43, 44, 47, 48, 49, 50, 54, 55, 59, 60,
                   65, 66, 71, 72, 76, 77, 83, 84, 87, 88, 95, 96, 98, 99,
                   107, 108, 109, 110, 119, 120, 121, 301)
#: the primal ME-GRE kernel's edges (megre.cu), each held against its twin
#: over MEGRE_EDGE_ATOMS atoms and a train MEGRE_EDGE_PULSES TRs longer than
#: the ladder: every nstate of MEGRE_ROW_EDGES, those on one lane (1-11)
#: with df on and off, the rest alternating df, demodulation, a per-pulse
#: echo-time matrix and TR / echo-time runs
MEGRE_PRIMAL_EDGE_CASES = [
    dict(name=f"rows_n{n}{'' if df else '_nodf'}", m=2 + n % 2, nstate=n,
         df=df, demodulate=n % 2 == 0, var_te=n % 2 == 1, runs=n % 3 == 0)
    for n in MEGRE_ROW_EDGES for df in ((True, False) if n <= 11
                                        else (n % 4 != 0,))]
MEGRE_EDGE_ATOMS, MEGRE_EDGE_PULSES = 1000, 10
#: the primal ME-GRE kernel's echo counts and train shapes, each (case,
#: atoms, TRs): m = 400 at nstate 1 and m = 1,000 at nstate 8 on one lane
#: (factors recomputed each TR), m = 4 (the most held in registers) and 5,
#: m = 400 and m = 1 at nstate 12 (two lanes); TR and echo-time runs
#: ending mid-chunk and at chunk boundaries; the ragged shapes of 1, 33
#: and 4,097 atoms, 1 and 2 TRs and the chunk edges of 31-33 TRs, at
#: nstate 8 (one lane) and 12 (two lanes)
_MEGRE_ALL = dict(df=True, demodulate=True, var_te=True, b1=True)
MEGRE_PRIMAL_CASES = [
    (dict(name="m400_n1", m=400, nstate=1, df=True, demodulate=True), 33,
     12),
    (dict(name="m1000_n8", m=1000, nstate=8, df=True), 33, 12),
    (dict(_MEGRE_ALL, name="m4_n8", m=4, nstate=8), 1000, 40),
    (dict(_MEGRE_ALL, name="m5_n8", m=5, nstate=8), 1000, 40),
    (dict(name="m5_n12_df", m=5, nstate=12, df=True), 1000, 40),
    (dict(name="m400_n12", m=400, nstate=12, df=True, demodulate=True), 33,
     14),
    (dict(name="m1_n12", m=1, nstate=12, df=True), 1000, 40),
    (dict(_MEGRE_ALL, name="runs_n8", m=3, nstate=8, runs=True), 1000, 80),
    (dict(name="runs_n8_fixed_te", m=3, nstate=8, runs=True), 1000, 80),
    (dict(_MEGRE_ALL, name="runs_n12", m=3, nstate=12, runs=True), 1000,
     80),
] + [(dict(_MEGRE_ALL, name=f"shape_n{n}", m=3, nstate=n), b, p)
     for n in (8, 12)
     for b, p in ((1, 40), (33, 40), (4097, 40), (33, 1), (33, 2),
                  (1000, 31), (1000, 32), (1000, 33))]

#: the primal bSSFP kernel's edges (bssfp.cu), each held against its twin
#: over BSSFP_EDGE_SHAPE: TR (and TE) runs ending mid-chunk and at the
#: 32-pulse chunk boundary, then varying; inversion without and with df;
#: a large df t (df 0.5 kHz, TR 1,000 ms); then every option over the
#: ragged shapes BSSFP_SHAPES: 1, 2 and 31-33 pulses, atom counts off the
#: 128-thread block
BSSFP_EDGE_CASES = [
    dict(name="runs_var_te", runs=True, var_te=True, df=True, demodulate=True,
         inversion=18.0),
    dict(name="runs_fixed_te", runs=True, df=True),
    dict(name="inv_nodf", inversion=18.0, var_te=True),
    dict(name="inv_df", inversion=18.0, df=True, demodulate=True),
    dict(name="big_df", big_df=True, df=True, inversion=18.0,
         demodulate=True),
    dict(name="big_df_var_te", big_df=True, df=True, var_te=True),
]
BSSFP_EDGE_SHAPE = (1000, 100)
BSSFP_SHAPES = [(1, 1), (1, 2), (33, 31), (129, 32), (4097, 33), (127, 2)]
BSSFP_RAGGED_CASE = dict(name="ragged", b1=True, df=True, inversion=12.0,
                         var_te=True, demodulate=True)

#: nstates on both sides of every change of the segmented primal kernels'
#: rows per lane (cuda_fisp.half_rows: fisp_half.cu and composite.cu),
#: nstate 1 among them
HALF_ROW_EDGES = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 15, 16, 19, 20, 23,
                  24, 29, 30, 35, 36, 39, 40, 47, 48, 49, 50)
#: covering set of the composite kernels' options: shift directions (up,
#: down, mixed), ADC phases, b1u (adiabatic) stages with a B1 batch, df, D
#: stages with ramp directions -1, 0 and +1, stages without a readout and
#: neutral (flip 0) stages, nstate 1 with shifts both ways
COMP_CASES = [
    dict(name="up", shift="up"),
    dict(name="down", shift="down"),
    dict(name="mixed_adcph", shift="mixed", adcph=True),
    dict(name="b1u_df", shift="up", b1u=True, df=True),
    dict(name="d_rd", shift="mixed", diffusion=True),
    dict(name="sparse_neutral", shift="mixed", sparse=True),
    dict(name="n1_mixed_df", shift="mixed", nstate=1, df=True),
    dict(name="all", shift="mixed", adcph=True, b1u=True, df=True,
         diffusion=True, sparse=True),
]
#: the Jacobian's group sets held against the twin: none (magnitude only),
#: each group alone, all four
COMP_GROUP_SETS = [(), ("T1",), ("T2",), ("B1",), ("df",),
                   ("T1", "T2", "B1", "df")]
#: stages of an option case (cut from 300 with the depths above); stages
#: of an edge case: with mixed shifts the ladder reaches about two thirds
#: of them, 200 rows, past the deepest ladders' (151 rows at 1 group) and
#: into the composite primal kernel's 302
COMP_CASE_N, COMP_EDGE_N = 150, 300
#: the segmented composite Jacobian kernel's edges, each with every option
#: (every shift direction, D with ramps, df, ADC phases, b1u, sparse
#: readouts) over COMP_EDGE_N stages: the gate's deepest ladder for each
#: group count (nstate 59 / 74 / 99 / 150 with 4 / 3 / 2 / 1 groups: 2 /
#: 3 / 4 / 5 rows per lane), rows per lane changing (nstate 2 / 3) and
#: nstate 1; (case, groups)
_COMP_ALL = dict(shift="mixed", adcph=True, b1u=True, df=True,
                 diffusion=True, sparse=True)
COMP_EDGE_CASES = [
    (dict(_COMP_ALL, name="gate_g4_n59", nstate=59),
     ("T1", "T2", "B1", "df")),
    (dict(_COMP_ALL, name="gate_g3_n74", nstate=74), ("T1", "T2", "df")),
    (dict(_COMP_ALL, name="gate_g2_n99", nstate=99), ("B1", "df")),
    (dict(_COMP_ALL, name="gate_g1_n150", nstate=150), ("T2",)),
    (dict(_COMP_ALL, name="g4_n2", nstate=2), ("T1", "T2", "B1", "df")),
    (dict(_COMP_ALL, name="g4_n3", nstate=3), ("T1", "T2", "B1", "df")),
    (dict(_COMP_ALL, name="g4_n1", nstate=1), ("T1", "T2", "B1", "df")),
]
#: the segmented composite primal kernel's edges, each with every option:
#: the gate's deepest ladder (nstate 301) with mixed shifts and with every
#: stage shifting up (its top rows reached over COMP_PRIMAL_TOP_N stages),
#: and both sides of every change of the rows per lane (HALF_ROW_EDGES,
#: nstate 1 among them)
COMP_PRIMAL_EDGE_CASES = [dict(_COMP_ALL, name="gate_n301", nstate=301),
                          dict(_COMP_ALL, name="gate_up_n301", nstate=301,
                               shift="up")] + [
    dict(_COMP_ALL, name=f"rows_n{n}", nstate=n) for n in HALF_ROW_EDGES]
COMP_PRIMAL_TOP_N = 340
#: nstates of the composite primal kernel's ragged shapes (COMP_SHAPES):
#: one lane per ladder (1; 8, MPRAGE's) and four (40)
COMP_PRIMAL_SHAPE_NSTATES = (1, 8, 40)
#: atoms of the composite edge cases; ragged shapes (atoms, stages) of the
#: case with every option and every group, at nstate 1 and COMPJ_NSTATE:
#: 1, 33 and 4,097 atoms, 1, 2 and 33 stages
COMP_EDGE_ATOMS = 1000
COMP_SHAPES = [(1, 33), (33, 33), (4097, 33), (33, 1), (33, 2)]

#: the full-ladder kernel's option cases: the FISP cases it takes (no
#: diffusion, no normalize: neither reaches the kernel), each at nstate 0
#: and at the FISP depth, where the folded kernel is its parity partner
FULL_CASES = [dict(c, nstate=n, name=f"{c['name']}_n{n}")
              for c in [dict(name="base"), dict(name="var_te", var_te=True),
                        dict(name="inv_df", inversion=20.0, df=True,
                             inversion_df=True),
                        dict(name="inv_df_off", inversion=20.0, df=True,
                             inversion_df=False),
                        dict(name="df_demod", df=True, demodulate=True)]
              for n in (0, NSTATE)]

#: published peaks of one H100 SXM (NVIDIA's data sheet, 700 W): float32
#: outside the tensor cores (132 SMs x 128 lanes x 2 x 1.98 GHz) and HBM3
PEAK_FP32, PEAK_HBM = 66.9e12, 3.35e12

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


#: the segmented FISP dictionary kernel's own edges, each held against its
#: twin over HALF_EDGE_PULSES pulses more than the ladder has rows: the
#: gate's deepest ladder (nstate 301: 12 rows on 26 lanes) with and
#: without DW-FISP, with inversion, df and demodulation; trains whose TR
#: and TE repeat in runs (with per-pulse TE and without), so that the
#: relaxation terms are kept across pulses and recomputed; both sides of
#: every change of the rows per lane, options alternating
HALF_EDGE_CASES = [
    dict(name="gate_n301", nstate=301, inversion=20.0, df=True,
         demodulate=True),
    dict(name="gate_dw_n301", nstate=301, inversion=20.0, df=True,
         demodulate=True, diffusion="ramp"),
    dict(name="runs_var_te", runs=True, var_te=True, df=True),
    dict(name="runs", runs=True, inversion=20.0, diffusion="noramp"),
] + [dict(name=f"rows_n{n}", nstate=n, var_te=True, inversion=20.0, df=True)
     if n % 2 else dict(name=f"rows_n{n}", nstate=n, runs=True,
                        demodulate=True, df=True, diffusion="ramp")
     for n in HALF_ROW_EDGES]
HALF_EDGE_ATOMS, HALF_EDGE_PULSES = 1000, 40
#: ragged shapes (atoms, pulses) of the FISP dictionary kernel, each with
#: HALF_RAGGED_CASE at one lane per ladder (nstate 10) and at four (40): 1,
#: 33 and 4,097 atoms, trains of 1 and 33 pulses
HALF_SHAPES = [(1, 120), (33, 120), (4097, 120), (33, 1), (33, 33)]
HALF_RAGGED_CASE = dict(name="ragged", runs=True, var_te=True,
                        inversion=15.0, df=True, demodulate=True,
                        diffusion="ramp")

#: the segmented Jacobian kernels' (fisp_jac.cu, megre_jac.cu) own edges,
#: each held against its twin over a train longer than the ladder: the
#: gate's deepest ladders (nstate 74; 59 with the dD group), rows per lane
#: changing at nstate 31 / 32 / 33 (R = 1, 2) and nstate 1 (16 ladders per
#: warp)
JAC_EDGE_CASES = [
    dict(name="gate_n74", nstate=74, var_te=True, inversion=20.0, df=True,
         demodulate=True),
    dict(name="gate_d_n59", nstate=59, inversion=20.0, df=True,
         diffusion="ramp", track_d=True),
    dict(name="n31", nstate=31, df=True, demodulate=True),
    dict(name="n32", nstate=32, var_te=True, inversion=20.0),
    dict(name="n33_d", nstate=33, diffusion="noramp", track_d=True),
    dict(name="n1", nstate=1, inversion=20.0, df=True, demodulate=True),
]
#: atoms and pulses of the segmented kernels' edge cases
SEG_EDGE_SHAPE = (1000, 100)
#: ragged shapes (atoms, pulses) of the segmented kernels, each run with
#: the option case SEG_RAGGED_CASES names: 1, 2 and 3 atoms (part of one
#: warp's segments), 33 and 4,097 (a partial block), a one-pulse train
SEG_SHAPES = [(1, 120), (2, 120), (3, 120), (33, 120), (4097, 120), (33, 1)]
SEG_RAGGED_CASES = {"fisp_jac": "all", "megre_jac": "m3_n8_all"}
#: DW-FISP: pulses of the gate-edge check (nstate 59 with the dD group) on
#: the matched train, over SEG_SHAPES' 4,097 atoms
DWF_EDGE_N = 100


#: every option of the Hessian kernel: form (4-op: echo at tau; 5-op: echo
#: at TE 5), inversion (TI 20), second order, nstate, RF phase
HESS_CASES = [dict(name=f"{'5op' if te else '4op'}{'_inv' if inv else ''}"
                   f"{'' if so else '_o1'}_n{ns}_phi{phi}",
                   te=te, inversion=inv, second_order=so, nstate=ns, phi=phi)
              for te in (None, 5.0) for inv in (None, 20.0)
              for so in (True, False) for ns in (6, 10) for phi in (90, 30)]


#: the two-pass Hessian kernel's own edges (fisp_hess.cu), each held
#: against its twin over a train longer than the ladder: the gate's deepest
#: ladders (nstate 46 at second order, 126 at first: 2 and 4 rows per
#: lane), rows per lane changing (nstate 2 / 3: 1 / 2 rows; first order 63
#: / 64: 2 / 3 rows, 95 / 96: 3 / 4 rows) and nstate 1 (16 ladders per warp)
HESS_EDGE_CASES = [
    dict(name="gate_o2_n46", te=5.0, inversion=20.0, nstate=46, phi=30),
    dict(name="gate_o1_n126", inversion=20.0, second_order=False,
         nstate=126, phi=30),
    dict(name="o2_n1", nstate=1, phi=30),
    dict(name="o2_n2", te=5.0, nstate=2),
    dict(name="o2_n3", inversion=20.0, nstate=3, phi=30),
    dict(name="o1_n63", second_order=False, nstate=63),
    dict(name="o1_n64", te=5.0, second_order=False, nstate=64, phi=30),
    dict(name="o1_n95", second_order=False, nstate=95),
    dict(name="o1_n96", inversion=20.0, second_order=False, nstate=96),
]
#: atoms of the Hessian edge cases; ragged shapes (atoms, pulses): 1, 33
#: and 4,097 atoms (part of one lane-pass block's ladders, a partial atom
#: block), 1, 2 and 33 pulses, each at nstate 1 and at the main path's 10
HESS_EDGE_ATOMS = 64
HESS_SHAPES = [(1, 33), (33, 33), (4097, 33), (33, 1), (33, 2)]


#: covering set of the CPMG kernels' options (var: per-echo spacings and
#: phases; b1: per-atom B1 on the refocusing flips; diff: the DW-TSE
#: stages' ramp flags; gate_dw: the Jacobian gate's deepest DW ladder)
MSE_CASES = [
    dict(name="base"),
    dict(name="spacing_phase", var=True),
    dict(name="b1", b1=True),
    dict(name="dw_ramp", diff=(True, True)),
    dict(name="dw_const_ramp", diff=(False, True), var=True),
    dict(name="dw_b1", diff=(True, False), b1=True),
    dict(name="gate_dw", diff=(True, True), var=True, b1=True, nstate=59),
    dict(name="gate", var=True, b1=True, nstate=74),
]
#: ragged shapes (atoms, echoes) of the warp-row Jacobian kernel, each run
#: with the cases named in MSE_RAGGED_CASES: one atom, a block of 8
#: atom-warps and one, 4,097 atoms, a one-echo train
MSE_JAC_SHAPES = [(1, MSE_NECHO), (33, MSE_NECHO), (4097, MSE_NECHO),
                  (33, 1)]
MSE_RAGGED_CASES = ("spacing_phase", "dw_b1")
#: the segmented CPMG kernel's own edges, each held against its twin at
#: CPMG_EDGE_SHAPE: the gate's deepest ladders (nstate 301: 10 rows on 31
#: lanes; 150 with DW-TSE: 10 rows on 16 lanes), and truncated ladders
#: (nstate 8 < 2 x 18 echoes: the last row is reached and A beyond it
#: dropped) at MSE_NECHO echoes
CPMG_EDGE_CASES = [
    dict(name="gate_n301", var=True, b1=True, nstate=301),
    dict(name="gate_dw_n150", diff=(True, False), var=True, b1=True,
         nstate=150),
    dict(name="truncated_n8", var=True, b1=True, nstate=8, necho=MSE_NECHO),
    dict(name="truncated_dw_n8", diff=(True, True), nstate=8,
         necho=MSE_NECHO),
]
CPMG_EDGE_SHAPE = (1000, 80)
#: ragged shapes (atoms, echoes) of the CPMG kernel, each with the cases
#: named in MSE_RAGGED_CASES: 1, 33 and 4,097 atoms, a one-echo train
CPMG_SHAPES = [(1, MSE_NECHO), (33, MSE_NECHO), (4097, MSE_NECHO), (33, 1)]

#: the design kernel: first and second order at the example's depth, and
#: per-echo phases at the gate's deepest second-order ladder
DESIGN_CASES = [
    dict(name="o2", second_order=True),
    dict(name="o1", second_order=False),
    dict(name="o2_phase_n168", second_order=True, phase=True, nstate=168),
    dict(name="o1_n386", second_order=False, nstate=386),
]
#: ragged shapes (atoms, echoes) of the warp-row design kernel, each at
#: first and second order: one atom, 33 and 4,097 atoms, a one-echo train,
#: echo counts that are no multiple of the tile (13: two tiles of 7
#: lane-warps, one idle; 33: five tiles of 7, three ladder chunks)
DESIGN_SHAPES = [(1, TSE_NECHO), (33, TSE_NECHO), (4097, TSE_NECHO),
                 (33, 1), (33, 13), (33, 33)]


def make_mse_case(case, natoms, necho=MSE_NECHO, seed=0):
    """Numpy inputs of one CPMG option case: (args, kwargs) of
    cpmg_{dictionary,jacobian}_{cuda,plain,pallas} (exc, FA, phi, tau1,
    tau2, T1s, T2s, B1s; nstate and the DW-TSE stages)."""
    rng = np.random.default_rng(seed)
    FA = rng.uniform(100.0, 180.0, necho)
    if case.get("var"):
        phi = rng.uniform(0.0, 40.0, necho)
        tau1 = rng.uniform(3.0, 6.0, necho)
        tau2 = rng.uniform(3.0, 6.0, necho)
    else:
        phi = np.zeros(necho)
        tau1 = tau2 = np.full(necho, MSE_TE / 2)
    T1 = rng.uniform(400.0, 1600.0, natoms)
    T2 = rng.uniform(20.0, 150.0, natoms)
    B1 = rng.uniform(0.6, 1.1, natoms) if case.get("b1") else np.ones(natoms)
    kw = dict(nstate=case.get("nstate", 2 * necho))
    if case.get("diff"):
        kw["diffusion"] = (3.0, 4.0, 5.0, 6.0,
                           rng.uniform(5e-4, 3e-3, natoms),
                           rng.uniform(5e-4, 3e-3, natoms))
        kw["diff_ramp"] = case["diff"]
    return (EXC, FA, phi, tau1, tau2, T1, T2, B1), kw


def make_bssfp_case(case, natoms, npulse=None, seed=0):
    """Numpy inputs of one bSSFP option case: (args, kwargs) of
    bssfp_dictionary_{cuda,plain,pallas} (FA, phi, TR, TE, T1s, T2s, B1s,
    dfs; demodulate, inversion, normalize)."""
    rng = np.random.default_rng(seed)
    npulse = npulse or BSSFP_N
    FA = 10.0 + 50.0 * np.abs(np.sin(np.arange(npulse) * 2 * np.pi / 100.0))
    FA += rng.uniform(0, 2, npulse)
    phi = rng.uniform(0.0, 180.0, npulse)
    TRs = rng.uniform(11.0, 14.0, npulse)
    TEs = TRs * rng.uniform(0.3, 0.6, npulse) if case.get("var_te") else 5.0
    T1 = rng.uniform(200.0, 2500.0, natoms)
    T2 = np.minimum(rng.uniform(20.0, 250.0, natoms), 0.8 * T1)
    B1 = rng.uniform(0.7, 1.3, natoms) if case.get("b1") else np.ones(natoms)
    df = rng.uniform(-0.05, 0.05, natoms) if case.get("df") else None
    if case.get("runs"):
        # TR (and TE) held over runs that span a chunk boundary
        # (cuda_bssfp.BSSFP_PULSES) and end mid-chunk or at a boundary,
        # then varying every pulse
        TRs = _held_runs(rng, TRs, (0, 20, 40, 64, 70))
        if case.get("var_te"):
            TEs = TRs * _held_runs(rng, np.full(npulse, 0.45),
                                    (0, 13, 32, 52))
    if case.get("big_df"):
        # a large df t: df about 0.5 kHz over TRs of 1,000 ms, where
        # sincosf(2 pi df t) and sincospif(2 df t) part ways
        TRs = np.full(npulse, 1000.0)
        if case.get("var_te"):
            TEs = TRs * rng.uniform(0.3, 0.6, npulse)
        T1 = rng.uniform(1500.0, 3000.0, natoms)
        T2 = rng.uniform(600.0, 1400.0, natoms)
        df = rng.uniform(0.49, 0.51, natoms) * rng.choice([-1.0, 1.0], natoms)
    kw = dict(demodulate=case.get("demodulate", False),
              inversion=case.get("inversion"),
              normalize=case.get("normalize", False))
    return (FA, phi, TRs, TEs, T1, T2, B1, df), kw


def make_dess_case(case, natoms, npulse=200, seed=0):
    """Numpy inputs of one DESS option case: (args, kwargs) of
    dess_{dictionary,jacobian}_{cuda,plain,pallas} (FA, phi, TR, TE, T1s,
    T2s, B1s, dfs; nstate, demodulate)."""
    rng = np.random.default_rng(seed)
    FA = rng.uniform(15.0, 50.0, npulse)
    phi = rng.uniform(0.0, 360.0, npulse)
    TRs = rng.uniform(16.0, 20.0, npulse)
    TEs = rng.uniform(3.0, 6.0, npulse) if case.get("var_te") else DESS_TE
    T1 = rng.uniform(400.0, 1800.0, natoms)
    T2 = np.minimum(rng.uniform(35.0, 180.0, natoms), 0.6 * T1)
    B1 = rng.uniform(0.8, 1.2, natoms) if case.get("b1") else np.ones(natoms)
    df = rng.uniform(-0.03, 0.03, natoms) if case.get("df") else None
    kw = dict(nstate=case["nstate"], demodulate=case.get("demodulate", False))
    return (FA, phi, TRs, TEs, T1, T2, B1, df), kw


def make_megre_case(case, natoms, npulse=MEGRE_N, seed=0):
    """Numpy inputs of one ME-GRE option case: (args, kwargs) of
    megre_{dictionary,jacobian}_{cuda,plain,pallas} (FA, phi, TR, TEs, T1s,
    T2s, B1s, dfs; nstate, demodulate)."""
    rng = np.random.default_rng(seed)
    m = case["m"]
    FA = rng.uniform(12.0, 45.0, npulse)
    phi = rng.uniform(0.0, 360.0, npulse)
    TRs = rng.uniform(18.0, 24.0, npulse)
    TEs = (np.cumsum(rng.uniform(2.0, 5.0, (m, npulse)), axis=0)
           if case.get("var_te") else np.asarray(MEGRE_TES[:m]))
    T1 = rng.uniform(300.0, 2500.0, natoms)
    T2 = np.minimum(rng.uniform(20.0, 300.0, natoms), 0.8 * T1)
    B1 = rng.uniform(0.8, 1.2, natoms) if case.get("b1") else np.ones(natoms)
    df = rng.uniform(-0.05, 0.05, natoms) if case.get("df") else None
    if m > len(MEGRE_TES) and not case.get("var_te"):
        # many echoes 0.02-0.05 ms apart, shared by every TR
        TEs = np.cumsum(rng.uniform(0.02, 0.05, m))
    if case.get("runs"):
        # TR and the echo times held over runs that span the chunk
        # boundaries of one lane (32 TRs) and of two (31) and end mid-chunk
        # or at a boundary; then TR varies every TR
        TRs = _held_runs(rng, TRs, (0, 20, 32, 40, 62, 70))
        if case.get("var_te"):
            TEs = np.cumsum(rng.uniform(2.0, 5.0, (m, 1)), axis=0) * (
                _held_runs(rng, np.ones(npulse), (0, 13, 31, 45, 64))[None])
    kw = dict(nstate=case["nstate"], demodulate=case.get("demodulate", False))
    return (FA, phi, TRs, TEs, T1, T2, B1, df), kw


def _held_runs(rng, varying, starts):
    """`varying` (one value per pulse) held constant over runs starting at
    each index of `starts` (each run's value drawn near its first pulse's)
    up to the last start, and as it is from there on."""
    out = np.array(varying, dtype=np.float64)
    ends = list(starts[1:]) + [starts[-1]]
    for a, b in zip(starts[:-1], ends[:-1]):
        if a < len(out):
            out[a:b] = out[a] * rng.uniform(0.9, 1.1)
    return out


def make_comp_case(case, natoms, nstage=COMP_CASE_N, seed=0):
    """Numpy inputs of one composite option case: (args, kwargs) of
    composite_{cuda,plain,pallas} and their Jacobians (FA, phi, ta, tb,
    adci, shift, aph, b1u, T1s, T2s, B1s, dfs; nadc, nstate and the D
    stages (btd, rdir, Dc): a ramp only on a shifting stage, in its
    direction, as the matcher builds them)."""
    rng = np.random.default_rng(seed)
    N = nstage
    FA = rng.uniform(5.0, 60.0, N)
    phi = rng.uniform(0.0, 360.0, N)
    ta = rng.uniform(1.0, 4.0, N)
    tb = rng.uniform(2.0, 8.0, N)
    shift = {"up": np.ones(N), "down": -np.ones(N),
             "mixed": rng.choice([-1.0, 0.0, 1.0], N)}[case["shift"]]
    adc = np.ones(N, bool)
    if case.get("sparse"):
        adc = rng.random(N) < 0.6
        adc[0] = True
        FA[rng.random(N) < 0.15] = 0.0          # neutral stages
        tb[rng.random(N) < 0.05] = 300.0        # recovery delays
    adci = np.where(adc, np.cumsum(adc) - 1, -1)
    aph = rng.uniform(-np.pi, np.pi, N) if case.get("adcph") else None
    b1u = ((rng.random(N) < 0.7).astype(float) if case.get("b1u")
           else None)
    T1 = rng.uniform(300.0, 2000.0, natoms)
    T2 = np.minimum(rng.uniform(20.0, 250.0, natoms), 0.8 * T1)
    B1 = rng.uniform(0.8, 1.2, natoms)
    df = rng.uniform(-0.05, 0.05, natoms) if case.get("df") else None
    kw = dict(nadc=int(adc.sum()), nstate=case.get("nstate", 10))
    if case.get("diffusion"):
        d = rng.random(N) < 0.4
        ramp = (shift != 0) & (rng.random(N) < 0.7)
        kw["diffusion"] = (np.where(d, rng.uniform(5.0, 40.0, N), 0.0),
                           np.where(d & ramp, shift, 0.0),
                           rng.uniform(0.5e-3, 3e-3, natoms))
    return (FA, phi, ta, tb, adci, shift, aph, b1u, T1, T2, B1, df), kw


def comp_tensors(torch, args, kw, device):
    """make_comp_case's inputs as the kernels take them on `device`: float32
    tensors, adci and shift int32."""
    def t(x, dt=None):
        if x is None or np.ndim(x) == 0:
            return x
        return torch.as_tensor(np.asarray(x), dtype=dt or torch.float32,
                               device=device)

    kw = dict(kw)
    if kw.get("diffusion") is not None:
        kw["diffusion"] = tuple(t(d) for d in kw["diffusion"])
    return tuple(t(a, torch.int32 if i in (4, 5) else None)
                 for i, a in enumerate(args)), kw


def _xpools(rng, C, natoms, g=False):
    """Random densities, kinetic matrix and per-compartment atoms (T1, T2,
    g as (C, B); g None without off-resonance) of C pools."""
    from epgpy_torch.ops.exchange import exchange_matrix

    d = rng.uniform(0.2, 1.0, C)
    dens = d / d.sum()
    khi = (exchange_matrix(rng.uniform(0.002, 0.02), ncomp=C,
                           densities=dens) if C > 1 else np.zeros((1, 1)))
    T1 = rng.uniform(500.0, 1500.0, (C, natoms))
    T2 = np.concatenate([rng.uniform(20.0, 150.0, (1, natoms)),
                         rng.uniform(0.01, 5.0, (C - 1, natoms))])
    gv = rng.uniform(-0.05, 0.05, (C, natoms)) if g else None
    return dens, khi, T1, T2, gv


def make_xgre_case(case, natoms, ntr=XGRE_CASE_N, seed=0):
    """Numpy inputs of one EPG-X GRE option case: (args, kwargs) of
    xgre_dictionary_{cuda,plain,pallas} (alpha, phi, satf_re, satf_im,
    satz_re, satz_im, dens, stageA, stageB, b1; nstate, shift).  With
    ``identity`` both exchange stages are absent (identities), with
    ``bound0`` the pools after the first are never flipped."""
    rng = np.random.default_rng(seed)
    C, N = case.get("C", 2), ntr
    alpha = np.concatenate([rng.uniform(5.0, 40.0, (N, 1)),
                            rng.uniform(0.0, 10.0, (N, C - 1))], axis=1)
    phi = rng.uniform(0.0, 360.0, (N, C))
    rT = (rng.uniform(0.0, 0.05, (N, C)) + 1j * rng.uniform(-0.3, 0.3, (N, C))
          if case.get("csat") else np.zeros((N, C)))
    rL = np.zeros((N, C))
    rL[:, -1] = rng.uniform(0.0, 0.6, N)
    satf, satz = np.conj(np.exp(-rT)), np.exp(-rL) + 0j
    dens, khi, T1, T2, g = _xpools(rng, C, natoms, case.get("g"))
    if g is None:
        g = np.zeros((C, natoms))
    if case.get("two_stage"):
        stageA = (khi, T1, T2, g, 3.0)
    else:
        stageA = (np.zeros((C, C)), T1, T2, g, 0.0)
    stageB = (khi, T1, T2, g, 7.0 if case.get("two_stage") else 10.0)
    if case.get("identity"):
        stageB = (np.zeros((C, C)), T1, T2, g, 0.0)
    if case.get("bound0"):
        alpha[:, 1:] = 0.0
    b1 = rng.uniform(0.8, 1.2, natoms) if case.get("b1") else None
    balanced = bool(case.get("balanced"))
    kw = dict(nstate=0 if balanced else case.get("nstate", 10),
              shift=not balanced)
    return (alpha, phi, satf.real, satf.imag, satz.real, satz.imag, dens,
            stageA, stageB, b1), kw


def _x_tangents(torch, fn, khi, T2, C):
    """(value, [tangent wrt the free pool's T2, tangent wrt the exchange
    rate k of khi = k kron]) of fn(khi, T2) by torch.func.jvp, float64."""
    khi = torch.as_tensor(np.asarray(khi, np.float64))
    T2 = torch.as_tensor(np.asarray(T2, np.float64))
    e0 = torch.zeros_like(T2)
    e0[0] = 1.0
    val, t1 = torch.func.jvp(lambda t: fn(khi, t), (T2,), (e0,))
    _, t2 = torch.func.jvp(lambda k: fn(k, T2), (khi,), (khi / 0.01,))
    return val, [t1, t2]


def make_xgre_jac_case(torch, case, natoms, ntr=XGRE_CASE_N, seed=0):
    """Numpy inputs of one EPG-X GRE Jacobian case: the primal case's train
    with per-atom densities (C, B), the stages' (mr, mi, ml) (B, C, C) by
    the port's exchange_stage_mats in float64, and V = case["V"] (default
    2) variables -- the free pool's T2 and the exchange rate (the second
    also moving the densities) by torch.func.jvp, further variables
    multiples of those two -- (args, kwargs) of
    xgre_jacobian_{cuda,plain,pallas}.  With ``mixed_identity`` stage A
    is the exact identity with zero tangents for the first half of the
    atoms and every odd atom after."""
    from epgpy_torch.models.cuda_xgre import exchange_stage_mats

    args, kw = make_xgre_case(case, natoms, ntr, seed)
    rng = np.random.default_rng(seed + 1)
    dens = args[6]
    C, V = len(dens), case.get("V", 2)
    mats, dmats = [], []
    for khi, T1, T2, g, tau in args[7:9]:
        val, tans = _x_tangents(
            torch, lambda k, t: exchange_stage_mats(k, T1, t, g, tau), khi,
            T2, C)
        tans = [tuple(p * (1.0 + v // 2) for p in tans[v % 2])
                for v in range(V)]
        mats.append(tuple(v.numpy() for v in val))
        dmats.append(tuple(np.stack([t[p].numpy() for t in tans])
                           for p in range(3)))
    if case.get("mixed_identity"):
        b = np.arange(natoms)
        on = (b < natoms // 2) | (b % 2 == 1)
        eye = np.eye(C)
        mr, mi, ml = (m.copy() for m in mats[0])
        mr[on], mi[on], ml[on] = eye, 0.0, eye
        mats[0] = (mr, mi, ml)
        dmats[0] = tuple(np.where(on[None, :, None, None], 0.0, d)
                         for d in dmats[0])
    ddens = np.stack([np.zeros((C, natoms))]
                     + [rng.uniform(-0.05, 0.05, (C, natoms))
                        for _ in range(V - 1)])
    dens_b = np.broadcast_to(np.asarray(dens)[:, None], (C, natoms)).copy()
    return (args[:6] + (dens_b, mats[0], mats[1], dmats[0], dmats[1], ddens,
                        args[9])), kw


def xgre_tensors(torch, args, device, jac=False):
    """EPG-X GRE case inputs as the kernels take them on `device`: float32
    tensors (khi and tau stay host values in the primal's stages)."""
    def t(x):
        return None if x is None else torch.as_tensor(
            np.asarray(x, np.float32), device=device)

    out = [t(a) for a in args[:7]]
    if jac:
        out += [tuple(t(m) for m in grp) for grp in args[7:11]]
        out += [t(args[11]), t(args[12])]
    else:
        out += [(khi, t(T1), t(T2), t(g), tau)
                for khi, T1, T2, g, tau in args[7:9]] + [t(args[9])]
    return tuple(out)


def make_xcomp_case(case, natoms, nstage=XCOMP_CASE_N, seed=0):
    """Numpy inputs of one composite EPG-X option case: (args, kwargs) of
    xcomposite_{cuda,plain,pallas} (alpha, phi, satf_re, satf_im, satz_re,
    satz_im, adci, shift, aph, mia, mib, dens, taus, khi, T1, T2, g, b1,
    b1u; nadc, nstate and the has_* flags).  ``mix`` "identity" mixes every
    stage with table entry 0 (the identity), "none" with none; with
    ``bound0`` the pools after the first are never flipped."""
    rng = np.random.default_rng(seed)
    C, N = case.get("C", 2), nstage
    alpha = np.concatenate([rng.uniform(5.0, 40.0, (N, 1)),
                            rng.uniform(0.0, 8.0, (N, C - 1))], axis=1)
    phi = rng.uniform(0.0, 360.0, (N, C))
    satf, satz = np.ones((N, C), complex), np.ones((N, C), complex)
    if case.get("sat"):
        on = rng.random(N) < 0.3
        satz[on, -1] = np.exp(-rng.uniform(0.1, 0.6, on.sum()))
        satf[on, 0] = np.exp(-1j * rng.uniform(-0.2, 0.2, on.sum()))
    shift = {"up": np.ones(N), "none": np.zeros(N),
             "mixed": rng.choice([-1.0, 0.0, 1.0], N)}[case.get("shift",
                                                               "up")]
    adc = np.ones(N, bool)
    if case.get("sparse"):
        adc = rng.random(N) < 0.6
        adc[0] = True
    adci = np.where(adc, np.cumsum(adc) - 1, -1)
    aph = rng.uniform(-np.pi, np.pi, N) if case.get("adcph") else np.zeros(N)
    b1u = np.ones(N)
    if case.get("b1u"):
        adiab = rng.random(N) < 0.2
        b1u[adiab] = 0.0
        alpha[adiab] = np.asarray([180.0] + [0.0] * (C - 1))
    taus = np.array([0.0, 3.0, 7.0, 120.0, 2.5, 50.0])
    if case.get("ntaus"):
        taus = np.concatenate([[0.0], np.linspace(1.5, 180.0,
                                                  case["ntaus"] - 1)])
    mia = rng.integers(0, len(taus), N)
    mib = rng.integers(0, len(taus), N)
    if case.get("mix") == "identity":
        mia, mib = np.zeros(N, int), np.zeros(N, int)
    elif case.get("mix") == "none":
        mia, mib = np.maximum(mia, 1), np.maximum(mib, 1)
    if case.get("bound0"):
        alpha[:, 1:] = 0.0
    dens, khi, T1, T2, g = _xpools(rng, C, natoms, case.get("g"))
    if g is None:
        g = np.zeros((C, natoms))
    b1 = rng.uniform(0.8, 1.2, natoms)
    kw = dict(nadc=int(adc.sum()), nstate=case.get("nstate", 8),
              has_up=bool((shift == 1).any()),
              has_down=bool((shift == -1).any()),
              has_adcph=bool(case.get("adcph")), has_sat=bool(case.get("sat")),
              has_b1u=bool(case.get("b1u")))
    return (alpha, phi, satf.real, satf.imag, satz.real, satz.imag, adci,
            shift, aph, mia, mib, dens, taus, khi, T1, T2, g, b1, b1u), kw


def make_xcomp_jac_case(torch, case, natoms, nstage=XCOMP_CASE_N, seed=0):
    """Numpy inputs of one composite EPG-X Jacobian case: the primal case's
    stage tables, per-atom densities (C, B), the distinct-tau tables (mr,
    mi, ml) (nmat, B, C, C) by the port's xcomposite_stage_mat_tables in
    float64 and V = case["V"] (default 2) variables' tangents -- the free
    pool's T2 and the exchange rate (which also moves the densities) by
    torch.func.jvp, further variables multiples of those two: (args,
    kwargs) of xcomposite_jacobian_{cuda,plain,pallas}."""
    from epgpy_torch.models.cuda_xcomposite import (
        xcomposite_stage_mat_tables)

    args, kw = make_xcomp_case(case, natoms, nstage, seed)
    rng = np.random.default_rng(seed + 1)
    dens, taus, khi, T1, T2, g = args[11:17]
    C, V = len(dens), case.get("V", 2)
    val, tans = _x_tangents(
        torch, lambda k, t: xcomposite_stage_mat_tables(k, T1, t, g, taus),
        khi, T2, C)
    tans = [tuple(p * (1.0 + v // 2) for p in tans[v % 2]) for v in range(V)]
    mats = tuple(v.numpy() for v in val)
    dmats = [tuple(t[p].numpy() for p in range(3)) for t in tans]
    ddens = [np.zeros((C, natoms))] + [rng.uniform(-0.05, 0.05, (C, natoms))
                                       for _ in range(V - 1)]
    dens_b = np.broadcast_to(np.asarray(dens)[:, None], (C, natoms)).copy()
    return args[:11] + (dens_b, mats, dmats, ddens, args[17], args[18]), kw


def xcomp_tensors(torch, args, device, jac=False):
    """Composite EPG-X case inputs on `device`: float32 tensors, adci,
    shift, mia and mib int32 (taus and khi stay host values)."""
    def t(x, dt=None):
        return None if x is None else torch.as_tensor(
            np.asarray(x), dtype=dt or torch.float32, device=device)

    out = [t(a, torch.int32 if i in (6, 7, 9, 10) else None)
           for i, a in enumerate(args[:12])]
    if jac:
        out += [tuple(t(m) for m in args[12]),
                [tuple(t(m) for m in d) for d in args[13]],
                [t(d) for d in args[14]]]
        return tuple(out) + (t(args[15]), t(args[16]))
    return tuple(out) + (args[12], args[13], t(args[14]), t(args[15]),
                         t(args[16]), t(args[17]), t(args[18]))


def make_full_case(case, natoms, npulse, seed=0):
    """Numpy inputs of one full-ladder option case: make_case's without
    normalize (args and kwargs of fisp_full_echoes[_plain])."""
    args, kw = make_case(case, natoms, npulse, seed)
    del kw["normalize"]
    return args, kw


def make_design_case(case, natoms, necho=TSE_NECHO, seed=0):
    """Numpy inputs of one design option case: (args, kwargs) of
    cpmg_design_{cuda,plain,pallas} (exc, FA, phi, ESP, T1s, T2s)."""
    rng = np.random.default_rng(seed)
    FA = rng.uniform(60.0, 180.0, necho)
    phi = rng.uniform(0.0, 40.0, necho) if case.get("phase") else 0.0
    ESP = rng.uniform(6.0, 12.0, necho)
    T1 = rng.uniform(600.0, 1800.0, natoms)
    T2 = rng.uniform(40.0, 200.0, natoms)
    kw = dict(nstate=case.get("nstate", 2 * necho),
              second_order=case["second_order"])
    return (EXC, FA, phi, ESP, T1, T2), kw


def _atom_tensors(torch, args, kw, first, device):
    """The per-atom arguments (args[first:] and the DW-TSE diffusivities)
    as float32 tensors on `device`; exc and the per-echo values stay
    host values."""
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    kw = dict(kw)
    if kw.get("diffusion") is not None:
        kw["diffusion"] = kw["diffusion"][:4] + tuple(
            t(d) for d in kw["diffusion"][4:])
    return args[:first] + tuple(t(a) for a in args[first:]), kw


# -- operation and byte counts: the least time the card could take --

#: elementwise arithmetic (one operation per output element), fused
#: multiply-adds (two) and reductions (one per input element)
_ARITH = frozenset({"add", "sub", "rsub", "mul", "div", "neg", "exp", "sin",
                    "cos", "sqrt", "rsqrt", "reciprocal", "pow", "abs",
                    "log", "expm1", "square", "maximum", "minimum",
                    "clamp"})
_FUSED = frozenset({"addcmul", "addcdiv"})
_REDUCE = frozenset({"sum", "mean"})


def count_ops(torch, fn):
    """The floating-point operations fn() runs through PyTorch: each
    elementwise arithmetic call counts its output's elements (a fused
    multiply-add twice), a reduction its input's; copies, views and
    indexing count nothing.  A plain twin repeats its kernel's
    expressions, so on a twin this counts the kernel's arithmetic.  The
    twins' ``planes.sincospi`` counts as one cosine and one sine: its
    reduction of the half turns to [-1, 1] and their product with pi
    mirror how sincospif rounds, not work of the function."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from epgpy_torch.models import planes

    total = [0]
    counting = [True]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not counting[0]:
                return out
            name = func.overloadpacket.__name__.rstrip("_")
            if name in _ARITH or name in _FUSED:
                n = out.numel() if isinstance(out, torch.Tensor) else 1
                total[0] += n * (2 if name in _FUSED else 1)
            elif name in _REDUCE:
                total[0] += args[0].numel()
            return out

    def sincospi(x):
        counting[0] = False
        try:
            a = math.pi * (x - 2.0 * torch.round(x * 0.5))
        finally:
            counting[0] = True
        return torch.cos(a), torch.sin(a)

    kept = planes.sincospi
    planes.sincospi = sincospi
    try:
        with Count():
            fn()
    finally:
        planes.sincospi = kept
    return total[0]


def linear_ops(torch, call, natoms):
    """Operations of ``call(n)`` -- a plain twin on the first n atoms of
    the kernel's inputs, on the CPU -- at n = 2 and 4, extrapolated
    linearly to `natoms` (every atom does the same work; per-step
    scalars are the intercept)."""
    a = count_ops(torch, lambda: call(2))
    b = count_ops(torch, lambda: call(4))
    return a + (b - a) / 2.0 * (natoms - 2)


def reached_ops(torch, name, call, necho, nstate, natoms):
    """Operations of a CPMG-family function over only the ladder rows its
    train has reached, counted on its plain twin: after echo j (0-based)
    the state fills rows 0..min(2(j+1), nstate), so echo j is counted over
    that many rows instead of all nstate + 1 (its first half-stage has
    reached one row fewer: a slight over-count).

    ``call(k, n, m)`` runs the twin on the train's first k echoes at
    nstate n over the first m atoms, on the CPU.  One echo's operations
    are bilinear in its rows H and its live lanes L = j + 1 (the design
    twin's; the other twins have none), c0 + c1 H + c2 L + c3 H L, fitted
    exactly from echoes 1 and 2 at nstate 4 and 8; the set-up is the whole
    train's count at those depths less its echoes, affine in H.  The fit
    summed over every echo at nstate + 1 rows must give the twin's own
    full count, or this raises.  Returns the count extrapolated linearly
    in atoms to `natoms`."""
    def at(m):
        ops = {(k, n): count_ops(torch, lambda: call(k, n, m))
               for k in (1, 2, 3) for n in (4, 8)}
        fit, rhs = [], []
        for j in (1, 2):
            for n in (4, 8):
                fit.append([1.0, n + 1, j + 1, (n + 1) * (j + 1)])
                rhs.append(ops[(j + 1, n)] - ops[(j, n)])
        c = np.linalg.solve(np.array(fit), np.array(rhs, float))

        def train(rows):
            return sum(float(c @ [1.0, h, j + 1, h * (j + 1)])
                       for j, h in enumerate(rows))

        s4, s8 = (count_ops(torch, lambda: call(necho, n, m))
                  - train([n + 1] * necho) for n in (4, 8))
        H = nstate + 1
        setup = s4 + (s8 - s4) / 4.0 * (H - 5)
        full = setup + train([H] * necho)
        direct = count_ops(torch, lambda: call(necho, nstate, m))
        if not abs(full - direct) <= 1e-9 * direct:
            raise AssertionError(f"{name}: the per-echo operation fit gives "
                                 f"{full:.6g} for the full ladder, the twin "
                                 f"counts {direct}")
        reached = setup + train([min(2 * (j + 1), nstate) + 1
                                 for j in range(necho)])
        return reached, direct

    (ra, fa), (rb, fb) = at(2), at(4)
    reached = ra + (rb - ra) / 2.0 * (natoms - 2)
    full = fa + (fb - fa) / 2.0 * (natoms - 2)
    print(f"[bound] {name}: {reached:.4g} FLOP over the reached ladder rows "
          f"({reached / full:.3f} of the {full:.4g} over all nstate + 1)")
    return reached


def _cpu_train(torch, args, m, atom_idx, k, echo_idx):
    """_cpu_atoms of `args` with the per-echo arrays at `echo_idx` cut to
    the train's first k echoes."""
    return _cpu_atoms(torch, tuple(
        a[:k] if i in echo_idx else a for i, a in enumerate(args)),
        m, atom_idx)


def tensor_bytes(torch, *items):
    """Bytes of the tensors in `items` (tuples, lists and dicts walked)."""
    n = 0
    for x in items:
        if isinstance(x, torch.Tensor):
            n += x.numel() * x.element_size()
        elif isinstance(x, (tuple, list)):
            n += tensor_bytes(torch, *x)
        elif isinstance(x, dict):
            n += tensor_bytes(torch, *x.values())
    return n


def bound_fields(name, flops, nbytes):
    """The kernels line's bound and library keys: the larger of the
    operations over the FP32 peak and the bytes (each input read once,
    each output written once) over the HBM rate; no single PyTorch call
    computes these recurrences, so no library time."""
    t_ops = flops / PEAK_FP32 * 1e3
    t_mem = nbytes / PEAK_HBM * 1e3
    print(f"[bound] {name}: {flops:.4g} FLOP -> {t_ops:.4f} ms at the FP32 "
          f"peak; {nbytes:.4g} B -> {t_mem:.4f} ms at the HBM rate")
    return {"bound_ms": max(t_ops, t_mem),
            "bound_by": "operations" if t_ops >= t_mem else "bytes",
            "library_ms": None}


def _cpu_atoms(torch, args, n, atom_idx):
    """args with the per-atom tensors at `atom_idx` cut to their first n
    atoms, every tensor copied to the CPU."""
    out = []
    for i, a in enumerate(args):
        if isinstance(a, torch.Tensor):
            a = (a[:n] if i in atom_idx else a).cpu()
        out.append(a)
    return tuple(out)


@contextlib.contextmanager
def cpu_float64(config):
    """The port on the CPU in float64 (the oracles), then back."""
    old = (config.device(), config.precision())
    config.set_device("cpu")
    config.set_precision("float64")
    try:
        yield
    finally:
        config.set_device(old[0])
        config.set_precision(old[1])


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
    if case.get("runs"):
        # TR (and a per-pulse TE) repeat in runs of 1-40 pulses
        rr = np.random.default_rng(seed + 1)
        TRs = _runs(rr, npulse, 11.0, 16.0)
        if case.get("var_te"):
            TEs = _runs(rr, npulse, 2.0, 5.0)
    kw = dict(nstate=case.get("nstate", NSTATE),
              demodulate=case.get("demodulate", False),
              inversion=case.get("inversion"),
              inversion_df=case.get("inversion_df", True),
              normalize=case.get("normalize", False))
    if case.get("diffusion"):
        kw["diffusion"] = (6.0, 4.0, rng.uniform(0.5e-3, 3e-3, natoms))
        kw["diff_ramp"] = case["diffusion"] == "ramp"
    return (FA, phi, TRs, TEs, T1, T2, B1, df), kw


def _runs(rng, n, lo, hi):
    """(n,) values uniform in [lo, hi), each repeated over a run of 1-40."""
    lens = rng.integers(1, 41, n)
    return np.repeat(rng.uniform(lo, hi, n), lens)[:n]


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
    largest magnitude (a column that is all zeros, as dT1 of a one-echo
    CPMG train, must come out exactly zero)."""
    return [float(np.abs(got[..., c] - want[..., c]).max()
                  / max(np.abs(want[..., c]).max(), 1e-30))
            for c in range(want.shape[-1])]


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


def _cuda_ms(torch, fn, reps=5, warm=True):
    """Best of `reps` timed runs (CUDA events) after one warm-up, in ms;
    ``warm=False`` where the caller has just run fn() on the same inputs
    (a plain twin's comparison call), which serves as the warm-up."""
    if warm:
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
        if ("registers" in line or "smem" in line or "spill" in line
                or "properties for" in line):
            print(f"[build] {line.strip()}")


#: per-SM limits of sm_90 that decide occupancy: registers and their
#: allocation unit per warp, resident warps and blocks, shared memory and
#: what the runtime reserves of it per block
SM_REGS, SM_REG_UNIT, SM_WARPS, SM_BLOCKS = 65536, 256, 64, 32
SM_SMEM, SM_SMEM_RESERVED = 233472, 1024
#: streaming multiprocessors of an H100 SXM
SM_COUNT = 132


def ptxas_registers(log, what="registers"):
    """{kernel (mangled name): registers} from the ``-Xptxas -v`` lines of
    the build log; with what="stack", {kernel: stack-frame bytes}."""
    regs, name = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for")[1].strip()
        elif name and what == "stack" and "bytes stack frame" in line:
            regs[name] = int(line.split("bytes stack frame")[0].split()[-1])
        elif name and "Used" in line and "registers" in line:
            if what == "registers":
                regs[name] = int(line.split("Used")[1].split()[0])
            name = None
    return regs


def resident_warps(regs, warps, smem):
    """Warps one SM holds of a kernel with `regs` registers per thread,
    `warps` per block and `smem` bytes of shared memory per block: the
    least of what the registers, the shared memory and the SM's warp and
    block slots admit, each in whole blocks; and the first two alone."""
    warp_regs = -(-regs * 32 // SM_REG_UNIT) * SM_REG_UNIT
    by_regs = SM_REGS // warp_regs // warps
    by_smem = SM_SMEM // (smem + SM_SMEM_RESERVED)
    blocks = min(by_regs, by_smem, SM_WARPS // warps, SM_BLOCKS)
    return blocks * warps, by_regs * warps, by_smem * warps


#: one SASS instruction: its address, an optional predicate, the opcode
SASS_OP = re.compile(
    r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_]*)")
#: SASS opcode classes of the instruction mix that phase_occupancy prints
SASS_CLASSES = {
    "fp32": ("FFMA", "FMUL", "FADD", "MUFU"),
    "shared": ("LDS", "STS"),
    "shuffle": ("SHFL",),
    "local": ("LDL", "STL"),
    "integer": ("IMAD", "IADD3", "LEA", "LOP3", "SHF", "ISETP"),
    "move": ("MOV", "FSEL", "SEL"),
    "branch": ("BRA", "BSSY", "BSYNC", "WARPSYNC"),
}


def sass_mix(lib, keys, kernels=()):
    """{key: {class: static instruction count, "total": n}} of the first
    kernel in the library whose mangled name holds each key, from
    ``cuobjdump -sass`` (None when the tool is missing); with `kernels`,
    the mangled names of those kernels, only they are disassembled (the whole
    library takes ~25 s), and the whole library is dumped only if that
    leaves a key without its kernel."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.isfile(tool):
        return None

    def dump(*only):
        return subprocess.run([tool, "-sass", *only, str(lib)],
                              capture_output=True, text=True).stdout

    def count(sass):
        mix = {}
        for part in sass.split("Function : ")[1:]:
            name = part.split("\n", 1)[0]
            key = next((k for k in keys if k in name and k not in mix), None)
            if key is None:
                continue
            ops = [m.group(1) for m in SASS_OP.finditer(part)]
            counts = {c: sum(op in names for op in ops)
                      for c, names in SASS_CLASSES.items()}
            mix[key] = dict(counts, total=len(ops))
        return mix

    mix = count(dump("-fun", ",".join(kernels))) if kernels else {}
    return mix if len(mix) == len(keys) else count(dump())


def phase_occupancy():
    """Registers and stack frame (ptxas), shared memory per block, resident
    warps per SM and the static SASS instruction mix of the warp-row CPMG
    kernels and the segmented FISP, ME-GRE, composite, EPG-X GRE, DESS and
    composite EPG-X Jacobian kernels, the Hessian kernel's two passes, the
    segmented CPMG, FISP dictionary, composite, EPG-X GRE, composite EPG-X
    and ME-GRE primal kernels and the bSSFP primal kernel at their
    main-path geometries (the primal ones with the waves of their grids);
    the registers and stack of every xgre and composite EPG-X Jacobian
    instance and every CPMG, FISP dictionary, composite, EPG-X GRE,
    composite EPG-X and ME-GRE primal instance."""
    from epgpy_torch import _build
    from epgpy_torch.models import cuda_bssfp, cuda_composite, cuda_dess, \
        cuda_fisp, cuda_hessian, cuda_megre, cuda_mse, cuda_msedesign, \
        cuda_xcomposite, cuda_xgre

    log = _build.build_info()["log"]
    regs, stack = ptxas_registers(log), ptxas_registers(log, "stack")

    def of(key, table=regs):
        hits = [r for n, r in table.items() if key in n]
        return hits[0] if len(hits) == 1 else None

    # the segmented kernels' main-path instances (R rows per lane): FISP
    # with G = 3 and 4 groups at nstate NSTATE, ME-GRE at MEGRE_NSTATE with
    # its echoes
    seg = []
    for d in (False, True):
        geo = cuda_fisp.fisp_jac_geometry(NSTATE, d)
        seg.append((f"fisp_jac nstate {NSTATE}{' dD' if d else ''}",
                    f"fisp_jac_kernelILi{geo['R']}ELi{4 if d else 3}EE", geo))
    geo = cuda_megre.megre_jac_geometry(MEGRE_NSTATE, len(MEGRE_TES))
    seg.append((f"megre_jac nstate {MEGRE_NSTATE} m {len(MEGRE_TES)}",
                f"megre_jac_kernelILi{geo['R']}EE", geo))
    geo = cuda_composite.comp_jac_geometry(COMPJ_NSTATE, 4)
    seg.append((f"composite_jac nstate {COMPJ_NSTATE} 4 groups",
                f"composite_jac_kernelILi5ELi{geo['R']}EE", geo))
    # the Hessian kernel's two passes at the flagship's second order: the
    # lane pass stages its echoes (and a 36-float table per pulse), the
    # atom pass (one warp per block) only its rotation table (40 bytes per
    # pulse)
    geo = cuda_hessian.hess_geometry(NSTATE, True)
    hgeo = dict(geo, pulses=cuda_hessian.HESS_PULSES)
    seg.append((f"fisp_hess lane pass nstate {NSTATE}",
                f"hess_lane_kernelILb1ELi{geo['R']}EE", hgeo))
    seg.append((f"fisp_hess atom pass nstate {NSTATE}",
                f"hess_atom_kernelILb1ELi{geo['R']}EE",
                dict(hgeo, warps=1, smem=40 * cuda_hessian.HESS_PULSES)))
    # the qMT fit's xgre Jacobian (C = 2, G = 3) and the DESS mapping's
    geo = cuda_xgre.xgre_jac_geometry(QMT_NSTATE, 2, 3)
    seg.append((f"xgre_jac nstate {QMT_NSTATE} C 2 G 3",
                f"xgre_jac_kernelILi2ELi3ELi{geo['R']}EE", geo))
    geo = cuda_dess.dess_jac_geometry(DESS_NSTATE)
    seg.append((f"dess_jac nstate {DESS_NSTATE}",
                f"dess_jac_kernelILi{geo['R']}EE", geo))
    # the exchange-rate fit's composite EPG-X Jacobian (C = 2, G = 2, four
    # table entries) and the published CPMG train (with DW-TSE too)
    geo = cuda_xcomposite.xcomp_jac_geometry(XCOMP_NSTATE, 2, 2, 4)
    seg.append((f"xcomposite_jac nstate {XCOMP_NSTATE} C 2 G 2 nmat 4",
                f"xcomp_jac_kernelILi2ELi2ELi{geo['R']}ELb1EE", geo))
    for dif in (False, True):
        geo = cuda_mse.cpmg_geometry(MSE_NSTATE, dif)
        seg.append((f"cpmg nstate {MSE_NSTATE}{' DW' if dif else ''}",
                    f"cpmg_kernelILi{geo['R']}ELb{int(dif)}EE",
                    dict(geo, pulses=geo["echoes"])))
    # the segmented primal kernels at their main paths, with the waves of
    # their grids: the FISP dictionary (and DW-FISP's), the cardiac MRF
    # and MPRAGE composite trains
    waves_of = {}
    for dif in (False, True):
        geo = cuda_fisp.fisp_half_geometry(NSTATE, dif)
        hs = cuda_fisp.half_static_rows(NSTATE, geo["R"])
        what = f"fisp_half nstate {NSTATE}{' DW' if dif else ''}"
        seg.append((what, f"fisp_half_kernelILi{geo['R']}ELi{hs}ELb{int(dif)}"
                          f"EE", geo))
        waves_of[what] = NATOMS
    for nst, n in ((CMRF_NSTATE, len(cardiac_grid())),
                   (MPR_NSTATE, MPR_NVOX)):
        geo = cuda_composite.comp_geometry(nst)
        hs = cuda_fisp.half_static_rows(nst, geo["R"])
        what = f"composite nstate {nst}"
        seg.append((what, f"composite_kernelILi{geo['R']}ELi{hs}EE", geo))
        waves_of[what] = n
    # the primal EPG-X kernels at their main paths: the spoiled and
    # balanced MT-GRE trains (two pools, nstate XGRE_NSTATE and 0) and the
    # MT-prepared train (two pools, nstate XCOMP_NSTATE, four table
    # entries)
    for nst, n in ((XGRE_NSTATE, XGRE_ATOMS), (0, XBSSFP_ATOMS)):
        geo = cuda_xgre.xgre_geometry(nst, 2)
        what = f"xgre nstate {nst} C 2"
        seg.append((what, f"xgre_kernelILi2ELi{geo['R']}ELb{int(geo['one'])}"
                          f"EE", geo))
        waves_of[what] = n
    geo = cuda_xcomposite.xcomp_geometry(XCOMP_NSTATE, 2, 4)
    what = f"xcomposite nstate {XCOMP_NSTATE} C 2 nmat 4"
    seg.append((what, f"xcomp_kernelILi2ELi{geo['R']}ELb{int(geo['one'])}"
                      f"ELb{int(geo['shared'])}EE", geo))
    waves_of[what] = 2 * XCOMP_NAT
    # the primal ME-GRE kernel on the bench's train (one lane of nstate + 1
    # rows: the instance of its length) and the golden train's two lanes
    # (nstate 12); the primal bSSFP kernel (one thread per atom, the
    # chunk's 32-pulse table)
    for nst, n in ((MEGRE_NSTATE, MEGRE_ATOMS), (12, None)):
        geo = cuda_megre.megre_geometry(nst, len(MEGRE_TES))
        what = f"megre nstate {nst} m {len(MEGRE_TES)}"
        seg.append((what, f"megre_kernelILi{geo['R']}ELi"
                          f"{geo['R'] if geo['one'] else 0}EE", geo))
        if n:
            waves_of[what] = n
    geo = dict(R=1, W=1, L=32, warps=cuda_bssfp.BLOCK // 32, atoms=
               cuda_bssfp.BLOCK, pulses=cuda_bssfp.BSSFP_PULSES,
               smem=32 * cuda_bssfp.BSSFP_PULSES)
    what = "bssfp"
    seg.append((what, "bssfp_kernelENS", geo))
    waves_of[what] = BSSFP_ATOMS
    for what, key, geo in seg:
        r, frame = of(key), of(key, stack)
        if r is None:
            print(f"[occupancy] {what}: registers not measured (no ptxas "
                  f"line: the library was built before this run)")
            continue
        res, by_regs, by_smem = resident_warps(r, geo["warps"], geo["smem"])
        waves = ""
        if what in waves_of:
            blocks = -(-waves_of[what] // geo["atoms"])
            waves = (f"; {blocks} blocks over {waves_of[what]} atoms = "
                     f"{blocks / (SM_COUNT * (res // geo['warps'])):.3f} "
                     f"waves of {SM_COUNT} SMs")
        print(f"[occupancy] {what}: {r} registers, {frame} B stack frame, "
              f"{geo['warps']} warps ({geo['L']} ladders of {geo['W']} "
              f"lanes x {geo['R']} rows each), {geo['pulses']} pulses per "
              f"chunk and "
              f"{geo['smem']} B of shared memory per block; {res} resident "
              f"warps per SM (registers admit {by_regs}, shared memory "
              f"{by_smem}){waves}")

    for name, pattern, fields in (
            ("xgre_jac", r"xgre_jac_kernelILi(\d+)ELi(\d+)ELi(\d+)EE",
             "C, G, R"),
            ("xcomposite_jac", r"xcomp_jac_kernelILi(\d+)ELi(\d+)ELi(\d+)"
             r"ELb(\d)EE", "C, G, R, shared table"),
            ("cpmg", r"cpmg_kernelILi(\d+)ELb(\d)EE", "R, DW-TSE"),
            ("fisp_half", r"fisp_half_kernelILi(\d+)ELi(\d+)ELb(\d)EE",
             "R, static rows, DW-FISP"),
            ("composite", r"composite_kernelILi(\d+)ELi(\d+)EE",
             "R, static rows"),
            ("xgre", r"xgre_kernelILi(\d+)ELi(\d+)ELb(\d)EE",
             "C, R, one lane"),
            ("xcomposite", r"xcomp_kernelILi(\d+)ELi(\d+)ELb(\d)ELb(\d)EE",
             "C, R, one lane, shared table"),
            ("megre", r"megre_kernelILi(\d+)ELi(\d+)EE", "R, static rows")):
        inst = sorted((tuple(int(v) for v in m.groups()), r, stack.get(n))
                      for n, r in regs.items()
                      for m in [re.search(pattern, n)] if m)
        if inst:
            print(f"[occupancy] {name} instances ({fields}): registers / "
                  f"stack bytes: " + ", ".join(
                      f"{','.join(map(str, k))}: {r} / {st}"
                      for k, r, st in inst))
    rows = []
    for dif in (False, True):
        warps = cuda_mse.mse_jac_block_size(MSE_NSTATE, dif)
        rows.append((f"cpmg_jac nstate {MSE_NSTATE}{' DW' if dif else ''}",
                     of(f"cpmg_jac_kernelILb{int(dif)}E"), warps,
                     cuda_mse.jac_block_smem(MSE_NSTATE, warps, dif)))
    for so in (True, False):
        E, n = TSE_NECHO, 2 * TSE_NECHO
        tile = cuda_msedesign.design_tile(E, n, so)
        rows.append((f"cpmg_design E {E} nstate {n} order {1 + so}",
                     of(f"cpmg_design_kernelILb{int(so)}E"), tile,
                     cuda_msedesign.design_block_smem(n, tile, so)))
    for what, r, warps, smem in rows:
        if r is None:
            print(f"[occupancy] {what}: registers not measured (no ptxas "
                  f"line: the library was built before this run)")
            continue
        res, by_regs, by_smem = resident_warps(r, warps, smem)
        print(f"[occupancy] {what}: {r} registers, {warps} warps and "
              f"{smem} B of shared memory per block; {res} resident warps "
              f"per SM (registers admit {by_regs}, shared memory "
              f"{by_smem})")
    keys = ("cpmg_jac_kernelILb0E", "cpmg_design_kernelILb1E") + tuple(
        key for _, key, _ in seg)
    t0 = time.perf_counter()
    mix = sass_mix(_build.build_info()["path"], keys,
                   [n for n in regs if any(k in n for k in keys)])
    print(f"[time] phase_occupancy: cuobjdump and the SASS count "
          f"{time.perf_counter() - t0:.1f} s")
    for key in keys:
        m = (mix or {}).get(key)
        print(f"[occupancy] {key} SASS instructions: "
              + (", ".join(f"{k} {v}" for k, v in m.items()) if m
                 else "not measured (no cuobjdump)"))


def half_vs_twin(torch, case, natoms, npulse):
    """The FISP dictionary kernel against its plain twin on one option
    case: (max |delta| over re and im, whether the kernel's echoes are
    finite); raises unless the wrapper launched the kernel once."""
    from epgpy_torch.models import cuda_fisp

    args, kw = _tensors(torch, *make_case(case, natoms, npulse), DEVICE)
    before = cuda_fisp.LAUNCHES
    kre, kim = cuda_fisp.fisp_dictionary_cuda(*args, **kw)
    torch.cuda.synchronize()
    if cuda_fisp.LAUNCHES != before + 1:
        raise AssertionError(f"case {case['name']}: the kernel did not run")
    pre, pim = cuda_fisp.fisp_dictionary_plain(*args, **kw)
    delta = max(float((kre - pre).abs().max()),
                float((kim - pim).abs().max()))
    return delta, bool(torch.isfinite(kre).all() and torch.isfinite(kim).all())


def phase_cases(torch, natoms=4096, npulse=CASE_NPULSE):
    """Kernel vs plain twin over the option cases, then the segmented
    kernel's edges (HALF_EDGE_CASES, trains HALF_EDGE_PULSES pulses longer
    than the ladder) and ragged shapes (HALF_SHAPES at nstate NSTATE and
    40); returns max |delta|."""
    runs = [("options", case, natoms, npulse)
            for case in OPTION_CASES + [dict(name="nstate40", nstate=40,
                                             inversion=20.0, df=True)]]
    runs += [("edges", case, HALF_EDGE_ATOMS,
              case.get("nstate", NSTATE) + 1 + HALF_EDGE_PULSES)
             for case in HALF_EDGE_CASES]
    runs += [("shapes", dict(HALF_RAGGED_CASE, name=f"ragged_n{nst}",
                             nstate=nst), n, p)
             for n, p in HALF_SHAPES for nst in (NSTATE, 40)]
    worst = 0.0
    wall = dict.fromkeys(("options", "edges", "shapes"), 0.0)
    for part, case, n, p in runs:
        t0 = time.perf_counter()
        delta, ok = half_vs_twin(torch, case, n, p)
        print(f"[cases] {case['name']:14s} B={n:5d} P={p:4d} "
              f"nstate={case.get('nstate', NSTATE):3d} "
              f"max|kernel - plain| = {delta:.3e}")
        if not ok or not delta <= TOL_KERNEL:
            raise AssertionError(f"case {case['name']} (B={n}, P={p}): "
                                 f"kernel vs plain twin {delta:.3e} > "
                                 f"{TOL_KERNEL} or not finite")
        worst = max(worst, delta)
        wall[part] += time.perf_counter() - t0
    _print_wall("phase_cases", wall)
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
    args = _match_args(fisp_dispatch, fisp_dispatch.match_fisp(seq))

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
    memo_s, nomemo_s = _memo_pair(torch, lambda: epg.simulate(
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
          f"= {NATOMS / memo_s:.4g} atoms/s; with the preamble recomputed "
          f"each call {nomemo_s:.4f} s {tag}")
    print(f"[numbers] general op loop, {g_atoms} atoms x {g_pulses} TRs: "
          f"{gen_s:.4f} s = {g_atoms / gen_s:.4g} atoms/s {tag}")
    flops = linear_ops(torch, lambda n: cuda_fisp.fisp_echoes_plain(
        *_cpu_atoms(torch, args, n, (4, 5, 6, 7)), nstate=NSTATE), NATOMS)
    nbytes = tensor_bytes(torch, args, kernel())
    return {"name": "fisp_half", "route": "cuda",
            "source": "epgpy_torch/csrc/fisp_half.cu",
            "replaces": "epgpy_tpu/models/pallas_fisp.py:270",
            "launches": run["launches"], "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms,
            **bound_fields("fisp_half", flops, nbytes)}


def phase_jac_cases(torch, natoms=4096, npulse=JAC_CASE_N):
    """Jacobian kernel vs plain twin over the option cases, the segmented
    layout's edges (JAC_EDGE_CASES) and ragged shapes (SEG_SHAPES);
    returns the worst fingerprint |delta| and the worst per-column
    relative error."""
    from epgpy_torch.models import cuda_fisp

    runs = [(case, natoms, npulse) for case in JAC_CASES + [
        dict(name="nstate40", nstate=40, inversion=20.0, df=True)]]
    runs += [(case, *SEG_EDGE_SHAPE) for case in JAC_EDGE_CASES]
    runs += [(case, n, p) for n, p in SEG_SHAPES for case in JAC_CASES
             if case["name"] == SEG_RAGGED_CASES["fisp_jac"]]
    worst_sig = worst_col = 0.0
    for case, natoms, npulse in runs:
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
        print(f"[jac-cases] {case['name']:14s} B={natoms:5d} P={npulse:4d} "
              f"nstate={kw['nstate']:2d} max|kernel - plain| = {sig:.3e}, "
              f"per column "
              f"{', '.join(f'{c:.2e}' for c in cols)}")
        if not ok or not sig <= TOL_KERNEL or not max(cols) <= TOL_JAC_KERNEL:
            raise AssertionError(
                f"case {case['name']} (B={natoms}, P={npulse}): Jacobian "
                f"kernel vs plain twin "
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
    with cpu_float64(config):
        _, (dre, dim) = mrf.fisp_mrf_jacobian(
            FA, TR, TE, T1[:8], T2[:8], B1[:8], phi=90.0,
            variables=("T1", "T2", "B1"), nstate=NSTATE)
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
    def call():
        return epg.simulate(seq, max_nstate=NSTATE, asarray=False,
                            probe=probes)

    memo_s = _host_s(torch, call, reps=2)
    return dict(seq=seq, launches=launches, first_s=first_s, memo_s=memo_s,
                probe_err=probe_err, col_err=max(cols), simulate=call)


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
    p_ms = _cuda_ms(torch, plain, reps=1, warm=False)
    tag = f"({card})"
    print(f"[numbers] fisp_jac kernel, {NATOMS} atoms x {NPULSE} pulses: "
          f"{k_ms:.3f} ms = {NATOMS / (k_ms / 1e3):.4g} atoms/s {tag}")
    print(f"[numbers] Jacobian plain twin on the card, same shape: "
          f"{p_ms:.3f} ms {tag}")
    print(f"[numbers] simulate() Jacobian end to end, first call (match + "
          f"kernel): {run['first_s']:.3f} s; memoized match: "
          f"{run['memo_s']:.4f} s {tag}")
    _split_events(torch, "simulate() FISP Jacobian", "fisp_jac",
                  run["simulate"], card)
    flops = linear_ops(torch, lambda n: cuda_fisp.fisp_jacobian_echoes_plain(
        *_cpu_atoms(torch, args, n, (4, 5, 6, 7)), nstate=NSTATE), NATOMS)
    nbytes = tensor_bytes(torch, args, kernel())
    return {"name": "fisp_jac", "route": "cuda",
            "source": "epgpy_torch/csrc/fisp_jac.cu",
            "replaces": "epgpy_tpu/models/pallas_fisp.py:458",
            "launches": run["launches"], "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms,
            **bound_fields("fisp_jac", flops, nbytes)}


def phase_hess_cases(torch, natoms=64):
    """Hessian kernel vs plain twin over every option, the two-pass
    kernel's edges (HESS_EDGE_CASES) and ragged shapes (HESS_SHAPES);
    returns the worst per-block relative error."""
    from epgpy_torch.models import cuda_hessian

    runs = [("options", case, natoms, HESS_CASE_N) for case in HESS_CASES]
    runs += [("edges", case, HESS_EDGE_ATOMS,
              max(HESS_EDGE_N, case["nstate"] + 10))
             for case in HESS_EDGE_CASES]
    runs += [("shapes", dict(name=f"ragged_n{ns}", nstate=ns, te=te,
                             inversion=inv), n, p) for n, p in HESS_SHAPES
             for ns, te, inv in ((1, 5.0, 20.0), (NSTATE, None, None))]
    worst, wall = 0.0, dict.fromkeys(("options", "edges", "shapes"), 0.0)
    for part, case, natoms, npulse in runs:
        t0 = time.perf_counter()
        args, kw = make_hess_case(case, natoms, npulse)
        targs, _ = _tensors(torch, args, {}, "cuda")
        k = cuda_hessian.fisp_hessian_cuda(*targs, **kw)
        p = cuda_hessian.fisp_hessian_plain(*targs, **kw)
        errs = hess_block_errors(k, p)
        parts = [t for pair in k.values() for t in pair]
        ok = all(bool(torch.isfinite(t).all()) for t in parts)
        upper = max(float(torch.triu(t, diagonal=1).abs().max())
                    for t in parts if t.ndim == 3)
        err = max(errs.values())
        print(f"[hess-cases] {case['name']:22s} B={natoms:4d} N={npulse:3d} "
              f"max per-block |kernel - plain| = {err:.3e}; pulse > echo "
              f"entries max {upper:.1e}")
        if not ok or not err <= TOL_HESS_KERNEL or upper != 0.0:
            raise AssertionError(
                f"case {case['name']}: Hessian kernel vs plain twin "
                f"{err:.3e} > {TOL_HESS_KERNEL}, non-finite, or nonzero "
                f"pulse > echo entries ({upper:.1e})")
        worst = max(worst, err)
        wall[part] += time.perf_counter() - t0
    _print_wall("phase_hess_cases", wall)
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
    with cpu_float64(config):
        fa = torch.tensor(FA0, requires_grad=True)
        tr = torch.tensor(TR0, requires_grad=True)
        loss = mrf_design_loss(fa, tr, T1[:8], T2[:8], ridge=0.0, **kw)
        oracle = (loss.detach(),) + torch.autograd.grad(loss, (fa, tr))
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


def hess_kernel_ops(torch, N, nstate, second_order):
    """Operations per atom of the two-pass Hessian kernel's recurrence
    (fisp_hess.cu), counted by ``count_ops`` on one step of its groups on
    one ladder: the atom pass's N steps of P, U1, U2, and per chain (A,
    T) the N (N + 1) / 2 steps of a lane from its own pulse on, the seed
    terms once (a seeded step costs a plain one); the shifts move data and
    count nothing, as on the twins."""
    from epgpy_torch.models import planes

    H = int(nstate) + 1

    def step_ops(C):
        one = torch.ones((H, 1), dtype=torch.float64)
        groups = [tuple(one.clone() for _ in range(6)) for _ in range(C)]
        rc = tuple(torch.ones(1, dtype=torch.float64) for _ in range(10))
        cF, cZ, dcZ1, dcF2, e2, de2, rec = (torch.ones(1, dtype=torch.float64)
                                            for _ in range(7))

        def step():
            y = [planes.apply_rot(rc, g) for g in groups]
            echo = [e2 * y[0][0][0], e2 * y[0][1][0]]
            n0 = [cF * v for v in y[0][:4]] + [cZ * v for v in y[0][4:]]
            n0[4][0] = n0[4][0] + rec
            if C == 3:
                echo += [e2 * y[1][0][0], e2 * y[1][1][0],
                         e2 * y[2][0][0] + de2 * y[0][0][0],
                         e2 * y[2][1][0] + de2 * y[0][1][0]]
                n1 = [cF * v for v in y[1][:4]] + [
                    cZ * v + dcZ1 * p for v, p in zip(y[1][4:], y[0][4:])]
                n1[4][0] = n1[4][0] + rec
                [cF * v + dcF2 * p for v, p in zip(y[2][:4], y[0][:4])]
                [cZ * v for v in y[2][4:]]
            return echo
        return count_ops(torch, step)

    lanes = N * (N + 1) // 2
    return N * step_ops(3) + 2 * lanes * step_ops(3 if second_order else 1)


def phase_hess_numbers(torch, epg, card, run):
    """Hessian kernel and plain twin at the flagship shape, the
    assembly's share; returns the kernel's JSON entry."""
    from epgpy_torch import fisp_dispatch
    from epgpy_torch.models import cuda_hessian

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
    p_ms = _cuda_ms(torch, plain, reps=1, warm=False)

    seq, probes = run["seq"], run["probes"]

    def memoized():
        return epg.simulate(seq, max_nstate=NSTATE, asarray=False,
                            probe=probes)

    # both passes' kernels (hess_atom_kernel, hess_lane_kernel)
    split = _profile_split(torch, memoized, "hess_")
    tag = f"({card})"
    print(f"[numbers] fisp_hess kernel, {HESS_ATOMS} atoms x {HESS_N} "
          f"pulses (3 x {2 * HESS_N}): {k_ms:.3f} ms = "
          f"{HESS_ATOMS / (k_ms / 1e3):.4g} atoms/s {tag}")
    print(f"[numbers] Hessian plain twin on the card, same shape: "
          f"{p_ms:.3f} ms {tag}")
    print(f"[numbers] simulate() Hessian end to end, first call (match + "
          f"kernel + assembly): {run['first_s']:.3f} s; memoized match: "
          f"{run['memo_s'] * 1e3:.2f} ms {tag}")
    _print_split("simulate() Hessian", "fisp_hess", split, card)
    _split_events(torch, "simulate() Hessian", "fisp_hess", memoized, card)
    flops = linear_ops(torch, lambda n: cuda_hessian.fisp_hessian_plain(
        *_cpu_atoms(torch, args, n, (3, 4)), nstate=NSTATE), HESS_ATOMS)
    nbytes = tensor_bytes(torch, args, kernel())
    work = hess_kernel_ops(torch, HESS_N, NSTATE, True) * HESS_ATOMS
    # the bound counts the function's own work (the atom pass, each chain
    # from its own pulse, the seed terms once); the twin also multiplies
    # the seed terms by a zero mask at every other pulse
    print(f"[bound] fisp_hess: the twin's recurrence counts {flops:.4g} "
          f"FLOP -> {flops / PEAK_FP32 * 1e3:.4f} ms at the FP32 peak; the "
          f"bound takes the function's own {min(flops, work):.4g}")
    return {"name": "fisp_hess", "route": "cuda",
            "source": "epgpy_torch/csrc/fisp_hess.cu",
            "replaces": "epgpy_tpu/models/pallas_hessian.py:83",
            "launches": run["launches"], "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms,
            **bound_fields("fisp_hess", min(flops, work), nbytes)}


# -- the CPMG family: kernels vs twins, paths, T2/B1 mapping, TSE design --


def phase_mse_cases(torch, natoms=4096, jac=False):
    """The CPMG kernel (or, with `jac`, its Jacobian kernel) vs its plain
    twin over the option cases at the published depth and at the ragged
    shapes (MSE_JAC_SHAPES; CPMG_SHAPES), and for the primal its own edges
    (CPMG_EDGE_CASES); returns the worst echo |delta| and (jac) the worst
    per-column relative error."""
    from epgpy_torch.models import cuda_mse

    tag = "mse-jac-cases" if jac else "mse-cases"
    runs = [(case, natoms, MSE_NECHO) for case in MSE_CASES]
    runs += [(case, n, e) for n, e in (MSE_JAC_SHAPES if jac else CPMG_SHAPES)
             for case in MSE_CASES if case["name"] in MSE_RAGGED_CASES]
    if not jac:
        runs += [(case, CPMG_EDGE_SHAPE[0],
                  case.get("necho", CPMG_EDGE_SHAPE[1]))
                 for case in CPMG_EDGE_CASES]
    worst_sig = worst_col = 0.0
    for case, n, necho in runs:
        args, kw = _atom_tensors(torch, *make_mse_case(case, n, necho), 5,
                                 "cuda")
        if jac:
            (kre, kim), (kdre, kdim) = cuda_mse.cpmg_jacobian_cuda(*args, **kw)
            (pre, pim), (pdre, pdim) = cuda_mse.cpmg_jacobian_plain(*args,
                                                                    **kw)
            cols = col_errors(torch.complex(kdre, kdim).cpu().numpy(),
                              torch.complex(pdre, pdim).cpu().numpy())
            parts = (kre, kim, kdre, kdim)
        else:
            before = cuda_mse.LAUNCHES
            kre, kim = cuda_mse.cpmg_dictionary_cuda(*args, **kw)
            if cuda_mse.LAUNCHES != before + 1:
                raise AssertionError(f"case {case['name']}: not one launch")
            pre, pim = cuda_mse.cpmg_dictionary_plain(*args, **kw)
            cols, parts = [0.0], (kre, kim)
        sig = max(float((kre - pre).abs().max()),
                  float((kim - pim).abs().max()))
        ok = all(bool(torch.isfinite(t).all()) for t in parts)
        print(f"[{tag}] {case['name']:15s} B={n:4d} E={necho:2d} "
              f"nstate={kw['nstate']:3d} max|kernel - plain| = {sig:.3e}"
              + (f", per column {', '.join(f'{c:.2e}' for c in cols)}"
                 if jac else ""))
        if not ok or not sig <= TOL_KERNEL or not max(cols) <= TOL_JAC_KERNEL:
            raise AssertionError(
                f"case {case['name']} (B={n}, E={necho}): CPMG"
                f"{' Jacobian' if jac else ''} kernel vs plain twin "
                f"{sig:.3e} / {max(cols):.3e} over {TOL_KERNEL} / "
                f"{TOL_JAC_KERNEL} or not finite")
        worst_sig, worst_col = max(worst_sig, sig), max(worst_col, max(cols))
    return worst_sig, worst_col


def _causal_max(torch, out):
    """The largest |entry| with variable > echo over the (B, E, E)
    blocks of a design output."""
    return max(float(torch.triu(t, diagonal=1).abs().max())
               for pair in out.values() for t in pair if t.ndim == 3)


def phase_design_cases(torch, natoms=64):
    """The design kernel vs its plain twin, first and second order, per
    output block, over the option cases and the ragged shapes of
    DESIGN_SHAPES, and its variable > echo entries exactly zero; returns
    the worst per-block relative error."""
    from epgpy_torch.models import cuda_msedesign

    runs = [(case, natoms, TSE_NECHO) for case in DESIGN_CASES]
    runs += [(dict(name=f"o{2 if so else 1}", second_order=so), n, e)
             for n, e in DESIGN_SHAPES for so in (True, False)]
    worst = 0.0
    for case, n, necho in runs:
        args, kw = _atom_tensors(
            torch, *make_design_case(case, n, necho), 4, "cuda")
        k = cuda_msedesign.cpmg_design_cuda(*args, **kw)
        p = cuda_msedesign.cpmg_design_plain(*args, **kw)
        errs = hess_block_errors(k, p)
        ok = all(bool(torch.isfinite(t).all()) for pair in k.values()
                 for t in pair)
        upper = _causal_max(torch, k)
        err = max(errs.values())
        tile = cuda_msedesign.design_tile(necho, kw["nstate"],
                                          kw["second_order"])
        print(f"[design-cases] {case['name']:14s} B={n:4d} E={necho:2d} "
              f"nstate={kw['nstate']:3d} tile={tile} {len(k)} blocks, max "
              f"per-block |kernel - plain| = {err:.3e}; variable > echo "
              f"entries max {upper:.1e}")
        if not ok or not err <= TOL_DESIGN_KERNEL or upper != 0.0:
            raise AssertionError(
                f"case {case['name']} (B={n}, E={necho}): design kernel vs "
                f"plain twin {err:.3e} > {TOL_DESIGN_KERNEL}, non-finite, "
                f"or nonzero variable > echo entries ({upper:.1e})")
        worst = max(worst, err)
    return worst


def mse_grid(nt2, natt):
    """The published sweep: nt2 T2 in 20-60 ms, natt attenuations in
    0.2-1 (bench.py:measure_mse)."""
    return np.linspace(20.0, 60.0, nt2), np.linspace(0.2, 1.0, natt)


def mse_sequence(epg, T2, att, *, tracked=False, dw=None):
    """The published CPMG train as a user writes it: [T(90, 90)] + [S(1),
    E(TE/2, T1, [T2]), T(180 att, 0), S(1), E(TE/2, T1, [T2]), ADC] x 18
    (outputs (18, att, T2)); with `tracked` the E ops track T1 and T2;
    ``dw=(D1, D2)`` makes it a DW-TSE train, E, S(1), D in each half."""
    e = epg.E(MSE_TE / 2, MSE_T1, [np.asarray(T2, float)],
              order1=["T1", "T2"] if tracked else False)
    t = epg.T(180.0 * np.asarray(att, float), 0.0)
    seq = [epg.T(90, 90)]
    for _ in range(MSE_NECHO):
        if dw is None:
            seq += [epg.S(1), e, t, epg.S(1), e, epg.ADC]
        else:
            seq += [e, epg.S(1), dw[0], t, e, epg.S(1), dw[1], epg.ADC]
    return seq


def mse_kernel_args(torch, T2, att):
    """cpmg_{dictionary,jacobian}_cuda arguments of the published train
    over the (att, T2) grid, atoms att-major as simulate() lays them."""
    a, t2 = np.meshgrid(att, T2, indexing="ij")
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32),  # noqa: E731
                                    device="cuda")
    return (EXC, np.full(MSE_NECHO, 180.0), 0.0, MSE_TE / 2, MSE_TE / 2,
            f32(np.full(a.size, MSE_T1)), f32(t2.ravel()), f32(a.ravel()))


def _mse_pick(nt2, natt):
    """8 (att, T2) grid indices to hold against the float64 path."""
    return ([0, natt - 1],
            [0, nt2 // 3, (2 * nt2) // 3, nt2 - 1])


def phase_mse_path(torch, epg):
    """The published CPMG train through simulate() at the published and the
    scaled grid, and the scaled grid through cpmg_dictionary_cuda; returns
    the run's facts."""
    from epgpy_torch import config, fisp_dispatch
    from epgpy_torch.models import cuda_mse

    T2p, attp = mse_grid(*MSE_GRID)
    T2s, atts = mse_grid(*MSE_SCALED)
    pub, big = mse_sequence(epg, T2p, attp), mse_sequence(epg, T2s, atts)
    kargs = mse_kernel_args(torch, T2s, atts)

    fisp_dispatch.clear_cache()
    fisp_dispatch.DISPATCH_COUNTS.clear()
    cuda_mse.LAUNCHES = 0
    t0 = time.perf_counter()
    out_pub = epg.simulate(pub, asarray=False)
    torch.cuda.synchronize()
    pub_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = epg.simulate(big, asarray=False)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    dre, dim = cuda_mse.cpmg_dictionary_cuda(*kargs, nstate=MSE_NSTATE)
    torch.cuda.synchronize()
    launches = cuda_mse.LAUNCHES
    dispatched = fisp_dispatch.DISPATCH_COUNTS.get("mse", 0)
    nsig = out.shape[1] * out.shape[2]
    print(f"[mse] simulate(): published {MSE_NECHO} echoes x "
          f"{MSE_GRID[0]} T2 x {MSE_GRID[1]} att -> {tuple(out_pub.shape)}; "
          f"scaled -> {tuple(out.shape)} {out.dtype} ({nsig} signals); "
          f"cpmg_dictionary_cuda -> {tuple(dre.shape)}; dispatch "
          f"mse={dispatched}, kernel launches={launches}")
    if dispatched != 2 or launches != 3:
        raise AssertionError("the CPMG trains did not go through the kernel")
    if (tuple(out_pub.shape) != (MSE_NECHO, MSE_GRID[1], MSE_GRID[0])
            or tuple(out.shape) != (MSE_NECHO, MSE_SCALED[1], MSE_SCALED[0])
            or out.dtype != torch.complex64
            or tuple(dre.shape) != (nsig, MSE_NECHO)):
        raise AssertionError("unexpected CPMG output shapes")
    for t in (torch.view_as_real(out_pub), torch.view_as_real(out), dre,
              dim):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("non-finite values in the CPMG path")

    # 8 signals of each grid against the float64 general path, on the CPU
    errs = []
    direct = torch.complex(dre, dim).reshape(MSE_SCALED[1], MSE_SCALED[0],
                                             MSE_NECHO).permute(2, 0, 1)
    for got_all, T2, att in ((out_pub, T2p, attp), (out, T2s, atts),
                             (direct, T2s, atts)):
        ia, it = _mse_pick(len(T2), len(att))
        with cpu_float64(config):
            ref = epg.simulate(mse_sequence(epg, T2[it], att[ia]),
                               fisp_kernel=False)
        got = got_all[:, ia][:, :, it].cpu().numpy()
        errs.append(float(np.abs(got - ref).max()))
    print(f"[mse] 8 signals vs the f64 general path: published "
          f"{errs[0]:.3e}, scaled {errs[1]:.3e}, cpmg_dictionary_cuda "
          f"{errs[2]:.3e} (limit {TOL_PROBE})")
    if not max(errs) <= TOL_PROBE:
        raise AssertionError(f"CPMG path error {max(errs):.3e}")
    del out, out_pub, dre, dim, direct
    pub_memo = _host_s(torch, lambda: epg.simulate(pub, asarray=False))
    memo_s = _host_s(torch, lambda: epg.simulate(big, asarray=False),
                     reps=3)
    print(f"[mse] simulate() published grid: first {pub_first:.4f} s, "
          f"memoized {pub_memo * 1e3:.3f} ms = "
          f"{MSE_GRID[0] * MSE_GRID[1] / pub_memo:.4g} signals/s; scaled "
          f"grid: first {first_s:.4f} s, memoized {memo_s * 1e3:.3f} ms = "
          f"{nsig / memo_s:.4g} signals/s")
    return dict(launches=launches, kargs=kargs, first_s=first_s,
                memo_s=memo_s, pub_first=pub_first, pub_memo=pub_memo,
                err=max(errs), nsig=nsig)


def phase_mse_jac_path(torch, epg):
    """The CPMG Jacobian through simulate() on the scaled grid; returns
    the run's facts (sequence, launches, times, errors)."""
    from epgpy_torch import config, fisp_dispatch
    from epgpy_torch.models import cuda_mse

    names = ["magnitude", "T1", "T2"]
    T2s, atts = mse_grid(*MSE_SCALED)
    seq = mse_sequence(epg, T2s, atts, tracked=True)
    probes = [epg.ADC, epg.Jacobian(names)]

    fisp_dispatch.clear_cache()
    fisp_dispatch.DISPATCH_COUNTS.clear()
    cuda_mse.JAC_LAUNCHES = 0
    t0 = time.perf_counter()
    sig, jac = epg.simulate(seq, asarray=False, probe=probes)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = cuda_mse.JAC_LAUNCHES
    dispatched = fisp_dispatch.DISPATCH_COUNTS.get("jac:mse", 0)
    shape = (MSE_NECHO, MSE_SCALED[1], MSE_SCALED[0])
    print(f"[mse-jac] simulate(probe=[ADC, Jacobian({names})]) -> "
          f"{tuple(sig.shape)}, {tuple(jac.shape)} {jac.dtype}; dispatch "
          f"jac:mse={dispatched}, Jacobian kernel launches={launches}")
    if dispatched != 1 or launches != 1:
        raise AssertionError("the CPMG Jacobian did not go through the "
                             "kernel")
    if (tuple(sig.shape) != shape or tuple(jac.shape) != shape + (3,)
            or jac.dtype != torch.complex64):
        raise AssertionError("unexpected CPMG Jacobian output shapes")
    for t in (sig, jac):
        if not bool(torch.isfinite(torch.view_as_real(t)).all()):
            raise AssertionError("non-finite values in the CPMG Jacobian")
    if not bool((jac[..., 0] == sig).all()):
        raise AssertionError("the magnitude column is not the signal")
    ia, it = _mse_pick(len(T2s), len(atts))
    with cpu_float64(config):
        s64, j64 = epg.simulate(
            mse_sequence(epg, T2s[it], atts[ia], tracked=True),
            probe=[epg.ADC, epg.Jacobian(names)], fisp_kernel=False)
    sig_err = float(np.abs(sig[:, ia][:, :, it].cpu().numpy() - s64).max())
    cols = col_errors(jac[:, ia][:, :, it].cpu().numpy(), j64)
    print(f"[mse-jac] 8 signals vs the f64 general diff path: signal "
          f"{sig_err:.3e} (limit {TOL_PROBE}); columns (mag, T1, T2) "
          f"{', '.join(f'{c:.3e}' for c in cols)} of each column's scale "
          f"(limit {TOL_JAC_MODEL})")
    if not sig_err <= TOL_PROBE or not max(cols) <= TOL_JAC_MODEL:
        raise AssertionError(f"CPMG Jacobian path error {sig_err:.3e} / "
                             f"{max(cols):.3e}")
    del sig, jac
    memo_s = _host_s(torch, lambda: epg.simulate(seq, asarray=False,
                                                 probe=probes), reps=3)
    return dict(launches=launches, first_s=first_s, memo_s=memo_s,
                col_err=max(cols), sig_err=sig_err,
                simulate=lambda: epg.simulate(seq, asarray=False,
                                              probe=probes))


def phase_dw_path(torch, epg):
    """A DW-TSE train (one D after each shift, ``kvalue`` set) over the
    published grid through simulate(); returns its facts."""
    from epgpy_torch import config, fisp_dispatch
    from epgpy_torch.models import cuda_mse

    T2p, attp = mse_grid(*MSE_GRID)

    def train(T2, att):
        dw = (epg.D(MSE_TE / 2, DW_DCOEF, k=1),
              epg.D(MSE_TE / 2, DW_DCOEF, k=1))
        return mse_sequence(epg, T2, att, dw=dw)

    seq = train(T2p, attp)
    fisp_dispatch.clear_cache()
    fisp_dispatch.DISPATCH_COUNTS.clear()
    cuda_mse.LAUNCHES = 0
    out = epg.simulate(seq, kvalue=DW_KVALUE, asarray=False)
    torch.cuda.synchronize()
    launches = cuda_mse.LAUNCHES
    dispatched = fisp_dispatch.DISPATCH_COUNTS.get("mse", 0)
    if dispatched != 1 or launches != 1:
        raise AssertionError("the DW-TSE train did not go through the "
                             "kernel")
    ia = [0, MSE_GRID[1] // 2, MSE_GRID[1] - 1]
    with cpu_float64(config):
        ref = epg.simulate(train(T2p, attp[ia]), kvalue=DW_KVALUE,
                           fisp_kernel=False)
        plain = epg.simulate(mse_sequence(epg, T2p, attp[ia]),
                             fisp_kernel=False)
    got = out[:, ia].cpu().numpy()
    err = float(np.abs(got - ref).max())
    loss = float(1.0 - np.abs(ref[-1]).max() / np.abs(plain[-1]).max())
    print(f"[dw] DW-TSE simulate(kvalue={DW_KVALUE:.6g}): "
          f"{tuple(out.shape)}; dispatch mse={dispatched}, kernel "
          f"launches={launches}; {len(ia) * MSE_GRID[0]} signals vs the f64 "
          f"general path {err:.3e} (limit {TOL_PROBE}); diffusion takes "
          f"{loss:.1%} of the last echo's peak")
    if not bool(torch.isfinite(torch.view_as_real(out)).all()) \
            or not err <= TOL_PROBE or not loss > 0.0:
        raise AssertionError(f"DW-TSE path error {err:.3e}")
    return dict(launches=launches, err=err)


def phase_t2b1(torch, epg):
    """T2/B1 mapping (examples/mse_t2_b1_mapping.py) at MAP_NVOX voxels:
    mono-exponential, dictionary match and Gauss-Newton estimates; returns
    the run's facts."""
    from epgpy_torch.models import cuda_mse
    from epgpy_torch.parallel import gauss_newton_refine, mrf_reconstruct

    E, tau = MAP_NECHO, MAP_ESP / 2
    rng = np.random.default_rng(MAP_SEED)
    T2t = rng.uniform(30.0, 150.0, MAP_NVOX)
    B1t = rng.uniform(0.6, 0.95, MAP_NVOX)
    noise = MAP_NOISE * (rng.standard_normal((MAP_NVOX, E))
                         + 1j * rng.standard_normal((MAP_NVOX, E)))

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device="cuda")

    def targs(T2, B1):
        return (EXC, np.full(E, 180.0), 0.0, tau, tau,
                f32(np.full(len(T2), MSE_T1)), f32(T2), f32(B1))

    nst = 2 * E
    cuda_mse.LAUNCHES = cuda_mse.JAC_LAUNCHES = 0
    truth_args = targs(T2t, B1t)
    tre, tim = cuda_mse.cpmg_dictionary_cuda(*truth_args,
                                             nstate=nst)        # (V, E)
    mre, mim = tre + f32(noise.real), tim + f32(noise.imag)

    # the example's init: a log-linear mono-exponential fit of |S|
    techo = MAP_ESP * np.arange(1, E + 1)
    logmag = np.log(np.maximum(torch.sqrt(mre ** 2 + mim ** 2).T.cpu()
                               .numpy(), 1e-12))               # (E, V)
    tbar, lbar = techo.mean(), logmag.mean(0)
    slope = ((techo[:, None] - tbar) * (logmag - lbar)).sum(0) \
        / ((techo - tbar) ** 2).sum()
    T2_mono = np.clip(-1.0 / np.minimum(slope, -1e-6), 10.0, 400.0)

    g2, gb = np.meshgrid(MAP_DICT_T2, MAP_DICT_B1, indexing="ij")
    grid = np.stack([g2.ravel(), gb.ravel()], -1)
    t0 = time.perf_counter()
    dict_args = targs(grid[:, 0], grid[:, 1])
    dre, dim = cuda_mse.cpmg_dictionary_cuda(*dict_args, nstate=nst)
    torch.cuda.synchronize()
    dict_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec = mrf_reconstruct(mre, mim, dre, dim, grid)
    torch.cuda.synchronize()
    match_s = time.perf_counter() - t0
    theta0 = rec["maps"].T.cpu().numpy()                        # (2, V)

    first_jac = []   # the first iteration's inputs and kernel outputs

    def signal_and_jac(theta):
        args = targs(theta[0], theta[1])
        (re, im), (jre, jim) = cuda_mse.cpmg_jacobian_cuda(*args, nstate=nst)
        if not first_jac:
            first_jac.append((args, [t.clone() for t in (re, im, jre, jim)]))
        return (re.T, im.T), (jre[..., 1:].transpose(0, 1),
                              jim[..., 1:].transpose(0, 1))

    t0 = time.perf_counter()
    theta = gauss_newton_refine(signal_and_jac, theta0, mre.T, mim.T,
                                iters=MAP_ITERS,
                                bounds=[(10.0, 400.0), (0.4, 1.0)],
                                solve_scale=True)
    torch.cuda.synchronize()
    gn_s = time.perf_counter() - t0
    launches = dict(cpmg=cuda_mse.LAUNCHES, cpmg_jac=cuda_mse.JAC_LAUNCHES)

    # the kernels' outputs on this path against their plain twins on the
    # same card tensors: the truth trains, the dictionary and the first
    # Gauss-Newton Jacobian
    def max_err(got, want):
        return max(float((g - w).abs().max()) for g, w in zip(got, want))

    errs = dict(
        truth=max_err((tre, tim), cuda_mse.cpmg_dictionary_plain(
            *truth_args, nstate=nst)),
        dictionary=max_err((dre, dim), cuda_mse.cpmg_dictionary_plain(
            *dict_args, nstate=nst)))
    jargs, (kre, kim, kjre, kjim) = first_jac[0]
    (pre, pim), (pjre, pjim) = cuda_mse.cpmg_jacobian_plain(*jargs,
                                                           nstate=nst)
    errs["jacobian"] = max_err((kre, kim), (pre, pim))
    cols = col_errors(torch.complex(kjre, kjim).cpu().numpy(),
                      torch.complex(pjre, pjim).cpu().numpy())
    print(f"[t2b1] kernels vs plain twins: max|kernel - plain| truth "
          f"{errs['truth']:.3e}, dictionary {errs['dictionary']:.3e}, "
          f"Jacobian echoes {errs['jacobian']:.3e} (limit {TOL_KERNEL}); "
          f"Jacobian columns (T1, T2, B1) "
          f"{', '.join(f'{c:.3e}' for c in cols)} (limit {TOL_JAC_KERNEL})")
    if not max(errs.values()) <= TOL_KERNEL \
            or not max(cols) <= TOL_JAC_KERNEL:
        raise AssertionError("a T2/B1 mapping kernel disagrees with its "
                             "plain twin")

    def rmse(est, truth):
        return float(np.sqrt(np.mean((est - truth) ** 2)))

    r = dict(mono=rmse(T2_mono, T2t), match=rmse(theta0[0], T2t),
             gn=rmse(theta[0], T2t), b1_match=rmse(theta0[1], B1t),
             b1_gn=rmse(theta[1], B1t))
    print(f"[t2b1] {MAP_NVOX} voxels x {E} echoes: dictionary "
          f"{len(grid)} atoms {dict_s * 1e3:.2f} ms, match "
          f"{match_s * 1e3:.2f} ms, Gauss-Newton x{MAP_ITERS} "
          f"{gn_s:.3f} s; launches {launches}")
    print(f"[t2b1] T2 RMSE: mono-exponential {r['mono']:.3f} ms, match "
          f"{r['match']:.3f} ms, refined {r['gn']:.3f} ms; B1 RMSE: match "
          f"{r['b1_match']:.5f}, refined {r['b1_gn']:.5f}")
    if launches != dict(cpmg=2, cpmg_jac=MAP_ITERS):
        raise AssertionError("a T2/B1 mapping step missed its kernel")
    if not (r["gn"] < 0.5 * r["mono"] and r["gn"] <= r["match"]):
        raise AssertionError("the refined T2 map does not beat the "
                             "mono-exponential and match estimates")
    return dict(launches=launches, rmse=r, dict_s=dict_s, match_s=match_s,
                gn_s=gn_s, jac_args=jargs, nstate=nst)


def phase_tse_design(torch, epg):
    """The SAR-constrained variable-flip TSE design (examples/optim_tse.py)
    through tse_design_slsqp on the design kernel; returns its facts."""
    from epgpy_torch.models import cuda_msedesign
    from epgpy_torch.parallel import (mse_design_loss_grad_fused,
                                      tse_design_slsqp)

    E = TSE_NECHO
    ESP, FA0 = np.full(E, TSE_ESP), np.full(E, TSE_FA0)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device="cuda")

    t1s, t2s = f32(TSE_T1), f32(TSE_T2)
    g1, g2 = np.meshgrid(np.linspace(600.0, 1800.0, TSE_GRID),
                         np.linspace(40.0, 200.0, TSE_GRID), indexing="ij")
    t1g, t2g = f32(g1.ravel()), f32(g2.ravel())
    kw = dict(nstate=2 * E)

    def loss(fa):
        return float(mse_design_loss_grad_fused(f32(fa), f32(ESP), t1s, t2s,
                                                **kw)[0])

    sar0 = float(np.mean((FA0 / 180.0) ** 2))
    budget = 0.7 * sar0
    v0 = loss(FA0)
    fused_ms = [_host_s(torch, lambda: mse_design_loss_grad_fused(
        f32(FA0), f32(ESP), a, b, **kw), reps=5) * 1e3
        for a, b in ((t1s, t2s), (t1g, t2g))]

    prof = cProfile.Profile()
    cuda_msedesign.DESIGN_LAUNCHES = 0
    t0 = time.perf_counter()
    prof.enable()
    FA, _, res = tse_design_slsqp(
        FA0, ESP, t1s, t2s, maxiter=TSE_ITERS, fix_esp=True,
        fa_bounds=TSE_BOUNDS, sar_budget=budget, dfa_max=TSE_DFA, **kw)
    prof.disable()
    slsqp_s = time.perf_counter() - t0
    launches = cuda_msedesign.DESIGN_LAUNCHES
    evals = [(v[1], v[3]) for k, v in pstats.Stats(prof).stats.items()
             if k[2] == "costjac"]
    n_eval, eval_s = (sum(x) for x in zip(*evals)) if evals else (0, 0.0)
    v1, sar1 = loss(FA), float(np.mean((FA / 180.0) ** 2))
    v_flat = loss(np.full(E, TSE_FA0 * np.sqrt(0.7)))
    dfa = float(np.abs(np.diff(FA)).max())
    print(f"[tse] fused loss + {2 * E} gradient: {fused_ms[0]:.3f} ms at "
          f"{len(TSE_T1)} atoms, {fused_ms[1]:.3f} ms at {len(g1.ravel())} "
          f"atoms")
    print(f"[tse] SLSQP: {res.nit} iterations, {res.nfev} evaluations, "
          f"{res.message}; design kernel launches={launches}; wall "
          f"{slsqp_s:.3f} s = {slsqp_s / max(res.nit, 1):.4f} s per "
          f"iteration, evaluations {eval_s:.3f} s "
          f"({eval_s / slsqp_s:.1%}, cProfile)")
    print(f"[tse] CRLB start {v0:.6g} (SAR {sar0:.4f}) -> designed "
          f"{v1:.6g} (SAR {sar1:.4f}, budget {budget:.4f}); constant train "
          f"at the budget {v_flat:.6g}; max |dFA| {dfa:.4f}")
    print("[tse] flips: "
          + np.array2string(FA, precision=1, max_line_width=200))
    if launches != res.nfev or launches != n_eval:
        raise AssertionError(f"design launches {launches} != nfev "
                             f"{res.nfev} (evaluation calls {n_eval})")
    if not (sar1 <= budget * 1.001 and dfa <= TSE_DFA + 1e-3
            and v1 < v_flat):
        raise AssertionError("the TSE design broke a constraint or lost to "
                             "the constant train")
    return dict(launches=launches, fused_ms=fused_ms, slsqp_s=slsqp_s,
                eval_s=eval_s, nit=res.nit, nfev=res.nfev, v0=v0, v1=v1,
                v_flat=v_flat, FA=FA, grid=(t1g, t2g), atoms=(t1s, t2s))


def phase_mse_numbers(torch, card, run, jac_run, t2b1):
    """CPMG kernel and Jacobian kernel vs their plain twins at the scaled
    grid, the Jacobian kernel also at the T2/B1 mapping's shape;
    simulate()'s device split for the Jacobian (torch.profiler and CUDA
    events); returns the two kernels' JSON entries."""
    from epgpy_torch.models import cuda_mse

    args, n = run["kargs"], run["nsig"]
    entries = []
    for jac in (False, True):
        name = "cpmg_jac" if jac else "cpmg"
        kfn = cuda_mse.cpmg_jacobian_echoes if jac else cuda_mse.cpmg_echoes
        pfn = cuda_mse.cpmg_jacobian_echoes_plain if jac \
            else cuda_mse.cpmg_echoes_plain

        def kernel():
            return kfn(*args, nstate=MSE_NSTATE)

        def plain():
            return pfn(*args, nstate=MSE_NSTATE)

        k, p = kernel(), plain()
        flat = lambda o: [t for x in o for t in (  # noqa: E731
            x if isinstance(x, tuple) else (x,))]
        err = max(float((a - b).abs().max())
                  for a, b in zip(flat(k), flat(p)))
        if jac:
            cols = col_errors(torch.complex(*k[1]).cpu().numpy(),
                              torch.complex(*p[1]).cpu().numpy())
            ok = max(cols) <= TOL_JAC_KERNEL and max(
                float((a - b).abs().max()) for a, b in zip(k[0], p[0])) \
                <= TOL_KERNEL
        else:
            cols, ok = [], err <= TOL_KERNEL
        print(f"[numbers] {name} at {n} signals x {MSE_NECHO} echoes: "
              f"max|kernel - plain| = {err:.3e}"
              + (f", per column {', '.join(f'{c:.2e}' for c in cols)}"
                 if cols else ""))
        if not ok:
            raise AssertionError(f"{name} kernel vs plain twin {err:.3e}")
        del k, p
        k_ms = _cuda_ms(torch, kernel)
        p_ms = _cuda_ms(torch, plain, reps=1, warm=False)
        print(f"[numbers] {name} kernel: {k_ms:.3f} ms = "
              f"{n / (k_ms / 1e3):.4g} signals/s; plain twin {p_ms:.3f} ms "
              f"({card})")
        flops = reached_ops(torch, name, lambda k, s, m: pfn(
            *_cpu_train(torch, args, m, (5, 6, 7), k, (1,)), nstate=s),
            MSE_NECHO, MSE_NSTATE, n)
        nbytes = tensor_bytes(torch, args, kernel())
        entries.append({
            "name": name, "route": "cuda",
            "source": f"epgpy_torch/csrc/{name}.cu",
            "replaces": "epgpy_tpu/models/pallas_mse.py:"
                        + ("309" if jac else "114"),
            "launches": (jac_run if jac else run)["launches"],
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            **bound_fields(name, flops, nbytes)})

    print(f"[numbers] simulate() CPMG end to end: first {run['first_s']:.4f}"
          f" s, memoized {run['memo_s'] * 1e3:.3f} ms; Jacobian first "
          f"{jac_run['first_s']:.4f} s, memoized "
          f"{jac_run['memo_s'] * 1e3:.3f} ms ({card})")
    _print_split("simulate() CPMG Jacobian", "cpmg_jac",
                 _profile_split(torch, jac_run["simulate"], "cpmg_jac"), card)
    _split_events(torch, "simulate() CPMG Jacobian", "cpmg_jac",
                  jac_run["simulate"], card, reps=5)

    # the Jacobian kernel at the T2/B1 mapping's shape (5d)
    margs, mst = t2b1["jac_args"], t2b1["nstate"]

    def mapping():
        return cuda_mse.cpmg_jacobian_echoes(*margs, nstate=mst)

    m_ms = _cuda_ms(torch, mapping)
    flops = reached_ops(
        torch, "cpmg_jac", lambda k, s, m: cuda_mse.cpmg_jacobian_echoes_plain(
            *_cpu_train(torch, margs, m, (5, 6, 7), k, (1,)), nstate=s),
        MAP_NECHO, mst, MAP_NVOX)
    b = bound_fields("cpmg_jac", flops, tensor_bytes(torch, margs, mapping()))
    print(f"[numbers] cpmg_jac at the T2/B1 mapping's Jacobian, {MAP_NVOX} "
          f"voxels x {MAP_NECHO} echoes, nstate {mst}: kernel {m_ms:.3f} ms;"
          f" bound {b['bound_ms']:.4f} ms ({b['bound_by']}), "
          f"{b['bound_ms'] / m_ms:.1%} of it ({card})")
    return entries


def phase_design_numbers(torch, card, tse):
    """The design kernel vs its plain twin at the 4,096-atom grid (second
    order, the designed train); returns its JSON entry."""
    from epgpy_torch.models import cuda_msedesign

    t1g, t2g = tse["grid"]
    E = TSE_NECHO
    args = (EXC, np.asarray(tse["FA"], float), 0.0, np.full(E, TSE_ESP),
            t1g, t2g)
    kw = dict(nstate=2 * E, second_order=True)

    def kernel():
        return cuda_msedesign.cpmg_design_cuda(*args, **kw)

    def plain():
        return cuda_msedesign.cpmg_design_plain(*args, **kw)

    k, p = kernel(), plain()
    errs = hess_block_errors(k, p)
    err = max(max(float((a - b).abs().max()) for a, b in zip(k[n], p[n]))
              for n in p)
    upper = _causal_max(torch, k)
    print(f"[numbers] cpmg_design at {len(t1g)} atoms x {E} echoes: "
          f"max|kernel - plain| = {err:.3e}, per block <= "
          f"{max(errs.values()):.2e}; variable > echo entries max "
          f"{upper:.1e}")
    if not max(errs.values()) <= TOL_DESIGN_KERNEL or upper != 0.0:
        raise AssertionError(f"design kernel vs plain twin "
                             f"{max(errs.values()):.3e}")
    del k, p
    k_ms = _cuda_ms(torch, kernel)
    p_ms = _cuda_ms(torch, plain, reps=1, warm=False)
    print(f"[numbers] cpmg_design kernel: {k_ms:.3f} ms = "
          f"{len(t1g) / (k_ms / 1e3):.4g} atoms/s; plain twin {p_ms:.3f} ms"
          f" ({card})")
    flops = reached_ops(
        torch, "cpmg_design",
        lambda k, s, m: cuda_msedesign.cpmg_design_plain(
            *_cpu_train(torch, args, m, (4, 5), k, (1, 3)), nstate=s,
            second_order=True), E, 2 * E, len(t1g))
    nbytes = tensor_bytes(torch, args, kernel())

    # the shape that launches it on the main path: the SLSQP's atoms
    t1s, t2s = tse["atoms"]
    args4 = args[:4] + (t1s, t2s)

    def kernel4():
        return cuda_msedesign.cpmg_design_cuda(*args4, **kw)

    k4, p4 = kernel4(), cuda_msedesign.cpmg_design_plain(*args4, **kw)
    err4 = max(hess_block_errors(k4, p4).values())
    if not err4 <= TOL_DESIGN_KERNEL or _causal_max(torch, k4) != 0.0:
        raise AssertionError(f"design kernel vs plain twin at "
                             f"{len(TSE_T1)} atoms {err4:.3e}")
    k4_ms = _cuda_ms(torch, kernel4)
    flops4 = reached_ops(
        torch, "cpmg_design",
        lambda k, s, m: cuda_msedesign.cpmg_design_plain(
            *_cpu_train(torch, args4, m, (4, 5), k, (1, 3)), nstate=s,
            second_order=True), E, 2 * E, len(TSE_T1))
    b4 = bound_fields("cpmg_design", flops4,
                      tensor_bytes(torch, args4, k4))
    print(f"[numbers] cpmg_design at the SLSQP's {len(TSE_T1)} atoms x {E} "
          f"echoes: kernel {k4_ms:.3f} ms (per block <= {err4:.2e} of the "
          f"twin), bound {b4['bound_ms']:.4f} ms ({b4['bound_by']}), "
          f"{b4['bound_ms'] / k4_ms:.1%} of it; {tse['launches']} launches "
          f"on that path; at {len(t1g)} atoms {k_ms:.3f} ms ({card})")
    return {"name": "cpmg_design", "route": "cuda",
            "source": "epgpy_torch/csrc/cpmg_design.cu",
            "replaces": "epgpy_tpu/models/pallas_msedesign.py:80",
            "launches": tse["launches"], "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms,
            **bound_fields("cpmg_design", flops, nbytes)}


# -- the balanced-SSFP and DESS families: kernels vs twins, paths, bSSFP
# MRF serving, DESS T1/T2 mapping --


def _pair_errors(torch, got, want, jac):
    """(max |delta| of the signals, per-column relative errors of the
    tangents) of two echo-layout outputs of a kernel and its twin."""
    if not jac:
        return max(float((g - w).abs().max()) for g, w in zip(got, want)), []
    (kre, kim), (kdre, kdim) = got
    (pre, pim), (pdre, pdim) = want
    sig = max(float((kre - pre).abs().max()), float((kim - pim).abs().max()))
    cols = [max(float((kdre[..., c] - pdre[..., c]).abs().max()),
                float((kdim[..., c] - pdim[..., c]).abs().max()))
            / max(float(pdre[..., c].abs().max()),
                  float(pdim[..., c].abs().max()), 1e-30)
            for c in range(pdre.shape[-1])]
    return sig, cols


def _finite(torch, out):
    """Whether every tensor of a (nested) kernel output is finite."""
    if isinstance(out, torch.Tensor):
        return bool(torch.isfinite(out).all())
    return all(_finite(torch, o) for o in out)


def phase_ssfp_cases(torch, family, natoms=4096):
    """The bSSFP (`family` "bssfp") or DESS ("dess") kernels vs their
    plain twins on the card over the option cases, the primal and the
    Jacobian (bSSFP: with and without the ddf group); for "dess" then the
    segmented Jacobian kernel's edges (DESS_EDGE_CASES) and ragged shapes
    (DESS_SHAPES); returns the worst signal |delta| and the worst
    per-column relative error."""
    from epgpy_torch.models import cuda_bssfp, cuda_dess

    worst_sig = worst_col = 0.0
    cases = BSSFP_CASES if family == "bssfp" else DESS_CASES
    for case in cases:
        if family == "bssfp":
            args, kw = _tensors(torch, *make_bssfp_case(case, natoms,
                                                         SSFP_CASE_N), DEVICE)
            runs = [(cuda_bssfp.bssfp_dictionary_cuda,
                     cuda_bssfp.bssfp_dictionary_plain, kw, False)]
            jkw = {k: v for k, v in kw.items() if k != "normalize"}
            runs += [(cuda_bssfp.bssfp_jacobian_cuda,
                      cuda_bssfp.bssfp_jacobian_plain,
                      dict(jkw, track_df=tdf), True) for tdf in (False, True)]
        else:
            args, kw = _tensors(torch, *make_dess_case(case, natoms), DEVICE)
            runs = [(cuda_dess.dess_echoes, cuda_dess.dess_echoes_plain, kw,
                     False),
                    (cuda_dess.dess_jacobian_echoes,
                     cuda_dess.dess_jacobian_echoes_plain, kw, True)]
        sig, cols, ok = 0.0, [], True
        for kfn, pfn, rkw, jac in runs:
            k = kfn(*args, **rkw)
            s, c = _pair_errors(torch, k, pfn(*args, **rkw), jac)
            sig, cols, ok = max(sig, s), cols + c, ok and _finite(torch, k)
        print(f"[{family}-cases] {case['name']:14s} max|kernel - plain| = "
              f"{sig:.3e}, per column {', '.join(f'{c:.2e}' for c in cols)}")
        if not ok or not sig <= TOL_KERNEL or not max(cols) <= TOL_JAC_KERNEL:
            raise AssertionError(
                f"{family} case {case['name']}: kernel vs plain twin "
                f"{sig:.3e} / {max(cols):.3e} over {TOL_KERNEL} / "
                f"{TOL_JAC_KERNEL} or not finite")
        worst_sig, worst_col = max(worst_sig, sig), max(worst_col, max(cols))
    if family == "bssfp":
        return max(worst_sig, bssfp_primal_edges(torch)), worst_col
    # the segmented Jacobian kernel's edges and ragged shapes
    wall = dict(edges=0.0, shapes=0.0)
    runs = [("edges", case, *DESS_EDGE_SHAPE) for case in DESS_EDGE_CASES]
    runs += [("shapes", DESS_CASES[-1], n, p) for n, p in DESS_SHAPES]
    for part, case, n, p in runs:
        t0 = time.perf_counter()
        sig, cols = dess_jac_vs_twin(torch, case, n, p)
        print(f"[dess-cases] {case['name']:14s} B={n:5d} P={p:3d} "
              f"nstate={case['nstate']:2d} max|kernel - plain| = {sig:.3e}, "
              f"per column {', '.join(f'{c:.2e}' for c in cols)}")
        worst_sig, worst_col = max(worst_sig, sig), max(worst_col, max(cols))
        wall[part] += time.perf_counter() - t0
    _print_wall("phase_ssfp_cases dess Jacobian", wall)
    return worst_sig, worst_col


def bssfp_primal_edges(torch):
    """The primal bSSFP kernel's own edges vs its plain twin: the runs,
    inversion and large-df cases (BSSFP_EDGE_CASES at BSSFP_EDGE_SHAPE)
    and every option over the ragged shapes (BSSFP_SHAPES), each launched
    twice (bit-equal); returns the worst |delta|."""
    from epgpy_torch.models import cuda_bssfp

    t0 = time.perf_counter()
    runs = [(case, *BSSFP_EDGE_SHAPE) for case in BSSFP_EDGE_CASES]
    runs += [(BSSFP_RAGGED_CASE, n, p) for n, p in BSSFP_SHAPES]
    worst = 0.0
    for case, n, npulse in runs:
        args, kw = _tensors(torch, *make_bssfp_case(case, n, npulse), DEVICE)
        kw.pop("normalize")
        before = cuda_bssfp.LAUNCHES
        k = cuda_bssfp.bssfp_echoes(*args, **kw)
        again = cuda_bssfp.bssfp_echoes(*args, **kw)
        torch.cuda.synchronize()
        if cuda_bssfp.LAUNCHES != before + 2:
            raise AssertionError(f"bssfp edge {case['name']}: the kernel "
                                 f"did not run")
        same = all(torch.equal(a, b) for a, b in zip(k, again))
        delta, _ = _pair_errors(torch, k, cuda_bssfp.bssfp_echoes_plain(
            *args, **kw), False)
        print(f"[bssfp-cases] primal {case['name']:14s} B={n:5d} "
              f"P={npulse:3d} max|kernel - plain| = {delta:.3e}; second "
              f"launch {'bit-equal' if same else 'DIFFERS'}")
        if not _finite(torch, k) or not delta <= TOL_KERNEL or not same:
            raise AssertionError(
                f"bssfp primal edge {case['name']} (B={n}, P={npulse}): "
                f"kernel vs plain twin {delta:.3e} over {TOL_KERNEL}, not "
                f"finite, or a second launch differs")
        worst = max(worst, delta)
    _print_wall("phase_ssfp_cases bssfp primal edges",
                dict(edges=time.perf_counter() - t0))
    return worst


def bssfp_train(npulse):
    """The benchmark's bSSFP train (bench.py:701-705): flips, TRs and the
    alternating RF phases."""
    FA = 10 + 50 * np.abs(np.sin(np.arange(npulse) * 2 * np.pi / 100))
    TRv = 12.0 + 2.0 * np.sin(np.arange(npulse) / 17.0)
    phases = np.cumsum(np.full(npulse, 180.0)) % 360.0
    return FA, TRv, phases


def bssfp_atoms(natoms):
    """The benchmark's atoms (bench.py:702-708): T1, T2 and df in kHz."""
    rng = np.random.default_rng(5)
    return (rng.uniform(300, 2000, natoms), rng.uniform(30, 200, natoms),
            rng.uniform(-0.05, 0.05, natoms))


def bssfp_bench_sequence(epg, T1, T2, DF, npulse=None, tracked=False):
    """The benchmark's IR-prepped bSSFP train (BSSFP_N pulses unless
    `npulse`) as a user writes it; with `tracked` every E op tracks (T1,
    T2, g)."""
    npulse = npulse or BSSFP_N
    FA, TRv, phases = bssfp_train(npulse)
    o1 = ["T1", "T2", "g"] if tracked else False
    seq = [epg.T(180, 0), epg.E(BSSFP_TI, T1, T2, DF, order1=o1)]
    for i in range(npulse):
        te = TRv[i] / 2
        seq += [epg.T(float(FA[i]), float(phases[i])),
                epg.E(te, T1, T2, DF, order1=o1),
                epg.Adc(phase=-float(phases[i])),
                epg.E(TRv[i] - te, T1, T2, DF, order1=o1)]
    return seq


def bssfp_golden_sequence(epg, g):
    """The train of tests/golden/bssfp.npz (tests/test_bssfp_dispatch.py:
    240-247): IR prep, alternating phase, df and a B1 batch."""
    T1s, T2s, dfs, B1s = g["T1s"], g["T2s"], g["dfs"], g["B1s"]
    seq = [epg.T(180 * B1s, 0), epg.E(18.0, T1s, T2s, dfs)]
    for i in range(len(g["FAs"])):
        te = g["TRs"][i] / 2
        seq += [epg.T(g["FAs"][i] * B1s, g["phases"][i]),
                epg.E(te, T1s, T2s, dfs), epg.Adc(phase=-g["phases"][i]),
                epg.E(g["TRs"][i] - te, T1s, T2s, dfs)]
    return seq


def _golden(name):
    return np.load(os.path.join(HERE, "tests", "golden", f"{name}.npz"))


def _reset_counts(*modules):
    """Zero the dispatch counts and the launch counters of `modules`."""
    from epgpy_torch import fisp_dispatch

    fisp_dispatch.clear_cache()
    fisp_dispatch.DISPATCH_COUNTS.clear()
    for m in modules:
        for name in ("LAUNCHES", "JAC_LAUNCHES"):
            setattr(m, name, 0)


def _first_call(torch, fn):
    """fn()'s result and its host-clock time ending in a device sync."""
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _expect(what, counts, want):
    """Raise unless the dispatch/launch counts `counts` are `want`."""
    print(f"[{what}] counts {counts}")
    if counts != want:
        raise AssertionError(f"{what}: counts {counts}, expected {want}")


def phase_bssfp_path(torch, epg):
    """The benchmark's bSSFP dictionary through simulate() (first call and
    memoized) and through bssfp_echoes, its drift curve against the float64
    general path and the golden train through simulate() on the card;
    returns the run's facts."""
    from epgpy_torch import config, fisp_dispatch
    from epgpy_torch.models import cuda_bssfp

    T1, T2, DF = bssfp_atoms(BSSFP_ATOMS)
    seq = bssfp_bench_sequence(epg, T1, T2, DF)
    _reset_counts(cuda_bssfp)
    out, first_s = _first_call(torch, lambda: epg.simulate(seq,
                                                           asarray=False))
    args = _match_args(fisp_dispatch, fisp_dispatch.match_bssfp(seq))
    kw = dict(demodulate=True, inversion=BSSFP_TI)
    re, im = cuda_bssfp.bssfp_echoes(*args, **kw)
    same = bool(torch.equal(out.real, re) and torch.equal(out.imag, im))
    del re, im
    g = _golden("bssfp")
    golden = epg.simulate(bssfp_golden_sequence(epg, g))
    torch.cuda.synchronize()
    launches = cuda_bssfp.LAUNCHES
    _expect("bssfp", (dict(fisp_dispatch.DISPATCH_COUNTS), launches),
            ({"bssfp": 2}, 3))
    gerr = float(np.abs(golden - g["signal"]).max())
    print(f"[bssfp] simulate(): {BSSFP_N} pulses x {BSSFP_ATOMS} atoms -> "
          f"{tuple(out.shape)} {out.dtype}; bssfp_echoes on the matched "
          f"parameters {'==' if same else '!='} simulate(); golden "
          f"bssfp.npz train on the card vs the golden {gerr:.3e} (limit "
          f"{TOL_BSSFP_GOLDEN})")
    if (tuple(out.shape) != (BSSFP_N, BSSFP_ATOMS)
            or out.dtype != torch.complex64 or not same
            or not _finite(torch, torch.view_as_real(out))
            or not gerr <= TOL_BSSFP_GOLDEN):
        raise AssertionError("bSSFP path: shape, finiteness, direct call or "
                             "golden error out of bounds")
    # the drift curve: one float64 general-path run of the full train over
    # 8 atoms; every shorter train is a prefix of it
    with cpu_float64(config):
        ref = epg.simulate(bssfp_bench_sequence(epg, T1[:8], T2[:8], DF[:8]),
                           fisp_kernel=False)
    err = np.abs(out[:, :8].cpu().numpy() - ref)
    drift = {n: float(err[:n].max()) for n in BSSFP_DRIFT}
    print("[bssfp] drift, max|f32 simulate - f64 general path| over the "
          "first N pulses (8 atoms): "
          + ", ".join(f"N={n}: {e:.3e}" for n, e in drift.items()))
    del out
    memo_s, nomemo_s = _memo_pair(torch, lambda: epg.simulate(
        seq, asarray=False), reps=3)
    return dict(seq=seq, args=args, kw=kw, launches=launches,
                first_s=first_s, memo_s=memo_s, nomemo_s=nomemo_s,
                drift=drift, gerr=gerr)


def phase_bssfp_jac_path(torch, epg):
    """The benchmark's bSSFP train with (T1, T2, g) tracked through
    simulate(probe=[ADC, Jacobian([mag, T1, T2, g])]); 8 atoms against the
    float64 general diff path over the first 48 pulses; returns the run's
    facts."""
    from epgpy_torch import config, fisp_dispatch
    from epgpy_torch.models import cuda_bssfp

    names = ["magnitude", "T1", "T2", "g"]
    T1, T2, DF = bssfp_atoms(BSSFP_ATOMS)
    seq = bssfp_bench_sequence(epg, T1, T2, DF, tracked=True)
    probes = [epg.ADC, epg.Jacobian(names)]
    _reset_counts(cuda_bssfp)
    (sig, jac), first_s = _first_call(torch, lambda: epg.simulate(
        seq, asarray=False, probe=probes))
    _expect("bssfp-jac", (dict(fisp_dispatch.DISPATCH_COUNTS),
                          cuda_bssfp.JAC_LAUNCHES), ({"jac:bssfp": 1}, 1))
    if (tuple(jac.shape) != (BSSFP_N, BSSFP_ATOMS, 4)
            or jac.dtype != torch.complex64 or not _finite(torch, (
                torch.view_as_real(sig), torch.view_as_real(jac)))
            or not bool((jac[..., 0] == sig).all())):
        raise AssertionError("bSSFP Jacobian path: shape, finiteness or "
                             "magnitude column wrong")
    n = BSSFP_DRIFT[0]
    with cpu_float64(config):
        s64, j64 = epg.simulate(
            bssfp_bench_sequence(epg, T1[:8], T2[:8], DF[:8], npulse=n,
                                 tracked=True),
            probe=probes, fisp_kernel=False)
    sig_err = float(np.abs(sig[:n, :8].cpu().numpy() - s64).max())
    cols = col_errors(jac[:n, :8].cpu().numpy(), j64)
    print(f"[bssfp-jac] simulate(probe=[ADC, Jacobian({names})]) -> "
          f"{tuple(jac.shape)}; first {n} pulses x 8 atoms vs the f64 "
          f"general diff path: signal {sig_err:.3e}, columns "
          f"{', '.join(f'{c:.3e}' for c in cols)} of each column's scale "
          f"(limits {TOL_BSSFP_GOLDEN}, {TOL_JAC_MODEL})")
    if not sig_err <= TOL_BSSFP_GOLDEN or not max(cols) <= TOL_JAC_MODEL:
        raise AssertionError(f"bSSFP Jacobian path error {sig_err:.3e} / "
                             f"{max(cols):.3e}")
    del sig, jac
    memo_s = _host_s(torch, lambda: epg.simulate(seq, asarray=False,
                                                 probe=probes), reps=2)
    return dict(seq=seq, launches=1, first_s=first_s, memo_s=memo_s,
                col_err=max(cols), sig_err=sig_err,
                simulate=lambda: epg.simulate(seq, asarray=False,
                                              probe=probes))


def dess_flips():
    """The mapping train's flip ramp (examples/dess_t1t2_mapping.py:52)."""
    return DESS_FA * (0.5 + np.abs(np.sin(np.arange(DESS_NTR) * np.pi / 24)))


def dess_map_sequence(epg, T1, T2, tracked=False):
    """The DESS mapping train as a user writes it: per TR [T(FA_i, 0),
    E(TE), ADC, E(TR - 2 TE), S(1), E(TE), ADC]; with `tracked` every E op
    tracks (T1, T2)."""
    o1 = ["T1", "T2"] if tracked else False
    seq = []
    for fa in dess_flips():
        seq += [epg.T(float(fa), 0.0), epg.E(DESS_TE, T1, T2, order1=o1),
                epg.ADC, epg.E(DESS_TR - 2 * DESS_TE, T1, T2, order1=o1),
                epg.S(1), epg.E(DESS_TE, T1, T2, order1=o1), epg.ADC]
    return seq


def dess_truth():
    """The example's voxels (examples/dess_t1t2_mapping.py:81-87): T1, T2,
    the complex PD and the complex noise (2 NTR, V), in its draw order."""
    rng = np.random.default_rng(DESS_SEED)
    T1 = rng.uniform(400, 1800, DESS_NVOX)
    T2 = np.minimum(rng.uniform(35, 180, DESS_NVOX), 0.6 * T1)
    pd = rng.uniform(0.7, 1.5, DESS_NVOX) * np.exp(
        2j * np.pi * rng.random(DESS_NVOX))
    shape = (2 * DESS_NTR, DESS_NVOX)
    noise = DESS_NOISE * (rng.normal(size=shape) + 1j * rng.normal(size=shape))
    return T1, T2, pd, noise


def phase_dess_path(torch, epg):
    """DESS through simulate(): the golden dess.npz train against the
    golden, and the mapping train over the example's voxels, primal and
    Jacobian (first call and memoized), 8 voxels against the float64
    general path; returns the run's facts."""
    from epgpy_torch import config, fisp_dispatch
    from epgpy_torch.models import cuda_dess

    g = _golden("dess")
    T1, T2, _, _ = dess_truth()
    seq = dess_map_sequence(epg, T1, T2)
    jseq = dess_map_sequence(epg, T1, T2, tracked=True)
    probes = [epg.ADC, epg.Jacobian(["T1", "T2"])]
    kw = dict(max_nstate=DESS_NSTATE, asarray=False)
    _reset_counts(cuda_dess)
    golden = epg.simulate(epg.dess_sequence(30, alpha=25.0, TR=20.0, TE=5.0,
                                            T1=1000.0, T2=80.0),
                          max_nstate=15)
    out, first_s = _first_call(torch, lambda: epg.simulate(seq, **kw))
    (sig, jac), jfirst_s = _first_call(torch, lambda: epg.simulate(
        jseq, probe=probes, **kw))
    _expect("dess", (dict(fisp_dispatch.DISPATCH_COUNTS),
                     cuda_dess.LAUNCHES, cuda_dess.JAC_LAUNCHES),
            ({"dess": 2, "jac:dess": 1}, 2, 1))
    gerr = float(np.abs(golden - g["signal"]).max())
    shape = (2 * DESS_NTR, DESS_NVOX)
    if (tuple(out.shape) != shape or tuple(jac.shape) != shape + (2,)
            or not _finite(torch, [torch.view_as_real(t)
                                   for t in (out, sig, jac)])
            or not float((sig - out).abs().max()) <= TOL_KERNEL):
        raise AssertionError("DESS path: shape, finiteness, or the "
                             "Jacobian kernel's signal differs from the "
                             "primal kernel's")
    with cpu_float64(config):
        ref = epg.simulate(dess_map_sequence(epg, T1[:8], T2[:8]),
                           max_nstate=DESS_NSTATE, fisp_kernel=False)
        _, j64 = epg.simulate(dess_map_sequence(epg, T1[:8], T2[:8],
                                                tracked=True),
                              probe=probes, max_nstate=DESS_NSTATE,
                              fisp_kernel=False)
    err = float(np.abs(out[:, :8].cpu().numpy() - ref).max())
    cols = col_errors(jac[:, :8].cpu().numpy(), j64)
    print(f"[dess] golden dess.npz train (max_nstate 15) on the card vs the "
          f"golden {gerr:.3e} (limit {TOL_DESS_GOLDEN}); mapping train "
          f"{DESS_NTR} TRs x {DESS_NVOX} voxels -> {tuple(out.shape)}, "
          f"Jacobian {tuple(jac.shape)}; 8 voxels vs the f64 general path: "
          f"signal {err:.3e} (limit {TOL_PROBE}), columns (T1, T2) "
          f"{', '.join(f'{c:.3e}' for c in cols)} (limit {TOL_JAC_MODEL})")
    if not gerr <= TOL_DESS_GOLDEN or not err <= TOL_PROBE \
            or not max(cols) <= TOL_JAC_MODEL:
        raise AssertionError(f"DESS path error: golden {gerr:.3e}, signal "
                             f"{err:.3e}, columns {max(cols):.3e}")
    del out, sig, jac
    memo_s = _host_s(torch, lambda: epg.simulate(seq, **kw), reps=3)
    jmemo_s = _host_s(torch, lambda: epg.simulate(jseq, probe=probes, **kw),
                      reps=3)
    print(f"[dess] simulate() mapping train: first {first_s:.4f} s, "
          f"memoized {memo_s * 1e3:.3f} ms; Jacobian first {jfirst_s:.4f} s, "
          f"memoized {jmemo_s * 1e3:.3f} ms")
    args = _match_args(fisp_dispatch, fisp_dispatch.match_dess(seq))
    return dict(args=args, launches=2, jac_launches=1, first_s=first_s,
                memo_s=memo_s, jfirst_s=jfirst_s, jmemo_s=jmemo_s,
                gerr=gerr, err=err, col_err=max(cols),
                simulate=lambda: epg.simulate(jseq, probe=probes, **kw))


def _complex_dev(torch, x):
    return torch.as_tensor(np.asarray(x, np.complex64), device=DEVICE)


def phase_bssfp_serving(torch, epg):
    """bSSFP MR fingerprinting (examples/mrf_bssfp.py) at full width: the
    163,840-atom (T1, T2, df) dictionary through simulate(), rank-32
    compression, a match of MRFB_NVOX off-grid voxels and the example's
    multi-start Gauss-Newton refinement on the bSSFP Jacobian kernel;
    returns the run's facts."""
    from epgpy_torch import fisp_dispatch
    from epgpy_torch.models import cuda_bssfp
    from epgpy_torch.parallel import (compress_dictionary, dictionary_match,
                                      gauss_newton_refine, project_signals)

    P, (n1, n2, n3) = MRFB_N, MRFB_GRID
    rng = np.random.default_rng(0)
    FA = 10 + 50 * np.abs(np.sin(np.arange(P) * 2 * np.pi / 100))
    FA += rng.uniform(0, 5, P)
    TR = 12.0 + 2.0 * np.sin(np.arange(P) / 17.0)
    T1g = np.linspace(200, 2000, n1).reshape(n1, 1, 1)
    T2g = np.linspace(20, 200, n2).reshape(1, n2, 1)
    dfg = np.linspace(-0.05, 0.05, n3).reshape(1, 1, n3)
    grid = np.stack(np.broadcast_arrays(T1g, T2g, dfg), -1).reshape(-1, 3)

    def train(theta, order1=None):
        return epg.bssfp_sequence(FA, TR, T1=theta[0], T2=theta[1],
                                  df=theta[2], inversion=18.0, order1=order1)

    _reset_counts(cuda_bssfp)
    t0 = time.perf_counter()
    dic = epg.simulate(train((T1g, T2g, dfg)), asarray=False).reshape(P, -1)
    dic = dic / torch.linalg.vector_norm(dic, dim=0)
    dre, dim = dic.real.T.contiguous(), dic.imag.T.contiguous()   # (B, P)
    del dic
    comp = compress_dictionary(dre, dim, MRFB_RANK)
    torch.cuda.synchronize()
    dict_s = time.perf_counter() - t0

    nv = MRFB_NVOX
    T1t = rng.uniform(300, 1800, nv)
    T2t = np.minimum(rng.uniform(30, 170, nv), 0.6 * T1t)
    dft = rng.uniform(-0.045, 0.045, nv)
    truth = np.stack([T1t, T2t, dft])
    clean = epg.simulate(train(truth), asarray=False)             # (P, V)
    pd = rng.normal(size=nv) + 1j * rng.normal(size=nv)
    noise = MRFB_NOISE * np.abs(pd) * (rng.normal(size=(P, nv))
                                       + 1j * rng.normal(size=(P, nv)))
    meas = clean * _complex_dev(torch, pd) + _complex_dev(torch, noise)

    # the truth signals against the twin on a slice of voxels
    tp = fisp_dispatch.match_bssfp(train(truth))                 # memoized
    d = fisp_dispatch.device_params(tp)
    sl = slice(0, 384)
    twin = cuda_bssfp.bssfp_echoes_plain(
        d["FA"], d["phi"], d["TR"], d["TE"], d["T1"][sl], d["T2"][sl],
        d["B1"][sl], d["df"][sl], demodulate=True, inversion=18.0)
    truth_err = max(float((clean.real[:, sl] - twin[0]).abs().max()),
                    float((clean.imag[:, sl] - twin[1]).abs().max()))
    del clean, twin

    # the example's init: match in the compressed space
    t0 = time.perf_counter()
    mn = torch.linalg.vector_norm(meas, dim=0)
    cm = project_signals(comp["basis_re"], comp["basis_im"],
                         (meas.real / mn).T.contiguous(),
                         (meas.imag / mn).T.contiguous())
    idx, _ = dictionary_match(comp["cdict_re"], comp["cdict_im"], cm[0],
                              cm[1], atom_chunk=16384)
    torch.cuda.synchronize()
    match_s = time.perf_counter() - t0
    theta0 = grid[idx.cpu().numpy()].T.copy()                   # (3, V)

    split = {"host": 0.0, "simulate": 0.0}
    first_jac = []

    def signal_and_jac(theta):
        t0 = time.perf_counter()
        seq = train(theta, order1=["T1", "T2", "g"])
        params = fisp_dispatch.match_bssfp(seq)   # memoized for simulate()
        t1 = time.perf_counter()
        s, j = epg.simulate(seq, asarray=False,
                            probe=[epg.ADC, epg.Jacobian(["T1", "T2", "g"])])
        torch.cuda.synchronize()
        split["host"] += t1 - t0
        split["simulate"] += time.perf_counter() - t1
        if not first_jac:
            first_jac.append((params, j[:, sl].clone()))
        return (s.real, s.imag), (j.real, j.imag)

    def residual(theta):
        s = epg.simulate(train(theta), asarray=False)
        c = (s.conj() * meas).sum(0) / torch.clamp(
            (s.abs() ** 2).sum(0), min=1e-30)
        return ((meas - c * s).abs() ** 2).sum(0)

    # multi-start: the match, its df-negated twin and +-half a df step
    half = 0.5 * float(dfg.flat[1] - dfg.flat[0])
    starts = []
    for ddf, neg in ((0.0, False), (0.0, True), (half, False),
                     (-half, False)):
        t = theta0.copy()
        t[2] = (-t[2] if neg else t[2]) + ddf
        starts.append(t)
    t0 = time.perf_counter()
    cands = [gauss_newton_refine(signal_and_jac, t, meas.real, meas.imag,
                                 iters=MRFB_ITERS, solve_scale=True,
                                 bounds=MRFB_BOUNDS) for t in starts]
    gn_s = time.perf_counter() - t0
    res = torch.stack([residual(c) for c in cands])
    pick = res.argmin(0).cpu().numpy()
    theta = np.stack(cands, 0)[pick, :, np.arange(nv)].T
    torch.cuda.synchronize()
    launches = dict(bssfp=cuda_bssfp.LAUNCHES,
                    bssfp_jac=cuda_bssfp.JAC_LAUNCHES)
    dispatched = dict(fisp_dispatch.DISPATCH_COUNTS)

    # the first Gauss-Newton Jacobian against the twin on the slice
    params, kj = first_jac[0]
    d = fisp_dispatch.device_params(params)
    (_, _), (pdre, pdim) = cuda_bssfp.bssfp_jacobian_echoes_plain(
        d["FA"], d["phi"], d["TR"], d["TE"], d["T1"][sl], d["T2"][sl],
        d["B1"][sl], d["df"][sl], demodulate=True, inversion=18.0,
        track_df=True)
    want = torch.complex(pdre, pdim)[..., [0, 1, 3]].cpu().numpy()
    jcols = col_errors(kj.cpu().numpy(), want)

    def rmse(est):
        return np.sqrt(np.mean((est - truth) ** 2, axis=1))

    e0, e1 = rmse(theta0), rmse(theta)
    ngn = len(starts) * MRFB_ITERS
    print(f"[mrf-bssfp] dictionary {n1} x {n2} x {n3} = {len(grid)} atoms x "
          f"{P} pulses through simulate() + rank-{MRFB_RANK} compression "
          f"(energy {float(comp['energy']):.6f}): {dict_s:.3f} s; match of "
          f"{nv} voxels {match_s * 1e3:.1f} ms")
    print(f"[mrf-bssfp] kernels vs plain twins on {sl.stop} voxels: truth "
          f"signals {truth_err:.3e} (limit {TOL_KERNEL}), first Gauss-Newton"
          f" Jacobian columns (T1, T2, df) "
          f"{', '.join(f'{c:.3e}' for c in jcols)} (limit {TOL_JAC_KERNEL})")
    print(f"[mrf-bssfp] RMSE match: T1 {e0[0]:.3f} ms, T2 {e0[1]:.4f} ms, df "
          f"{1e3 * e0[2]:.4f} Hz; refined ({len(starts)} starts x "
          f"{MRFB_ITERS} Gauss-Newton iterations, solve_scale): T1 "
          f"{e1[0]:.4f} ms, T2 {e1[1]:.5f} ms, df {1e3 * e1[2]:.5f} Hz; "
          f"picked start counts {np.bincount(pick, minlength=4).tolist()}")
    _expect("mrf-bssfp", (dispatched, launches),
            ({"bssfp": 2 + len(starts), "jac:bssfp": ngn},
             dict(bssfp=2 + len(starts), bssfp_jac=ngn)))
    if not truth_err <= TOL_KERNEL or not max(jcols) <= TOL_JAC_KERNEL:
        raise AssertionError("a bSSFP serving kernel disagrees with its "
                             "plain twin")
    if not (e1 < 0.3 * e0).all():
        raise AssertionError(f"refinement misses the example's criterion: "
                             f"match RMSE {e0}, refined {e1}")
    per = {k: v / ngn for k, v in split.items()}
    per["solve"] = gn_s / ngn - per["host"] - per["simulate"]
    return dict(launches=launches, dict_s=dict_s, match_s=match_s,
                gn_s=gn_s, per_iter=per, rmse0=e0, rmse1=e1)


def phase_dess_mapping(torch, epg):
    """Joint T1/T2 mapping from one DESS acquisition
    (examples/dess_t1t2_mapping.py) over DESS_NVOX voxels: the example's
    flat start and its own Gauss-Newton loop on the card (variable
    projection, trace regularizer, step clips, bounds), signal and
    Jacobian from simulate(); returns the run's facts."""
    from epgpy_torch import fisp_dispatch
    from epgpy_torch.models import cuda_dess

    T1t, T2t, pd, noise = dess_truth()
    kw = dict(max_nstate=DESS_NSTATE, asarray=False)
    probes = [epg.ADC, epg.Jacobian(["T1", "T2"])]
    _reset_counts(cuda_dess)
    clean = epg.simulate(dess_map_sequence(epg, T1t, T2t), **kw)
    meas = (clean * _complex_dev(torch, pd)).to(torch.complex128) \
        + torch.as_tensor(noise, device=DEVICE)
    del clean

    T1f = torch.full((DESS_NVOX,), 800.0, dtype=torch.float64, device=DEVICE)
    T2f = torch.full_like(T1f, 60.0)
    eye = torch.eye(2, dtype=torch.float64, device=DEVICE)
    first = []
    split = {"simulate": 0.0, "solve": 0.0}
    t0 = time.perf_counter()
    for _ in range(DESS_ITERS):
        t1 = time.perf_counter()
        seq = dess_map_sequence(epg, T1f.cpu().numpy(), T2f.cpu().numpy(),
                                tracked=True)
        sig, jac = epg.simulate(seq, probe=probes, **kw)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if not first:
            first.append((fisp_dispatch.match_dess(seq),
                          jac[:, :512].clone()))
        sig, jac = sig.to(torch.complex128), jac.to(torch.complex128)
        # variable projection: the complex scale in closed form per voxel
        c = (sig.conj() * meas).sum(0) / torch.clamp(
            (sig.abs() ** 2).sum(0), min=1e-30)
        r = meas - c * sig
        J = jac * c[None, :, None]
        A = torch.einsum("pbi,pbj->bij", J.conj(), J).real
        b = torch.einsum("pbi,pb->bi", J.conj(), r).real
        A = A + 1e-8 * torch.diagonal(A, dim1=1, dim2=2).sum(-1)[:, None,
                                                                 None] * eye
        step = torch.linalg.solve(A, b[..., None])[..., 0]
        T1f = torch.clamp(T1f + torch.clamp(step[:, 0], -400.0, 400.0),
                          100.0, 4000.0)
        T2f = torch.clamp(T2f + torch.clamp(step[:, 1], -50.0, 50.0),
                          10.0, 500.0)
        torch.cuda.synchronize()
        split["simulate"] += t2 - t1
        split["solve"] += time.perf_counter() - t2
    gn_s = time.perf_counter() - t0
    launches = dict(dess=cuda_dess.LAUNCHES, dess_jac=cuda_dess.JAC_LAUNCHES)
    _expect("dess-map", (dict(fisp_dispatch.DISPATCH_COUNTS), launches),
            ({"dess": 1, "jac:dess": DESS_ITERS},
             dict(dess=1, dess_jac=DESS_ITERS)))

    # the first iteration's Jacobian against the twin on 512 voxels
    params, kj = first[0]
    d = fisp_dispatch.device_params(params)
    sl = slice(0, 512)
    (_, _), (pdre, pdim) = cuda_dess.dess_jacobian_echoes_plain(
        d["FA"], d["phi"], d["TR"], d["TE"], d["T1"][sl], d["T2"][sl],
        d["B1"][sl], None, nstate=DESS_NSTATE)
    jcols = col_errors(kj.cpu().numpy(),
                       torch.complex(pdre, pdim)[..., :2].cpu().numpy())
    e1 = float(torch.sqrt(torch.mean((T1f.cpu() - torch.as_tensor(T1t)) ** 2)))
    e2 = float(torch.sqrt(torch.mean((T2f.cpu() - torch.as_tensor(T2t)) ** 2)))
    print(f"[dess-map] {DESS_NVOX} voxels x {DESS_NTR} TRs, {DESS_ITERS} "
          f"Gauss-Newton iterations from (800, 60): {gn_s:.3f} s (simulate "
          f"{split['simulate']:.3f} s, host + device solve "
          f"{split['solve']:.3f} s); T1 RMSE {e1:.3f} ms (limit 25), T2 RMSE "
          f"{e2:.4f} ms (limit 2.5); first Jacobian vs the twin on 512 "
          f"voxels, columns (T1, T2) {', '.join(f'{c:.3e}' for c in jcols)} "
          f"(limit {TOL_JAC_KERNEL})")
    if not max(jcols) <= TOL_JAC_KERNEL:
        raise AssertionError("the DESS Jacobian kernel disagrees with its "
                             "plain twin")
    if not (e1 < 25.0 and e2 < 2.5):
        raise AssertionError(f"DESS mapping misses the example's limits: "
                             f"T1 {e1:.3f} ms, T2 {e2:.4f} ms")
    return dict(launches=launches, gn_s=gn_s, split=split, rmse=(e1, e2))


# -- the ME-GRE family, the full ladder and DW-FISP: kernels vs twins,
# paths, T2/B0 mapping --


def phase_megre_cases(torch, natoms=4096):
    """The ME-GRE kernels vs their plain twins on the card over the option
    cases, the segmented Jacobian kernel's edges (MEGRE_EDGE_CASES) and
    ragged shapes (SEG_SHAPES), primal and Jacobian (the df group at
    dfs=None included); returns the worst signal |delta| and the worst
    per-column relative error."""
    from epgpy_torch.models import cuda_megre

    runs = [(case, natoms, MEGRE_CASE_N) for case in MEGRE_CASES]
    runs += [(case, *SEG_EDGE_SHAPE) for case in MEGRE_EDGE_CASES]
    runs += [(case, n, p) for n, p in SEG_SHAPES for case in MEGRE_CASES
             if case["name"] == SEG_RAGGED_CASES["megre_jac"]]
    worst_sig = worst_col = 0.0
    for case, n, npulse in runs:
        args, kw = _tensors(torch, *make_megre_case(case, n, npulse),
                            DEVICE)
        sig, cols, ok = 0.0, [], True
        for kfn, pfn, jac in (
                (cuda_megre.megre_echoes, cuda_megre.megre_echoes_plain,
                 False),
                (cuda_megre.megre_jacobian_echoes,
                 cuda_megre.megre_jacobian_echoes_plain, True)):
            k = kfn(*args, **kw)
            s_, c = _pair_errors(torch, k, pfn(*args, **kw), jac)
            sig, cols, ok = max(sig, s_), cols + c, ok and _finite(torch, k)
        print(f"[megre-cases] {case['name']:17s} B={n:5d} P={npulse:3d} "
              f"nstate={kw['nstate']:2d} max|kernel - plain| = {sig:.3e}, "
              f"columns (T1, T2, B1, df) "
              f"{', '.join(f'{c:.2e}' for c in cols)}")
        if not ok or not sig <= TOL_KERNEL or not max(cols) <= TOL_JAC_KERNEL:
            raise AssertionError(
                f"megre case {case['name']} (B={n}, P={npulse}): kernel "
                f"vs plain twin "
                f"{sig:.3e} / {max(cols):.3e} over {TOL_KERNEL} / "
                f"{TOL_JAC_KERNEL} or not finite")
        worst_sig, worst_col = max(worst_sig, sig), max(worst_col, max(cols))
    # the primal kernel's own edges: every change of instance or rows per
    # lane, the echo counts (past the registers and the staging area), TR
    # and echo-time runs, ragged shapes and chunk edges
    t0 = time.perf_counter()
    runs = [(case, MEGRE_EDGE_ATOMS, case["nstate"] + 1 + MEGRE_EDGE_PULSES)
            for case in MEGRE_PRIMAL_EDGE_CASES] + MEGRE_PRIMAL_CASES
    primal = 0.0
    for case, n, npulse in runs:
        args, kw = _tensors(torch, *make_megre_case(case, n, npulse),
                            DEVICE)
        before = cuda_megre.LAUNCHES
        k = cuda_megre.megre_echoes(*args, **kw)
        again = cuda_megre.megre_echoes(*args, **kw)
        torch.cuda.synchronize()
        if cuda_megre.LAUNCHES != before + 2:
            raise AssertionError(f"megre edge {case['name']}: the kernel "
                                 f"did not run")
        same = all(torch.equal(a, b) for a, b in zip(k, again))
        delta, _ = _pair_errors(torch, k, cuda_megre.megre_echoes_plain(
            *args, **kw), False)
        geo = cuda_megre.megre_geometry(kw["nstate"], case["m"])
        print(f"[megre-cases] primal {case['name']:17s} B={n:5d} "
              f"P={npulse:3d} m={case['m']:4d} (R {geo['R']} on "
              f"{geo['W']} lanes, {geo['pulses']} TRs per chunk) "
              f"max|kernel - plain| = "
              f"{delta:.3e}; second launch "
              f"{'bit-equal' if same else 'DIFFERS'}")
        if not _finite(torch, k) or not delta <= TOL_KERNEL or not same:
            raise AssertionError(
                f"megre primal edge {case['name']} (B={n}, P={npulse}): "
                f"kernel vs plain twin {delta:.3e} over {TOL_KERNEL}, not "
                f"finite, or a second launch differs")
        primal = max(primal, delta)
    print(f"[megre-cases] primal edges: {len(runs)} runs, worst "
          f"max|kernel - plain| = {primal:.3e} (limit {TOL_KERNEL})")
    _print_wall("phase_megre_cases primal edges",
                dict(edges=time.perf_counter() - t0))
    return max(worst_sig, primal), worst_col


def phase_full_cases(torch, natoms=4096, npulse=CASE_NPULSE):
    """The full-ladder kernel vs its plain twin on the card over its option
    cases (nstate 0 and the FISP depth, plus one 150-deep ladder, the
    gate's largest), against the folded kernel at nstate >= 1, and the
    nstate-0 route of fisp_dictionary_cuda; returns the worst |delta|."""
    from epgpy_torch.models import cuda_fisp

    worst = 0.0
    for case in FULL_CASES + [dict(name="inv_df_n150", nstate=150,
                                   inversion=20.0, df=True)]:
        args, kw = _tensors(torch, *make_full_case(case, natoms, npulse),
                            DEVICE)
        k = cuda_fisp.fisp_full_echoes(*args, **kw)
        delta, _ = _pair_errors(torch, k,
                                cuda_fisp.fisp_full_echoes_plain(*args, **kw),
                                False)
        fold = "-"
        if kw["nstate"] >= 1:
            f, _ = _pair_errors(torch, k, cuda_fisp.fisp_echoes(*args, **kw),
                                False)
            fold = f"{f:.3e}"
            delta = max(delta, f)
        print(f"[full-cases] {case['name']:16s} max|kernel - plain| = "
              f"{delta:.3e}; vs fisp_half {fold}")
        if not _finite(torch, k) or not delta <= TOL_KERNEL:
            raise AssertionError(f"full case {case['name']}: {delta:.3e} > "
                                 f"{TOL_KERNEL} or not finite")
        worst = max(worst, delta)
    # the nstate-0 route of the dictionary goes through the full kernel
    args, kw = _tensors(torch, *make_case(OPTION_CASES[0], natoms, npulse),
                        DEVICE)
    kw["nstate"] = 0
    before = cuda_fisp.FULL_LAUNCHES
    got = cuda_fisp.fisp_dictionary_cuda(*args, **kw)
    want = cuda_fisp.fisp_full_ladder_plain(*args, **kw)
    d0, _ = _pair_errors(torch, got, want, False)
    print(f"[full-cases] fisp_dictionary_cuda(nstate=0): "
          f"{cuda_fisp.FULL_LAUNCHES - before} full-ladder launch, "
          f"max|kernel - plain| = {d0:.3e}")
    if cuda_fisp.FULL_LAUNCHES != before + 1 or not d0 <= TOL_KERNEL:
        raise AssertionError("fisp_dictionary_cuda(nstate=0) did not run "
                             "the full-ladder kernel or disagrees")
    return max(worst, d0)


def megre_atoms(natoms):
    """The bench's ME-GRE draws (bench.py:1128-1133): the flip train, then
    per-atom T1, T2 and df (kHz)."""
    rng = np.random.default_rng(MEGRE_SEED)
    FA = rng.uniform(12.0, 45.0, MEGRE_N)
    T1 = rng.uniform(300.0, 2500.0, natoms).astype(np.float32)
    T2 = np.minimum(rng.uniform(20.0, 300.0, natoms),
                    0.8 * T1).astype(np.float32)
    df = rng.uniform(-0.05, 0.05, natoms).astype(np.float32)
    return FA, T1, T2, df


def megre_sequence(epg, FA, T1, T2, df, tes=MEGRE_TES, tail=MEGRE_TAIL,
                   order1=False):
    """An ME-GRE train as a user writes it (bench.py:1162-1178): per TR
    [T(FA_i, 0), (E(te_j - te_{j-1}), ADC) x m, E(tail), S(1)]."""
    seq = []
    for fa in FA:
        seq.append(epg.T(float(fa), 0.0))
        prev = 0.0
        for te in tes:
            seq += [epg.E(te - prev, T1, T2, df, order1=order1), epg.ADC]
            prev = te
        seq += [epg.E(tail, T1, T2, df, order1=order1), epg.S(1)]
    return seq


def megre_golden_sequence(epg):
    """The train of tests/golden/megre.npz (tests/test_megre_dispatch.py:
    220-232)."""
    return megre_sequence(epg, [15.0 + i for i in range(20)], 900.0, 70.0,
                          0.02, tes=(4.0, 9.0, 15.0), tail=7.0)


def phase_megre_path(torch, epg):
    """ME-GRE through simulate(): the bench's train over MEGRE_ATOMS atoms
    (first call and memoized, and megre_echoes on the matched parameters),
    8 atoms against the float64 general path, the golden megre.npz train on
    the card; returns the run's facts."""
    from epgpy_torch import config, fisp_dispatch
    from epgpy_torch.models import cuda_megre

    FA, T1, T2, DF = megre_atoms(MEGRE_ATOMS)
    seq = megre_sequence(epg, FA, T1, T2, DF)
    kw = dict(max_nstate=MEGRE_NSTATE, asarray=False)
    m = len(MEGRE_TES)
    _reset_counts(cuda_megre)
    out, first_s = _first_call(torch, lambda: epg.simulate(seq, **kw))
    args = _match_args(fisp_dispatch, fisp_dispatch.match_megre(seq))
    re, im = cuda_megre.megre_echoes(*args, nstate=MEGRE_NSTATE)
    same = bool(torch.equal(out.real, re) and torch.equal(out.imag, im))
    del re, im
    g = _golden("megre")
    golden = epg.simulate(megre_golden_sequence(epg), max_nstate=12)
    torch.cuda.synchronize()
    _expect("megre", (dict(fisp_dispatch.DISPATCH_COUNTS),
                      cuda_megre.LAUNCHES), ({"megre": 2}, 3))
    gerr = float(np.abs(golden - g["signal"]).max())
    with cpu_float64(config):
        ref = epg.simulate(megre_sequence(epg, FA, T1[:8], T2[:8], DF[:8]),
                           max_nstate=MEGRE_NSTATE, fisp_kernel=False)
    err = float(np.abs(out[:, :8].cpu().numpy() - ref).max())
    shape = (m * MEGRE_N, MEGRE_ATOMS)
    print(f"[megre] simulate(): {MEGRE_N} TRs x {m} echoes x {MEGRE_ATOMS} "
          f"atoms -> {tuple(out.shape)} {out.dtype}; megre_echoes on the "
          f"matched parameters {'==' if same else '!='} simulate(); 8 atoms "
          f"vs the f64 general path {err:.3e} (limit {TOL_PROBE}); golden "
          f"megre.npz train on the card vs the golden {gerr:.3e} (limit "
          f"{TOL_MEGRE_GOLDEN})")
    if (tuple(out.shape) != shape or out.dtype != torch.complex64
            or not same or not _finite(torch, torch.view_as_real(out))
            or not err <= TOL_PROBE or not gerr <= TOL_MEGRE_GOLDEN):
        raise AssertionError("ME-GRE path: shape, finiteness, direct call, "
                             "f64 error or golden error out of bounds")
    del out
    memo_s = _host_s(torch, lambda: epg.simulate(seq, **kw), reps=3)
    print(f"[megre] simulate() first {first_s:.4f} s, memoized "
          f"{memo_s * 1e3:.3f} ms")
    return dict(args=args, launches=3, first_s=first_s, memo_s=memo_s,
                gerr=gerr, err=err)


def phase_megre_jac_path(torch, epg):
    """The bench's (T2, g)-tracked ME-GRE train (bench.py:1180-1198) over
    MEGRE_ATOMS atoms through simulate(probe=[ADC, Jacobian(["T2", "g"])]);
    8 atoms over the first MEGRE_JAC_N TRs against the float64 general
    diff path; returns the run's facts."""
    from epgpy_torch import config, fisp_dispatch
    from epgpy_torch.models import cuda_megre

    names = ["T2", "g"]
    FA, T1, T2, DF = megre_atoms(MEGRE_ATOMS)
    seq = megre_sequence(epg, FA, T1, T2, DF, order1=names)
    probes = [epg.ADC, epg.Jacobian(names)]
    kw = dict(max_nstate=MEGRE_NSTATE, asarray=False, probe=probes)
    _reset_counts(cuda_megre)
    (sig, jac), first_s = _first_call(torch, lambda: epg.simulate(seq, **kw))
    _expect("megre-jac", (dict(fisp_dispatch.DISPATCH_COUNTS),
                          cuda_megre.JAC_LAUNCHES), ({"jac:megre": 1}, 1))
    shape = (len(MEGRE_TES) * MEGRE_N, MEGRE_ATOMS)
    if (tuple(jac.shape) != shape + (2,) or jac.dtype != torch.complex64
            or not _finite(torch, (torch.view_as_real(sig),
                                   torch.view_as_real(jac)))):
        raise AssertionError("ME-GRE Jacobian path: shape or finiteness")
    # the float64 oracle over the train's first MEGRE_JAC_N TRs (a prefix:
    # a TR's echoes depend on the TRs before it only)
    n = MEGRE_JAC_N * len(MEGRE_TES)
    with cpu_float64(config):
        s64, j64 = epg.simulate(
            megre_sequence(epg, FA[:MEGRE_JAC_N], T1[:8], T2[:8], DF[:8],
                           order1=names),
            probe=probes, max_nstate=MEGRE_NSTATE, fisp_kernel=False)
    sig_err = float(np.abs(sig[:n, :8].cpu().numpy() - s64).max())
    cols = col_errors(jac[:n, :8].cpu().numpy(), j64)
    print(f"[megre-jac] simulate(probe=[ADC, Jacobian({names})]) -> "
          f"{tuple(jac.shape)}; first {MEGRE_JAC_N} TRs x 8 atoms vs the "
          f"f64 general diff path: "
          f"signal {sig_err:.3e}, columns (T2, g) "
          f"{', '.join(f'{c:.3e}' for c in cols)} (limits {TOL_PROBE}, "
          f"{TOL_JAC_MODEL})")
    if not sig_err <= TOL_PROBE or not max(cols) <= TOL_JAC_MODEL:
        raise AssertionError(f"ME-GRE Jacobian path error {sig_err:.3e} / "
                             f"{max(cols):.3e}")
    del sig, jac
    memo_s = _host_s(torch, lambda: epg.simulate(seq, **kw), reps=2)
    print(f"[megre-jac] simulate() first {first_s:.4f} s, memoized "
          f"{memo_s * 1e3:.3f} ms")
    return dict(launches=1, first_s=first_s, memo_s=memo_s,
                col_err=max(cols), sig_err=sig_err,
                simulate=lambda: epg.simulate(seq, **kw))


def b0_flips():
    """The mapping train's flips (examples/megre_t2_b0_mapping.py:31)."""
    return 12.0 + 18.0 * np.abs(np.sin(np.arange(B0_NTR) * np.pi / 12))


def phase_b0_mapping(torch, epg):
    """Joint T2 + B0 mapping from a two-echo GRE train
    (examples/megre_t2_b0_mapping.py) over B0_NVOX voxels: the example's
    draws, its two-echo phase initialization and B0_ITERS Gauss-Newton
    iterations (solve_scale) whose signal and (T2, g) Jacobian come from
    simulate() and the ME-GRE Jacobian kernel; the first Jacobian against
    the twin on 512 voxels; returns the run's facts."""
    from epgpy_torch import fisp_dispatch
    from epgpy_torch.models import cuda_megre
    from epgpy_torch.parallel import gauss_newton_refine

    FA = b0_flips()
    tail = B0_TR - B0_TES[-1]

    def train(T1, T2, df, order1=False):
        return megre_sequence(epg, FA, T1, T2, df, tes=B0_TES, tail=tail,
                              order1=order1)

    V = B0_NVOX
    rng = np.random.default_rng(B0_SEED)
    T2t = rng.uniform(30, 150, V)
    dft = rng.uniform(-0.03, 0.03, V)
    _reset_counts(cuda_megre)
    sig = epg.simulate(train(np.full(V, B0_T1), T2t, dft),
                       max_nstate=B0_NSTATE, asarray=False)
    pd = rng.uniform(0.7, 1.5, V) * np.exp(2j * np.pi * rng.random(V))
    shape = tuple(sig.shape)
    noise = B0_NOISE * (rng.normal(size=shape) + 1j * rng.normal(size=shape))
    meas = (sig.to(torch.complex128) * torch.as_tensor(pd, device=DEVICE)
            + torch.as_tensor(noise, device=DEVICE))
    del sig
    # the example's two-echo start: the phase between the echoes of one
    # TR is 2 pi df (te2 - te1), the phasor averaged over TRs
    dphi = torch.angle((meas[0::2].conj() * meas[1::2]).sum(0))
    df0 = dphi.cpu().numpy() / (2 * np.pi * (B0_TES[1] - B0_TES[0]))
    theta0 = np.stack([np.full(V, 70.0), df0])

    split = {"host": 0.0, "simulate": 0.0}
    first = []
    names = ["T2", "g"]

    def signal_and_jac(theta):
        t0 = time.perf_counter()
        seq = train(np.full(V, B0_T1), theta[0], theta[1], order1=names)
        params = fisp_dispatch.match_megre(seq)   # memoized for simulate()
        t1 = time.perf_counter()
        s, j = epg.simulate(seq, max_nstate=B0_NSTATE, asarray=False,
                            probe=[epg.ADC, epg.Jacobian(names)])
        torch.cuda.synchronize()
        split["host"] += t1 - t0
        split["simulate"] += time.perf_counter() - t1
        if not first:
            first.append((params, j[:, :512].clone()))
        return (s.real, s.imag), (j.real, j.imag)

    t0 = time.perf_counter()
    theta = gauss_newton_refine(signal_and_jac, theta0, meas.real, meas.imag,
                                iters=B0_ITERS, solve_scale=True,
                                bounds=[(10.0, 400.0), (-0.06, 0.06)])
    torch.cuda.synchronize()
    gn_s = time.perf_counter() - t0
    launches = dict(megre=cuda_megre.LAUNCHES,
                    megre_jac=cuda_megre.JAC_LAUNCHES)
    _expect("b0-map", (dict(fisp_dispatch.DISPATCH_COUNTS), launches),
            ({"megre": 1, "jac:megre": B0_ITERS},
             dict(megre=1, megre_jac=B0_ITERS)))

    # the first Gauss-Newton Jacobian against the twin on 512 voxels
    params, kj = first[0]
    a = _match_args(fisp_dispatch, params)
    sl = slice(0, 512)
    (_, _), (pdre, pdim) = cuda_megre.megre_jacobian_echoes_plain(
        *a[:4], a[4][sl], a[5][sl], a[6][sl],
        None if a[7] is None else a[7][sl], nstate=B0_NSTATE)
    jcols = col_errors(kj.cpu().numpy(),
                       torch.complex(pdre, pdim)[..., [1, 3]].cpu().numpy())
    e_t2 = float(np.sqrt(np.mean((theta[0] - T2t) ** 2)))
    e_df = float(np.sqrt(np.mean((theta[1] - dft) ** 2)))
    e0_t2 = float(np.sqrt(np.mean((theta0[0] - T2t) ** 2)))
    e0_df = float(np.sqrt(np.mean((theta0[1] - dft) ** 2)))
    per = {k: v / B0_ITERS for k, v in split.items()}
    per["solve"] = gn_s / B0_ITERS - per["host"] - per["simulate"]
    print(f"[b0-map] {V} voxels x {B0_NTR} TRs x {len(B0_TES)} echoes, "
          f"{B0_ITERS} Gauss-Newton iterations: {gn_s:.3f} s; RMSE start "
          f"T2 {e0_t2:.3f} ms, B0 {1e3 * e0_df:.4f} Hz -> refined T2 "
          f"{e_t2:.4f} ms (limit {B0_LIMITS[0]}), B0 {1e3 * e_df:.5f} Hz "
          f"(limit {1e3 * B0_LIMITS[1]}); first Jacobian vs the twin on 512 "
          f"voxels, columns (T2, g) {', '.join(f'{c:.3e}' for c in jcols)} "
          f"(limit {TOL_JAC_KERNEL})")
    if not max(jcols) <= TOL_JAC_KERNEL:
        raise AssertionError("the ME-GRE Jacobian kernel disagrees with its "
                             "plain twin")
    if not (e_t2 < B0_LIMITS[0] and e_df < B0_LIMITS[1]):
        raise AssertionError(f"T2/B0 mapping misses the example's limits: "
                             f"T2 {e_t2:.4f} ms, B0 {e_df:.3e} kHz")
    return dict(launches=launches, gn_s=gn_s, per_iter=per,
                rmse=(e_t2, e_df))


def dwfisp_sequence(epg, FA, T1, T2, B1, npulse=None, tracked=False):
    """The FISP headline train with one D(DWF_TAU, DWF_D, k=1) after each
    S(1), the same D instance every TR; with `tracked`, the E ops track T1
    and T2 and the D op its diffusivity."""
    o1 = ["T1", "T2"] if tracked else False
    d_op = epg.D(DWF_TAU, DWF_D, k=1, order1=["Dcoef"] if tracked else False)
    seq = []
    for fa in FA[:npulse]:
        seq += [epg.T((fa * B1).astype(np.float32), 90),
                epg.E(TE, T1, T2, order1=o1), epg.ADC,
                epg.E(TR - TE, T1, T2, order1=o1), epg.S(1), d_op]
    return seq


def phase_dwfisp_path(torch, epg):
    """DW-FISP through simulate(): the FISP headline train (NATOMS x
    NPULSE, nstate NSTATE) with its D ops at DWF_KVALUE, 8 atoms against
    the float64 general path; its (T1, T2, Dcoef) Jacobian, 8 atoms over
    the first DWF_JAC_N pulses against the float64 general diff path;
    returns the run's facts."""
    from epgpy_torch import config, fisp_dispatch
    from epgpy_torch.models import cuda_fisp

    FA = make_train(NPULSE)
    T1, T2, B1 = make_atoms(NATOMS)
    kw = dict(max_nstate=NSTATE, asarray=False, kvalue=DWF_KVALUE)
    names = ["magnitude", "T1", "T2", "Dcoef"]
    probes = [epg.ADC, epg.Jacobian(names)]
    seq = dwfisp_sequence(epg, FA, T1, T2, B1)
    jseq = dwfisp_sequence(epg, FA, T1, T2, B1, tracked=True)
    _reset_counts(cuda_fisp)
    out, first_s = _first_call(torch, lambda: epg.simulate(seq, **kw))
    (sig, jac), jfirst_s = _first_call(torch, lambda: epg.simulate(
        jseq, probe=probes, **kw))
    _expect("dw-fisp", (dict(fisp_dispatch.DISPATCH_COUNTS),
                        cuda_fisp.LAUNCHES, cuda_fisp.JAC_LAUNCHES),
            ({"dw": 1, "jac:dw": 1}, 1, 1))
    if (tuple(out.shape) != (NPULSE, NATOMS)
            or tuple(jac.shape) != (NPULSE, NATOMS, len(names))
            or not _finite(torch, [torch.view_as_real(t)
                                   for t in (out, sig, jac)])
            or not float((sig - out).abs().max()) <= TOL_KERNEL):
        raise AssertionError("DW-FISP path: shape, finiteness, or the "
                             "Jacobian kernel's signal differs from the "
                             "primal kernel's")
    # the kernels' outputs against their plain twins on the same card
    # tensors, with the matched diffusion: the whole primal, the Jacobian
    # over the first DWF_TWIN_ATOMS atoms (columns T1, T2, Dcoef)
    params = fisp_dispatch.match_dwfisp(jseq, DWF_KVALUE)
    diffusion, ramp = fisp_dispatch._dw_diffusion(params)
    a = _match_args(fisp_dispatch, params)
    tkw = dict(nstate=NSTATE, demodulate=bool(params.get("demod")),
               inversion=params.get("TI"),
               inversion_df=bool(params.get("inv_df")), diffusion=diffusion,
               diff_ramp=ramp)
    pre, pim = cuda_fisp.fisp_echoes_plain(*a, **tkw)
    twin_err = max(float((out.real - pre).abs().max()),
                   float((out.imag - pim).abs().max()))
    del pre, pim
    sl = slice(0, DWF_TWIN_ATOMS)
    (_, _), (pdre, pdim) = cuda_fisp.fisp_jacobian_echoes_plain(
        *a[:4], a[4][sl], a[5][sl], a[6][sl], None, track_diffusivity=True,
        **tkw)
    twin_cols = col_errors(jac[:, sl, 1:].cpu().numpy(), torch.complex(
        pdre, pdim)[..., [0, 1, 3]].cpu().numpy())
    print(f"[dw-fisp] kernels vs plain twins on the same card tensors: "
          f"signal {twin_err:.3e} (limit {TOL_KERNEL}); Jacobian over "
          f"{DWF_TWIN_ATOMS} atoms, columns (T1, T2, Dcoef) "
          f"{', '.join(f'{c:.3e}' for c in twin_cols)} (limit "
          f"{TOL_JAC_KERNEL})")
    if not twin_err <= TOL_KERNEL or not max(twin_cols) <= TOL_JAC_KERNEL:
        raise AssertionError("DW-FISP kernels disagree with their twins")
    # the gate's deepest dD ladder (nstate 59) on the same matched train:
    # its first DWF_EDGE_N pulses over a ragged 4,097 atoms
    n, sl = DWF_EDGE_N, slice(0, 4097)
    ea = tuple(x[:n] for x in a[:3]) + (
        a[3][:n] if isinstance(a[3], torch.Tensor) else a[3],
        a[4][sl], a[5][sl], a[6][sl], None)
    ekw = dict(tkw, nstate=59, track_diffusivity=True)
    (kre, kim), (kdre, kdim) = cuda_fisp.fisp_jacobian_echoes(*ea, **ekw)
    (pre, pim), (pdre, pdim) = cuda_fisp.fisp_jacobian_echoes_plain(*ea,
                                                                    **ekw)
    edge_sig = max(float((kre - pre).abs().max()),
                   float((kim - pim).abs().max()))
    edge_cols = col_errors(torch.complex(kdre, kdim).cpu().numpy(),
                           torch.complex(pdre, pdim).cpu().numpy())
    print(f"[dw-fisp] fisp_jac at the gate (nstate 59, dD group), {n} "
          f"pulses x {ea[4].shape[0]} atoms of the matched train vs its "
          f"twin: signal "
          f"{edge_sig:.3e} (limit {TOL_KERNEL}); columns (T1, T2, B1, D) "
          f"{', '.join(f'{c:.3e}' for c in edge_cols)} (limit "
          f"{TOL_JAC_KERNEL})")
    if not edge_sig <= TOL_KERNEL or not max(edge_cols) <= TOL_JAC_KERNEL:
        raise AssertionError("DW-FISP: fisp_jac at nstate 59 disagrees with "
                             "its twin")
    del kre, kim, kdre, kdim, pre, pim, pdre, pdim
    B8 = tuple(x[:8] for x in (T1, T2, B1))
    with cpu_float64(config):
        ref = epg.simulate(dwfisp_sequence(epg, FA, *B8), max_nstate=NSTATE,
                           kvalue=DWF_KVALUE, fisp_kernel=False)
        _, j64 = epg.simulate(dwfisp_sequence(epg, FA, *B8, npulse=DWF_JAC_N,
                                              tracked=True),
                              probe=probes, max_nstate=NSTATE,
                              kvalue=DWF_KVALUE, fisp_kernel=False)
    err = float(np.abs(out[:, :8].cpu().numpy() - ref).max())
    free = float(out[:, :8].abs().max())
    cols = col_errors(jac[:DWF_JAC_N, :8].cpu().numpy(), j64)
    print(f"[dw-fisp] simulate(kvalue={DWF_KVALUE:.6g}): {NPULSE} pulses x "
          f"{NATOMS} atoms -> {tuple(out.shape)}, Jacobian "
          f"{tuple(jac.shape)}; 8 atoms vs the f64 general path: signal "
          f"{err:.3e} (limit {TOL_PROBE}); first {DWF_JAC_N} pulses vs the "
          f"f64 general diff path, columns {names} "
          f"{', '.join(f'{c:.3e}' for c in cols)} (limit {TOL_JAC_MODEL})")
    if not err <= TOL_PROBE or not max(cols) <= TOL_JAC_MODEL \
            or not free > 0:
        raise AssertionError(f"DW-FISP path error: signal {err:.3e}, "
                             f"columns {max(cols):.3e}")
    del out, sig, jac
    memo_s = _host_s(torch, lambda: epg.simulate(seq, **kw), reps=3)
    jmemo_s = _host_s(torch, lambda: epg.simulate(jseq, probe=probes, **kw),
                      reps=2)
    print(f"[dw-fisp] simulate() first {first_s:.4f} s, memoized "
          f"{memo_s * 1e3:.3f} ms; Jacobian first {jfirst_s:.4f} s, memoized "
          f"{jmemo_s * 1e3:.3f} ms")
    return dict(launches=1, jac_launches=1, first_s=first_s, memo_s=memo_s,
                jfirst_s=jfirst_s, jmemo_s=jmemo_s, err=err,
                col_err=max(cols), jac_args=a,
                jac_kw=dict(tkw, track_diffusivity=True))


def phase_full_path(torch, run):
    """The full-ladder kernel on the FISP headline train's matched
    parameters: fisp_dictionary_cuda(nstate=0), the JAX wrapper's
    full-ladder route (a perfectly spoiled dictionary) and the main-path
    launch, held against its plain twin on the same card tensors; then
    fisp_full_ladder_cuda at nstate NSTATE, the parity oracle of the folded
    phase-4 simulate() dictionary (a check, not counted); returns the
    run's facts (the kernel arguments, launches, the errors)."""
    from epgpy_torch import fisp_dispatch
    from epgpy_torch.models import cuda_fisp

    args = _match_args(fisp_dispatch, fisp_dispatch.match_fisp(run["seq"]))
    dictionary = run["dictionary"]
    cuda_fisp.FULL_LAUNCHES = 0
    s0 = cuda_fisp.fisp_dictionary_cuda(*args, nstate=0)
    torch.cuda.synchronize()
    launches = cuda_fisp.FULL_LAUNCHES
    _expect("full", launches, 1)
    twin_err = _pair_errors(
        torch, s0, cuda_fisp.fisp_dictionary_plain(*args, nstate=0), False)[0]
    oracle = cuda_fisp.fisp_full_ladder_cuda(*args, nstate=NSTATE)
    err = max(float((oracle[0] - dictionary.real.T).abs().max()),
              float((oracle[1] - dictionary.imag.T).abs().max()))
    # no magnetization leaves the unit ball
    ok = _finite(torch, s0) and bool(
        (torch.complex(*s0).abs() <= 1.0 + 1e-6).all())
    print(f"[full] fisp_dictionary_cuda(nstate=0) -> {tuple(s0[0].shape)}, "
          f"vs its plain twin on the same tensors {twin_err:.3e}; "
          f"fisp_full_ladder_cuda(nstate={NSTATE}) vs the folded simulate() "
          f"dictionary {err:.3e} (limits {TOL_KERNEL}); launches {launches}")
    if not ok or not twin_err <= TOL_KERNEL or not err <= TOL_KERNEL:
        raise AssertionError(f"full-ladder path: finiteness, twin error "
                             f"{twin_err:.3e} or oracle error {err:.3e}")
    return dict(args=args, launches=launches, err=err, twin_err=twin_err)


def _match_args(fisp_dispatch, params):
    """The kernels' positional tensors (FA, phi, TR, TE, T1s, T2s, B1s,
    dfs) of a FISP, DESS or ME-GRE match dict, float32 on the card."""
    d = fisp_dispatch.device_params(params)
    return (d["FA"], d["phi"], d["TR"], d["TE"], d["T1"], d["T2"], d["B1"],
            d["df"])


def _device_us(event):
    """An event's own device time in microseconds, counted on the device's
    events (kernels, copies) only: an operator on the host also reports
    the device time of the kernels it launched, which its kernels' own
    events already hold."""
    if str(getattr(event, "device_type", "")).endswith("CPU"):
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    return 0.0


def _profile_split(torch, fn, key):
    """Device time of fn() by torch.profiler: (total, kernels whose name
    holds `key`), in microseconds."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    return (sum(_device_us(e) for e in events),
            sum(_device_us(e) for e in events if key in e.key))


def _launch_ms(torch, fn, symbol, reps=5):
    """The kernel's own device time inside the wrapper call fn(), in ms:
    CUDA events recorded on the launch stream just before and just after
    the library's entry point `symbol`, best of `reps` calls after one
    warm-up (independent of torch.profiler)."""
    from epgpy_torch import _build

    load, pairs = _build.load, []

    class Timed:
        def __init__(self, lib):
            self._lib = lib

        def __getattr__(self, name):
            entry = getattr(self._lib, name)
            if name != symbol:
                return entry

            def launch(*args):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                rc = entry(*args)
                stop.record()
                pairs.append((start, stop))
                return rc
            return launch

    _build.load = lambda: Timed(load())
    try:
        for _ in range(reps + 1):
            fn()
        torch.cuda.synchronize()
    finally:
        _build.load = load
    if len(pairs) != reps + 1:
        raise AssertionError(f"{symbol}: {len(pairs)} launches timed, "
                             f"expected {reps + 1}")
    return min(a.elapsed_time(b) for a, b in pairs[1:])


def _split_events(torch, what, name, fn, card, reps=3):
    """Print fn()'s span on the stream and the kernel `name`'s own time
    inside it, both by CUDA events (_cuda_ms, _launch_ms)."""
    own = _launch_ms(torch, fn, f"epg_{name}", reps)
    span = _cuda_ms(torch, fn, reps)
    print(f"[numbers] {what} by CUDA events: the call's span on the stream "
          f"{span:.3f} ms, the {name} kernel (events around its launch) "
          f"{own:.3f} ms, the rest {span - own:.3f} ms ({card})")


def _print_split(what, name, split, card):
    total, kern = split
    if total > 0:
        print(f"[numbers] {what} device time (torch.profiler): "
              f"{total / 1e3:.3f} ms, {name} kernel {kern / 1e3:.3f} ms, "
              f"output assembly and the rest {(total - kern) / 1e3:.3f} ms "
              f"({100 * (total - kern) / total:.1f}%) ({card})")
    else:
        print(f"[numbers] {what} device time: not measured (the profiler "
              f"reported no device time)")


def kernel_entry(torch, card, name, replaces, fns, args, kw, atom_idx,
                 natoms, launches, jac, cut=None, errors=None, work=None):
    """One kernel's line at its main-path shape: kernel and twin on the
    same card tensors (held to TOL_KERNEL / TOL_JAC_KERNEL), their times,
    and the bound from the twin's counted operations and the bytes.
    ``cut(n)`` gives the twin's CPU arguments on the first n atoms (default:
    the per-atom tensors at `atom_idx`), ``errors(kernel, twin)`` the
    (signal, columns) errors (default: _pair_errors); ``work(torch, call,
    natoms)`` the kernel's own operations where it skips some of the
    twin's (``call(n)`` the twin on n atoms): the bound takes them, the
    twin's full count is printed beside it."""
    kfn, pfn = fns

    def kernel():
        return kfn(*args, **kw)

    def plain():
        return pfn(*args, **kw)

    k, p = kernel(), plain()
    sig, cols = (_pair_errors(torch, k, p, jac) if errors is None
                 else errors(k, p))
    flat = lambda o: [t for x in o for t in (  # noqa: E731
        x if isinstance(x, tuple) else (x,))]
    err = max(float((a - b).abs().max()) for a, b in zip(flat(k), flat(p)))
    print(f"[numbers] {name} at {natoms} atoms: max|kernel - plain| = "
          f"{err:.3e}" + (f", per column {', '.join(f'{c:.2e}' for c in cols)}"
                          if cols else ""))
    if not sig <= TOL_KERNEL or (cols and not max(cols) <= TOL_JAC_KERNEL):
        raise AssertionError(f"{name} kernel vs plain twin {sig:.3e} / "
                             f"{max(cols or [0.0]):.3e}")
    del k, p
    k_ms = _cuda_ms(torch, kernel)
    p_ms = _cuda_ms(torch, plain, reps=1, warm=False)
    print(f"[numbers] {name} kernel: {k_ms:.3f} ms = "
          f"{natoms / (k_ms / 1e3):.4g} atoms/s; plain twin {p_ms:.3f} ms "
          f"({card})")
    if cut is None:
        def cut(n):
            return _cpu_atoms(torch, args, n, atom_idx)
    flops = linear_ops(torch, lambda n: pfn(*cut(n), **kw), natoms)
    if work is not None:
        own = work(torch, lambda n: pfn(*cut(n), **kw), natoms)
        print(f"[bound] {name}: the twin's recurrence counts {flops:.4g} "
              f"FLOP -> {flops / PEAK_FP32 * 1e3:.4f} ms at the FP32 peak; "
              f"the bound takes the kernel's own {own:.4g}")
        flops = own
    nbytes = tensor_bytes(torch, args, kernel())
    return {"name": name, "route": "cuda",
            "source": f"epgpy_torch/csrc/{name}.cu", "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": k_ms,
            "plain_ms": p_ms, **bound_fields(name, flops, nbytes)}


def phase_ssfp_numbers(torch, card, bssfp, bjac, dess):
    """The four kernels at their main-path shapes (bSSFP: the benchmark's
    500 x 163,840 train, the Jacobian with the ddf group; DESS: the mapping
    train over 262,144 voxels), simulate()'s host share and device split;
    returns their JSON entries (launches filled in by main)."""
    from epgpy_torch.models import cuda_bssfp, cuda_dess

    atoms = (4, 5, 6, 7)
    dkw = dict(nstate=DESS_NSTATE, demodulate=False)
    entries = [
        kernel_entry(torch, card, "bssfp",
                     "epgpy_tpu/models/pallas_bssfp.py:57",
                     (cuda_bssfp.bssfp_echoes, cuda_bssfp.bssfp_echoes_plain),
                     bssfp["args"], bssfp["kw"], atoms, BSSFP_ATOMS, 0,
                     False),
        kernel_entry(torch, card, "bssfp_jac",
                     "epgpy_tpu/models/pallas_bssfp.py:153",
                     (cuda_bssfp.bssfp_jacobian_echoes,
                      cuda_bssfp.bssfp_jacobian_echoes_plain),
                     bssfp["args"], dict(bssfp["kw"], track_df=True), atoms,
                     BSSFP_ATOMS, 0, True),
        kernel_entry(torch, card, "dess", "epgpy_tpu/models/pallas_dess.py:33",
                     (cuda_dess.dess_echoes, cuda_dess.dess_echoes_plain),
                     dess["args"], dkw, atoms, DESS_NVOX, 0, False),
        kernel_entry(torch, card, "dess_jac",
                     "epgpy_tpu/models/pallas_dess.py:201",
                     (cuda_dess.dess_jacobian_echoes,
                      cuda_dess.dess_jacobian_echoes_plain),
                     dess["args"], dkw, atoms, DESS_NVOX, 0, True),
    ]
    k_ms = entries[0]["ms"]
    print(f"[numbers] simulate() bSSFP {BSSFP_N} pulses x {BSSFP_ATOMS} "
          f"atoms: first {bssfp['first_s']:.4f} s, memoized "
          f"{bssfp['memo_s'] * 1e3:.3f} ms against the kernel's "
          f"{k_ms:.3f} ms: {1 - k_ms / (bssfp['memo_s'] * 1e3):.1%} of the "
          f"memoized call is not the kernel; with the preamble recomputed "
          f"each call {bssfp['nomemo_s'] * 1e3:.3f} ms ({card})")
    print(f"[numbers] simulate() bSSFP Jacobian: first {bjac['first_s']:.4f}"
          f" s, memoized {bjac['memo_s'] * 1e3:.3f} ms ({card})")
    _print_split("simulate() bSSFP Jacobian", "bssfp_jac",
                 _profile_split(torch, bjac["simulate"], "bssfp_jac"), card)
    _print_split("simulate() DESS Jacobian", "dess_jac",
                 _profile_split(torch, dess["simulate"], "dess_jac"), card)
    return entries


def phase_megre_numbers(torch, card, megre, mjac, full, b0, dw,
                        half_bound_ms):
    """The ME-GRE kernels at the main-path shape (the bench's train over
    MEGRE_ATOMS atoms) and the full-ladder kernel at the FISP headline
    shape (nstate 0; at nstate NSTATE beside `half_bound_ms`, fisp_half's
    bound on that train), simulate()'s device split of the ME-GRE
    Jacobian, the T2/B0 and DW-FISP timings; returns the three kernels'
    JSON entries (launches filled in by main)."""
    from epgpy_torch.models import cuda_fisp, cuda_megre

    atoms = (4, 5, 6, 7)
    mkw = dict(nstate=MEGRE_NSTATE, demodulate=False)
    entries = [
        kernel_entry(torch, card, "megre",
                     "epgpy_tpu/models/pallas_megre.py:93",
                     (cuda_megre.megre_echoes, cuda_megre.megre_echoes_plain),
                     megre["args"], mkw, atoms, MEGRE_ATOMS, 0, False),
        kernel_entry(torch, card, "megre_jac",
                     "epgpy_tpu/models/pallas_megre.py:220",
                     (cuda_megre.megre_jacobian_echoes,
                      cuda_megre.megre_jacobian_echoes_plain),
                     megre["args"], mkw, atoms, MEGRE_ATOMS, 0, True),
        # the route users take, fisp_dictionary_cuda(nstate=0) in the
        # echo layout: one ladder row, all of it needed
        kernel_entry(torch, card, "fisp_full",
                     "epgpy_tpu/models/pallas_fisp.py:116",
                     (cuda_fisp.fisp_echoes, cuda_fisp.fisp_echoes_plain),
                     full["args"], dict(nstate=0), atoms, NATOMS, 0, False),
    ]
    # the parity oracle's depth: the literal 2 NSTATE + 1 rows compute the
    # folded train, whose operations fisp_half's count gives
    oracle_ms = _cuda_ms(torch, lambda: cuda_fisp.fisp_full_echoes(
        *full["args"], nstate=NSTATE))
    print(f"[numbers] fisp_full at nstate {NSTATE} (the fold's parity "
          f"oracle): {oracle_ms:.3f} ms against the train's bound "
          f"{half_bound_ms:.4f} ms from fisp_half's counted operations "
          f"({card})")
    k_ms = entries[0]["ms"]
    print(f"[numbers] simulate() ME-GRE {MEGRE_N} TRs x {len(MEGRE_TES)} "
          f"echoes x {MEGRE_ATOMS} atoms: first {megre['first_s']:.4f} s, "
          f"memoized {megre['memo_s'] * 1e3:.3f} ms against the kernel's "
          f"{k_ms:.3f} ms ({card})")
    print(f"[numbers] simulate() ME-GRE (T2, g) Jacobian: first "
          f"{mjac['first_s']:.4f} s, memoized {mjac['memo_s'] * 1e3:.3f} ms "
          f"({card})")
    _print_split("simulate() ME-GRE Jacobian", "megre_jac",
                 _profile_split(torch, mjac["simulate"], "megre_jac"), card)
    _split_events(torch, "simulate() ME-GRE Jacobian", "megre_jac",
                  mjac["simulate"], card)
    dd_ms = _cuda_ms(torch, lambda: cuda_fisp.fisp_jacobian_echoes(
        *dw["jac_args"], **dw["jac_kw"]), reps=3)
    print(f"[numbers] fisp_jac with the dD group (the DW-FISP train's "
          f"matched parameters, {NATOMS} atoms x {NPULSE} pulses, nstate "
          f"{NSTATE}): {dd_ms:.3f} ms ({card})")
    per = b0["per_iter"]
    print(f"[numbers] T2/B0 mapping, {B0_NVOX} voxels: {B0_ITERS} "
          f"Gauss-Newton iterations {b0['gn_s']:.3f} s; per iteration host "
          f"build + match {per['host']:.4f} s + simulate (kernel + assembly) "
          f"{per['simulate']:.4f} s + update/solve {per['solve']:.4f} s; "
          f"RMSE T2 {b0['rmse'][0]:.4f} ms, B0 {1e3 * b0['rmse'][1]:.5f} Hz "
          f"({card})")
    print(f"[numbers] simulate() DW-FISP {NPULSE} pulses x {NATOMS} atoms: "
          f"first {dw['first_s']:.4f} s, memoized {dw['memo_s'] * 1e3:.3f} "
          f"ms; (T1, T2, Dcoef) Jacobian first {dw['jfirst_s']:.4f} s, "
          f"memoized {dw['jmemo_s'] * 1e3:.3f} ms ({card})")
    return entries


# -- composite GRE: kernels vs twins, the cardiac MRF dictionary, the
# MPRAGE Jacobian, MPRAGE T1 and cardiac MRF T1/T2 mapping --


def phase_comp_cases(torch, natoms=4096):
    """The composite kernels vs their plain twins on the card over the
    option cases, the primal and the Jacobian with all four groups (the
    last case with every group set of COMP_GROUP_SETS: none, each alone,
    all), the Jacobian's signal also against the primal kernel's; then the
    segmented Jacobian kernel's edges (COMP_EDGE_CASES) and ragged shapes
    (COMP_SHAPES); returns the worst signal |delta| and the worst
    per-column relative error."""
    from epgpy_torch.models import cuda_composite as cc

    worst_sig = worst_col = 0.0
    wall = dict.fromkeys(("options", "edges", "shapes"), 0.0)
    t0 = time.perf_counter()
    for case in COMP_CASES:
        args, kw = comp_tensors(torch, *make_comp_case(case, natoms), DEVICE)
        k = cc.composite_cuda(*args, **kw)
        sig, _ = _pair_errors(torch, k, cc.composite_plain(*args, **kw),
                              False)
        cols, ok = [], _finite(torch, k)
        sets = COMP_GROUP_SETS if case["name"] == "all" \
            else COMP_GROUP_SETS[-1:]
        for groups in sets:
            kj = cc.composite_jacobian_cuda(*args, groups=groups, **kw)
            s_, c = _pair_errors(torch, kj, cc.composite_jacobian_plain(
                *args, groups=groups, **kw), True)
            same, _ = _pair_errors(torch, kj[0], k, False)
            sig, cols = max(sig, s_, same), cols + c
            ok = ok and _finite(torch, kj)
        print(f"[comp-cases] {case['name']:15s} nstate={kw['nstate']:2d} "
              f"max|kernel - plain| = {sig:.3e}, columns over "
              f"{len(sets)} group set(s) "
              f"{', '.join(f'{c:.2e}' for c in cols)}")
        if not ok or not sig <= TOL_KERNEL or not max(cols) <= TOL_JAC_KERNEL:
            raise AssertionError(
                f"composite case {case['name']}: kernel vs plain twin "
                f"{sig:.3e} / {max(cols):.3e} over {TOL_KERNEL} / "
                f"{TOL_JAC_KERNEL} or not finite")
        worst_sig, worst_col = max(worst_sig, sig), max(worst_col, max(cols))
    wall["options"] = time.perf_counter() - t0
    runs = [("edges", case, groups, COMP_EDGE_ATOMS, COMP_EDGE_N)
            for case, groups in COMP_EDGE_CASES]
    runs += [("shapes", dict(_COMP_ALL, name=f"ragged_n{nst}", nstate=nst),
              COMP_GROUP_SETS[-1], n, ns)
             for n, ns in COMP_SHAPES for nst in (1, COMPJ_NSTATE)]
    for part, case, groups, n, ns in runs:
        t0 = time.perf_counter()
        args, kw = comp_tensors(torch, *make_comp_case(case, n, ns), DEVICE)
        kj = cc.composite_jacobian_cuda(*args, groups=groups, **kw)
        sig, cols = _pair_errors(torch, kj, cc.composite_jacobian_plain(
            *args, groups=groups, **kw), True)
        print(f"[comp-cases] {case['name']:15s} B={n:5d} N={ns:3d} "
              f"nstate={kw['nstate']:3d} groups {','.join(groups)}: "
              f"max|kernel - plain| = {sig:.3e}, columns "
              f"{', '.join(f'{c:.2e}' for c in cols)}")
        if (not _finite(torch, kj) or not sig <= TOL_KERNEL
                or not max(cols) <= TOL_JAC_KERNEL):
            raise AssertionError(
                f"composite Jacobian edge {case['name']} (B={n}, N={ns}): "
                f"kernel vs plain twin {sig:.3e} / {max(cols):.3e} over "
                f"{TOL_KERNEL} / {TOL_JAC_KERNEL} or not finite")
        worst_sig, worst_col = max(worst_sig, sig), max(worst_col, max(cols))
        wall[part] += time.perf_counter() - t0
    t0 = time.perf_counter()
    runs = [(case, COMP_EDGE_ATOMS, COMP_PRIMAL_TOP_N
             if case["shift"] == "up" else COMP_EDGE_N)
            for case in COMP_PRIMAL_EDGE_CASES]
    runs += [(dict(_COMP_ALL, name=f"primal_ragged_n{nst}", nstate=nst), n,
              ns) for n, ns in COMP_SHAPES for nst in COMP_PRIMAL_SHAPE_NSTATES]
    for case, n, ns in runs:
        sig, ok = comp_vs_twin(torch, case, n, ns)
        print(f"[comp-cases] primal {case['name']:18s} B={n:5d} N={ns:3d} "
              f"nstate={case['nstate']:3d}: max|kernel - plain| = {sig:.3e}")
        if not ok or not sig <= TOL_KERNEL:
            raise AssertionError(
                f"composite primal edge {case['name']} (B={n}, N={ns}): "
                f"kernel vs plain twin {sig:.3e} over {TOL_KERNEL} or not "
                f"finite")
        worst_sig = max(worst_sig, sig)
    wall["primal"] = time.perf_counter() - t0
    _print_wall("phase_comp_cases", wall)
    return worst_sig, worst_col


def comp_vs_twin(torch, case, natoms, nstage):
    """The composite primal kernel against its plain twin on one option
    case: (max |delta| over re and im, whether the kernel's echoes are
    finite); raises unless the wrapper launched the kernel once."""
    from epgpy_torch.models import cuda_composite as cc

    args, kw = comp_tensors(torch, *make_comp_case(case, natoms, nstage),
                            DEVICE)
    before = cc.LAUNCHES
    k = cc.composite_echoes(*args, **kw)
    torch.cuda.synchronize()
    if cc.LAUNCHES != before + 1:
        raise AssertionError(f"composite {case['name']}: the kernel did not "
                             f"run")
    sig, _ = _pair_errors(torch, k, cc.composite_plain(*args, **kw), False)
    return sig, _finite(torch, k)


def cardiac_train(epg, T1, T2, track=None):
    """examples/cardiac_mrf_t1t2.py's schedule as plain operators: CMRF_NBEAT
    beats, each an optional prep (inversion + TI 21 ms, or a 90x-180y-90-x
    T2prep with a crusher), CMRF_NREAD FISP readouts on a sinusoidal flip
    ramp and the rest of the R-R interval."""
    o1 = {"order1": track} if track else {}
    rng = np.random.default_rng(2)
    seq = []
    for b in range(CMRF_NBEAT):
        prep = CMRF_PREPS[b % len(CMRF_PREPS)]
        used = 0.0
        if prep == "ir":
            seq += [epg.T(180.0, 0.0), epg.E(21.0, T1, T2, **o1)]
            used += 21.0
        elif prep:
            tep = float(prep[6:])
            seq += [epg.T(90.0, 0.0), epg.E(tep / 2, T1, T2, **o1),
                    epg.T(180.0, 90.0), epg.E(tep / 2, T1, T2, **o1),
                    epg.T(90.0, 180.0), epg.S(1)]
            used += tep
        fas = 4.0 + 11.0 * np.sin(np.pi * (np.arange(CMRF_NREAD) + 1)
                                  / (CMRF_NREAD + 1)) + rng.uniform(
                                      -0.5, 0.5, CMRF_NREAD)
        for fa in fas:
            seq += [epg.T(float(fa), 0.0), epg.E(CMRF_TE, T1, T2, **o1),
                    epg.ADC, epg.E(CMRF_TRG - CMRF_TE, T1, T2, **o1),
                    epg.S(1)]
        used += CMRF_NREAD * CMRF_TRG
        seq.append(epg.E(max(CMRF_RR - used, 50.0), T1, T2, **o1))
    return seq


def cardiac_grid(shape=CMRF_GRID):
    """The dictionary's (T1, T2) atoms on a T1 x T2 grid of `shape`, (A, 2),
    T2 < 0.8 T1."""
    t1g = np.linspace(300.0, 2000.0, shape[0])
    t2g = np.geomspace(20.0, 250.0, shape[1])
    g = np.stack(np.meshgrid(t1g, t2g, indexing="ij"), -1).reshape(-1, 2)
    return g[g[:, 1] < 0.8 * g[:, 0]]


def comp_golden_sequence(epg, name, g):
    """The trains of tests/golden/mprage.npz and cardiac_mrf.npz
    (tests/test_composite_dispatch.py:67-78, :86-105)."""
    T1s, T2s = g["T1s"], g["T2s"]
    seq = []
    if name == "mprage":
        for seg in range(4):
            seq += [epg.T(180, 0), epg.E(120.0, T1s, T2s)]
            for i in range(8):
                seq += [epg.T(9.0 + 0.5 * i + seg, 30.0 * i),
                        epg.E(3.0, T1s, T2s), epg.ADC,
                        epg.E(5.5, T1s, T2s), epg.S(1)]
            seq += [epg.E(250.0, T1s, T2s)]
        return seq
    eco = [12.0, 24.0, 12.0]
    for blk in range(3):
        scale = blk + 1.0
        seq += [epg.T(90, 0), epg.E(eco[0] * scale, T1s, T2s),
                epg.T(180, 90), epg.E(eco[1] * scale, T1s, T2s),
                epg.T(180, 90), epg.E(eco[2] * scale, T1s, T2s),
                epg.T(90, 180), epg.S(1)]
        for i in range(10):
            seq += [epg.T((12.0 + i + 2.0 * blk) * g["B1s"][None, :],
                          15.0 * i), epg.E(2.5, T1s, T2s), epg.ADC,
                    epg.E(6.0, T1s, T2s), epg.S(1)]
        seq += [epg.E(180.0, T1s, T2s)]
    return seq


def phase_comp_path(torch, epg):
    """The cardiac MRF dictionary (CMRF_GRID atoms, 275 stages, 256
    readouts) through simulate() (first call and memoized) and through
    composite_echoes on the matched parameters, 8 atoms against the float64
    general path, the golden mprage.npz and cardiac_mrf.npz trains on the
    card; returns the run's facts."""
    from epgpy_torch import config, fisp_dispatch
    from epgpy_torch.models import cuda_composite

    grid = cardiac_grid()
    seq = cardiac_train(epg, grid[:, 0], grid[:, 1])
    kw = dict(max_nstate=CMRF_NSTATE, asarray=False)
    _reset_counts(cuda_composite)
    out, first_s = _first_call(torch, lambda: epg.simulate(seq, **kw))
    params = fisp_dispatch.match_composite(seq)
    args, ckw = fisp_dispatch._comp_call(params, CMRF_NSTATE)
    re, im = cuda_composite.composite_echoes(*args, **ckw)
    same = bool(torch.equal(out.real, re) and torch.equal(out.imag, im))
    del re, im
    gerr = {}
    for name in ("mprage", "cardiac_mrf"):
        g = _golden(name)
        got = epg.simulate(comp_golden_sequence(epg, name, g))
        gerr[name] = float(np.abs(got - g["signal"]).max())
    torch.cuda.synchronize()
    _expect("comp", (dict(fisp_dispatch.DISPATCH_COUNTS),
                     cuda_composite.LAUNCHES), ({"comp": 3}, 4))
    probe = np.linspace(0, len(grid) - 1, 8).astype(int)
    with cpu_float64(config):
        ref = epg.simulate(cardiac_train(epg, grid[probe, 0],
                                         grid[probe, 1]),
                           max_nstate=CMRF_NSTATE, fisp_kernel=False)
    err = float(np.abs(out[:, probe].cpu().numpy() - ref).max())
    shape = (CMRF_NBEAT * CMRF_NREAD, len(grid))
    print(f"[comp] simulate(): cardiac MRF, {len(params['FA'])} stages x "
          f"{len(grid)} atoms -> {tuple(out.shape)} {out.dtype}; "
          f"composite_echoes on the matched parameters "
          f"{'==' if same else '!='} simulate(); 8 atoms vs the f64 general "
          f"path {err:.3e} (limit {TOL_PROBE}); goldens on the card "
          + ", ".join(f"{k} {v:.3e}" for k, v in gerr.items())
          + f" (limit {TOL_COMP_GOLDEN})")
    if (tuple(out.shape) != shape or out.dtype != torch.complex64
            or not same or not _finite(torch, torch.view_as_real(out))
            or not err <= TOL_PROBE
            or not max(gerr.values()) <= TOL_COMP_GOLDEN):
        raise AssertionError("composite path: shape, finiteness, direct call, "
                             "f64 error or golden error out of bounds")
    memo_s = _host_s(torch, lambda: epg.simulate(seq, **kw), reps=3)
    print(f"[comp] simulate() first {first_s:.4f} s, memoized "
          f"{memo_s * 1e3:.3f} ms")
    return dict(args=args, kw=ckw, launches=4, first_s=first_s,
                memo_s=memo_s, gerr=gerr, err=err, grid=grid,
                dictionary=out)


def comp_jac_draws():
    """The 4o train's readout flips (MPR_NSEG, MPR_NREAD) and its atoms
    T1, T2, B1 and df (kHz), each (COMPJ_ATOMS,)."""
    rng = np.random.default_rng(COMPJ_SEED)
    FA = rng.uniform(6.0, 14.0, (MPR_NSEG, MPR_NREAD))
    n = COMPJ_ATOMS
    return (FA, rng.uniform(400.0, 1800.0, n), rng.uniform(30.0, 150.0, n),
            rng.uniform(0.85, 1.15, n), rng.uniform(-0.02, 0.02, n))


def comp_jac_sequence(epg, FA, T1, T2, B1, df):
    """tests/test_composite_jacobian.py:20-44's MPRAGE train: per segment an
    adiabatic T(180) (B1-insensitive) and E(TI), readouts [T(fa B1) tracking
    B1, E(2.2), ADC, E(3.8), S(1)], E(TD); the E ops track T1, T2 and g."""
    o1 = ["T1", "T2", "g"]
    seq = []
    for s, fas in enumerate(FA):
        seq += [epg.T(180.0, 0.0), epg.E(12.0 + s, T1, T2, df, order1=o1)]
        for fa in fas:
            seq += [epg.T(fa * B1, 0.0, order1={"B1": {"alpha": float(fa)}}),
                    epg.E(2.2, T1, T2, df, order1=o1), epg.ADC,
                    epg.E(3.8, T1, T2, df, order1=o1), epg.S(1)]
        seq += [epg.E(80.0 + 5 * s, T1, T2, df, order1=o1)]
    return seq


def phase_comp_jac_path(torch, epg):
    """The MPRAGE Jacobian (all four groups: 30 planes) over COMPJ_ATOMS
    atoms through simulate(probe=[ADC, Jacobian(COMPJ_NAMES)]); the first
    COMPJ_TWIN atoms against the Jacobian kernel's twin on the same card
    tensors, 8 atoms over the first COMPJ_F64_SEG segments against the
    float64 general diff path; returns the run's facts."""
    from epgpy_torch import config, fisp_dispatch
    from epgpy_torch.models import cuda_composite

    FA, T1, T2, B1, DF = comp_jac_draws()
    seq = comp_jac_sequence(epg, FA, T1, T2, B1, DF)
    probes = [epg.ADC, epg.Jacobian(COMPJ_NAMES)]
    kw = dict(max_nstate=COMPJ_NSTATE, asarray=False, probe=probes)
    _reset_counts(cuda_composite)
    (sig, jac), first_s = _first_call(torch, lambda: epg.simulate(seq, **kw))
    _expect("comp-jac", (dict(fisp_dispatch.DISPATCH_COUNTS),
                         cuda_composite.JAC_LAUNCHES), ({"jac:comp": 1}, 1))
    nadc = MPR_NSEG * MPR_NREAD
    if (tuple(jac.shape) != (nadc, COMPJ_ATOMS, len(COMPJ_NAMES))
            or jac.dtype != torch.complex64
            or not _finite(torch, (torch.view_as_real(sig),
                                   torch.view_as_real(jac)))):
        raise AssertionError("composite Jacobian path: shape or finiteness")
    # the kernel's columns against the twin's on the same tensors: the
    # twin's groups (T1, T2, B1, df), B1 over the matcher's b1_scale
    params = fisp_dispatch.match_composite(seq)
    args, ckw = fisp_dispatch._comp_call(params, COMPJ_NSTATE)
    n = COMPJ_TWIN
    (pre, pim), (pdre, pdim) = cuda_composite.composite_jacobian_plain(
        *args[:8], *(None if a is None else a[:n] for a in args[8:]), **ckw)
    want = torch.complex(pdre, pdim)
    want[..., 2] /= params["b1_scale"]
    twin_sig = float((sig[:, :n] - torch.complex(pre, pim)).abs().max())
    twin_cols = col_errors(jac[:, :n, 1:].cpu().numpy(), want.cpu().numpy())
    del pre, pim, pdre, pdim, want
    # the float64 oracle over the first COMPJ_F64_SEG segments (a prefix)
    npre = COMPJ_F64_SEG * MPR_NREAD
    with cpu_float64(config):
        s64, j64 = epg.simulate(
            comp_jac_sequence(epg, FA[:COMPJ_F64_SEG], T1[:8], T2[:8],
                              B1[:8], DF[:8]),
            probe=probes, max_nstate=COMPJ_NSTATE, fisp_kernel=False)
    sig_err = float(np.abs(sig[:npre, :8].cpu().numpy() - s64).max())
    cols = col_errors(jac[:npre, :8].cpu().numpy(), j64)
    print(f"[comp-jac] simulate(probe=[ADC, Jacobian({COMPJ_NAMES})]): "
          f"{len(params['FA'])} stages x {COMPJ_ATOMS} atoms -> "
          f"{tuple(jac.shape)}; first {n} atoms vs the twin: signal "
          f"{twin_sig:.3e}, columns (T1, T2, B1, g) "
          f"{', '.join(f'{c:.3e}' for c in twin_cols)} (limits {TOL_KERNEL}, "
          f"{TOL_JAC_KERNEL}); first {npre} readouts x 8 atoms vs the f64 "
          f"general diff path: signal {sig_err:.3e}, columns "
          f"{', '.join(f'{c:.3e}' for c in cols)} (limits {TOL_PROBE}, "
          f"{TOL_JAC_MODEL})")
    if not twin_sig <= TOL_KERNEL or not max(twin_cols) <= TOL_JAC_KERNEL:
        raise AssertionError("the composite Jacobian kernel disagrees with "
                             "its plain twin on the main path")
    if not sig_err <= TOL_PROBE or not max(cols) <= TOL_JAC_MODEL:
        raise AssertionError(f"composite Jacobian path error {sig_err:.3e} / "
                             f"{max(cols):.3e}")
    del sig, jac
    memo_s = _host_s(torch, lambda: epg.simulate(seq, **kw), reps=2)
    print(f"[comp-jac] simulate() first {first_s:.4f} s, memoized "
          f"{memo_s * 1e3:.3f} ms")
    return dict(args=args, kw=ckw, launches=1, first_s=first_s,
                memo_s=memo_s, twin_cols=twin_cols, cols=cols,
                simulate=lambda: epg.simulate(seq, **kw))


def mprage_train(epg, T1, T2, track=None):
    """examples/mprage_t1_mapping.py's acquisition as plain operators: per
    segment an adiabatic inversion and TI, MPR_NREAD RF-spoiled readouts
    (117-degree quadratic phase cycling, demodulated ADC) and TD."""
    ph = np.cumsum(np.arange(MPR_NSEG * MPR_NREAD) * 117.0) % 360.0
    o1 = {"order1": track} if track else {}
    seq = []
    j = 0
    for _ in range(MPR_NSEG):
        seq += [epg.T(180.0, 0.0), epg.E(MPR_TI, T1, T2, **o1)]
        for _ in range(MPR_NREAD):
            seq += [epg.T(MPR_FA, float(ph[j])), epg.E(MPR_TE, T1, T2, **o1),
                    epg.Adc(phase=-float(ph[j])),
                    epg.E(MPR_TRG - MPR_TE, T1, T2, **o1), epg.S(1)]
            j += 1
        seq += [epg.E(MPR_TD, T1, T2, **o1)]
    return seq


def _unit_rows(x):
    """Rows of a complex (n, P) tensor scaled to unit norm."""
    return x / x.abs().square().sum(dim=1, keepdim=True).sqrt()


def _gn_signal_and_jac(torch, epg, train, names, nstate, voxels, split,
                       first):
    """The Gauss-Newton signal_and_jac of a composite mapping: theta ->
    the tracked train through simulate(probe=[ADC, Jacobian(names)]), host
    build + match and simulate() timed into `split`; the first call keeps
    its match dict and the Jacobian of its first `voxels` voxels."""
    from epgpy_torch import fisp_dispatch

    def signal_and_jac(theta):
        t0 = time.perf_counter()
        seq = train(theta)
        params = fisp_dispatch.match_composite(seq)  # memoized for simulate
        t1 = time.perf_counter()
        s, j = epg.simulate(seq, max_nstate=nstate, asarray=False,
                            probe=[epg.ADC, epg.Jacobian(names)])
        torch.cuda.synchronize()
        split["host"] += t1 - t0
        split["simulate"] += time.perf_counter() - t1
        if not first:
            first.append((params, j[:, :voxels].clone()))
        return (s.real, s.imag), (j.real, j.imag)

    return signal_and_jac


def _first_jac_vs_twin(torch, first, nstate, groups, voxels):
    """Per-column errors of the first Gauss-Newton Jacobian against the
    composite Jacobian kernel's twin on the same parameters."""
    from epgpy_torch import fisp_dispatch
    from epgpy_torch.models import cuda_composite

    params, kj = first[0]
    args, ckw = fisp_dispatch._comp_call(params, nstate)
    _, (pdre, pdim) = cuda_composite.composite_jacobian_plain(
        *args[:8], *(None if a is None else a[:voxels] for a in args[8:]),
        groups=groups, **ckw)
    return col_errors(kj.cpu().numpy(),
                      torch.complex(pdre, pdim).cpu().numpy())


def phase_mprage_mapping(torch, epg):
    """MPRAGE T1 mapping (examples/mprage_t1_mapping.py) of MPR_NVOX voxels:
    the example's T1-only dictionary and draws through simulate(), the
    match, and MPR_ITERS Gauss-Newton iterations (solve_scale) on the
    composite Jacobian kernel's T1 group (12 planes), held to the example's
    two asserts; the first Jacobian against the twin on 512 voxels; returns
    the run's facts."""
    from epgpy_torch import fisp_dispatch
    from epgpy_torch.models import cuda_composite
    from epgpy_torch.parallel import dictionary_match, gauss_newton_refine

    rng = np.random.default_rng(MPR_SEED)
    grid = np.linspace(300.0, 3000.0, MPR_NT1)
    step = grid[1] - grid[0]
    V = MPR_NVOX
    kw = dict(max_nstate=MPR_NSTATE, asarray=False)
    _reset_counts(cuda_composite)
    D = _unit_rows(epg.simulate(mprage_train(epg, grid, 80.0), **kw).T)
    t1_true = rng.uniform(350.0, 2900.0, V)
    t2_true = rng.uniform(55.0, 140.0, V)
    vseq = mprage_train(epg, t1_true, t2_true)
    clean = epg.simulate(vseq, **kw).T
    pd = torch.as_tensor((rng.uniform(0.6, 1.2, V) * np.exp(
        2j * np.pi * rng.uniform(size=V)))[:, None].astype(np.complex64),
        device=DEVICE)
    noise = torch.as_tensor((rng.normal(0.0, MPR_NOISE, clean.shape)
                             * (1 + 1j)).astype(np.complex64), device=DEVICE)

    def match(clean):
        """Unit-norm noisy voxels and their T1 errors after the match."""
        obs = _unit_rows(clean * pd + noise)
        idx, _ = dictionary_match(D.real, D.imag, obs.real, obs.imag)
        return obs, grid[idx.cpu().numpy()], np.abs(
            grid[idx.cpu().numpy()] - t1_true)

    t0 = time.perf_counter()
    obs, t1_hat, err = match(clean)
    torch.cuda.synchronize()
    match_s = time.perf_counter() - t0
    del clean
    # the example's nearest-grid-point assert is a max over its 48 voxels;
    # over many more the tail passes a grid step (the float64 JAX general
    # path on the same draws: 41.18 ms at 8,192 voxels, 0.13% of them past
    # 1.01 steps).  Where it fails, the twin's voxel trains must fail it
    # alike, and the match RMS must stay within one grid step.
    twin_max = None
    if not err.max() <= 1.01 * step:
        args, ckw = fisp_dispatch._comp_call(
            fisp_dispatch.match_composite(vseq), MPR_NSTATE)
        tre, tim = cuda_composite.composite_plain(*args, **ckw)
        twin_max = float(match(torch.complex(tre, tim).T)[2].max())
        del tre, tim

    split = {"host": 0.0, "simulate": 0.0}
    first = []
    sj = _gn_signal_and_jac(torch, epg, lambda th: mprage_train(
        epg, th[0], 80.0, track=["T1"]), ["T1"], MPR_NSTATE, 512, split,
        first)
    t0 = time.perf_counter()
    theta = gauss_newton_refine(sj, t1_hat[None], obs.T.real, obs.T.imag,
                                iters=MPR_ITERS, bounds=[(200.0, 3200.0)],
                                solve_scale=True)
    torch.cuda.synchronize()
    gn_s = time.perf_counter() - t0
    launches = dict(composite=cuda_composite.LAUNCHES,
                    composite_jac=cuda_composite.JAC_LAUNCHES)
    _expect("mprage-map", (dict(fisp_dispatch.DISPATCH_COUNTS), launches),
            ({"comp": 2, "jac:comp": MPR_ITERS},
             dict(composite=2, composite_jac=MPR_ITERS)))
    jcols = _first_jac_vs_twin(torch, first, MPR_NSTATE, ("T1",), 512)
    rms0 = float(np.sqrt(np.mean(err ** 2)))
    rms1 = float(np.sqrt(np.mean((theta[0] - t1_true) ** 2)))
    per = {k: v / MPR_ITERS for k, v in split.items()}
    per["solve"] = gn_s / MPR_ITERS - per["host"] - per["simulate"]
    held = (f"max |err| {err.max():.2f} ms (limit {1.01 * step:.2f}, 1.01 "
            f"grid steps)")
    if twin_max is not None:
        held += (f": beyond it, as the twin's {twin_max:.2f} ms; held "
                 f"instead: match RMS <= one grid step {step:.2f} ms")
    print(f"[mprage-map] {V} voxels x {MPR_NSEG * MPR_NREAD} readouts, "
          f"{MPR_NT1}-atom T1 dictionary: match {match_s * 1e3:.2f} ms, "
          f"{held}; match RMS {rms0:.3f} ms; {MPR_ITERS} Gauss-Newton "
          f"iterations {gn_s:.3f} s: RMS {rms1:.3f} ms (limit "
          f"{0.8 * rms0:.3f}); first Jacobian vs the twin on 512 voxels "
          f"{jcols[0]:.3e} (limit {TOL_JAC_KERNEL})")
    if not jcols[0] <= TOL_JAC_KERNEL:
        raise AssertionError("the composite Jacobian kernel disagrees with "
                             "its plain twin in the MPRAGE fit")
    matched = (err.max() <= 1.01 * step if twin_max is None
               else twin_max > 1.01 * step and rms0 <= step)
    if not (matched and rms1 < 0.8 * rms0):
        raise AssertionError(f"MPRAGE T1 mapping misses the example's "
                             f"asserts: {held}, RMS {rms0:.3f} -> "
                             f"{rms1:.3f} ms")
    return dict(launches=launches, gn_s=gn_s, per_iter=per, match_s=match_s,
                err_max=float(err.max()), twin_max=twin_max,
                rms=(rms0, rms1))


def phase_cardiac_mapping(torch, epg, comp):
    """Cardiac MRF T1/T2 mapping (examples/cardiac_mrf_t1t2.py) of
    CMRF_NVOX voxels against phase 4n's dictionary: the example's draws
    through simulate(), the match, and CMRF_ITERS Gauss-Newton iterations
    of (T1, T2) (18 planes); the first Jacobian against the twin on 512
    voxels; returns the run's facts.

    The example's assert halves the RMSE of a match against its own 20 x
    16 dictionary.  The 127,988-atom match already sits near the
    refinement's noise floor, so the refined maps are held to half the
    example dictionary's match (simulated here too) and below the fine
    match's."""
    from epgpy_torch import fisp_dispatch
    from epgpy_torch.models import cuda_composite
    from epgpy_torch.parallel import dictionary_match, gauss_newton_refine

    grid = comp["grid"]
    D = _unit_rows(comp["dictionary"].T)
    rng = np.random.default_rng(CMRF_SEED)
    V = CMRF_NVOX
    t1_true = rng.uniform(350.0, 1900.0, V)
    t2_true = np.minimum(rng.uniform(25.0, 220.0, V), 0.6 * t1_true)
    _reset_counts(cuda_composite)
    clean = epg.simulate(cardiac_train(epg, t1_true, t2_true),
                         max_nstate=CMRF_NSTATE, asarray=False).T
    pd = rng.uniform(0.6, 1.2, V) * np.exp(2j * np.pi * rng.uniform(size=V))
    noise = rng.normal(0.0, CMRF_NOISE, clean.shape) * (1 + 1j)
    obs = (clean * torch.as_tensor(pd[:, None].astype(np.complex64),
                                   device=DEVICE)
           + torch.as_tensor(noise.astype(np.complex64), device=DEVICE))
    del clean
    nobs = _unit_rows(obs)
    t0 = time.perf_counter()
    idx, _ = dictionary_match(D.real, D.imag, nobs.real, nobs.imag,
                              atom_chunk=16384)
    torch.cuda.synchronize()
    match_s = time.perf_counter() - t0
    fit = grid[idx.cpu().numpy()]
    truth = np.stack([t1_true, t2_true])

    def rmse(est):
        return np.sqrt(np.mean((est - truth) ** 2, axis=1))

    err0 = rmse(fit.T)
    egrid = cardiac_grid(CMRF_EXAMPLE_GRID)
    ED = _unit_rows(epg.simulate(cardiac_train(epg, egrid[:, 0],
                                               egrid[:, 1]),
                                 max_nstate=CMRF_NSTATE, asarray=False).T)
    eidx, _ = dictionary_match(ED.real, ED.imag, nobs.real, nobs.imag)
    errE = rmse(egrid[eidx.cpu().numpy()].T)

    split = {"host": 0.0, "simulate": 0.0}
    first = []
    names = ["T1", "T2"]
    sj = _gn_signal_and_jac(torch, epg, lambda th: cardiac_train(
        epg, th[0], th[1], track=names), names, CMRF_NSTATE, 512, split,
        first)
    t0 = time.perf_counter()
    theta = gauss_newton_refine(sj, fit.T.copy(), obs.T.real, obs.T.imag,
                                iters=CMRF_ITERS,
                                bounds=[(200.0, 2500.0), (10.0, 400.0)],
                                solve_scale=True)
    torch.cuda.synchronize()
    gn_s = time.perf_counter() - t0
    launches = dict(composite=cuda_composite.LAUNCHES,
                    composite_jac=cuda_composite.JAC_LAUNCHES)
    _expect("cardiac-map", (dict(fisp_dispatch.DISPATCH_COUNTS), launches),
            ({"comp": 2, "jac:comp": CMRF_ITERS},
             dict(composite=2, composite_jac=CMRF_ITERS)))
    jcols = _first_jac_vs_twin(torch, first, CMRF_NSTATE, ("T1", "T2"), 512)
    err1 = rmse(theta)
    per = {k: v / CMRF_ITERS for k, v in split.items()}
    per["solve"] = gn_s / CMRF_ITERS - per["host"] - per["simulate"]
    print(f"[cardiac-map] {V} voxels x {len(grid)} atoms: match "
          f"{match_s * 1e3:.1f} ms, RMSE T1 {err0[0]:.3f} ms, T2 "
          f"{err0[1]:.3f} ms (the example's {len(egrid)}-atom dictionary: "
          f"T1 {errE[0]:.3f} ms, T2 {errE[1]:.3f} ms); {CMRF_ITERS} "
          f"Gauss-Newton iterations {gn_s:.3f} s: RMSE T1 {err1[0]:.3f} ms, "
          f"T2 {err1[1]:.3f} ms (limits half the example dictionary's "
          f"match and below the fine match's); first Jacobian vs the twin "
          f"on 512 voxels, columns (T1, T2) "
          f"{', '.join(f'{c:.3e}' for c in jcols)} (limit {TOL_JAC_KERNEL})")
    if not max(jcols) <= TOL_JAC_KERNEL:
        raise AssertionError("the composite Jacobian kernel disagrees with "
                             "its plain twin in the cardiac MRF fit")
    if not ((err1 < 0.5 * errE).all() and (err1 < err0).all()):
        raise AssertionError(f"cardiac MRF mapping misses the example's "
                             f"asserts: RMSE {errE} (example dictionary), "
                             f"{err0} (fine) -> {err1}")
    return dict(launches=launches, gn_s=gn_s, per_iter=per, match_s=match_s,
                rmse=(errE, err0, err1))


def phase_comp_numbers(torch, card, comp, cjac, mpr, cmrf):
    """The composite kernels at their main-path shapes (the cardiac MRF
    dictionary of 4n; the MPRAGE Jacobian of 4o, all four groups),
    simulate()'s latencies, the Jacobian's device split and the two
    mappings' Gauss-Newton splits; returns the JSON entries (launches
    filled in by main)."""
    from epgpy_torch.models import cuda_composite as cc

    atoms = (8, 9, 10, 11)
    entries = [
        kernel_entry(torch, card, "composite",
                     "epgpy_tpu/models/pallas_composite.py:69",
                     (cc.composite_echoes, cc.composite_plain), comp["args"],
                     comp["kw"], atoms, len(comp["grid"]), 0, False),
        kernel_entry(torch, card, "composite_jac",
                     "epgpy_tpu/models/pallas_composite.py:364",
                     (cc.composite_jacobian_echoes,
                      cc.composite_jacobian_plain), cjac["args"], cjac["kw"],
                     atoms, COMPJ_ATOMS, 0, True),
    ]
    print(f"[numbers] simulate() cardiac MRF dictionary, "
          f"{len(comp['grid'])} atoms: first {comp['first_s']:.4f} s, "
          f"memoized {comp['memo_s'] * 1e3:.3f} ms against the kernel's "
          f"{entries[0]['ms']:.3f} ms ({card})")
    print(f"[numbers] simulate() MPRAGE Jacobian, {COMPJ_ATOMS} atoms, 4 "
          f"groups: first {cjac['first_s']:.4f} s, memoized "
          f"{cjac['memo_s'] * 1e3:.3f} ms against the kernel's "
          f"{entries[1]['ms']:.3f} ms ({card})")
    _print_split("simulate() MPRAGE Jacobian", "composite_jac",
                 _profile_split(torch, cjac["simulate"], "composite_jac"),
                 card)
    for what, run, iters in (("MPRAGE T1 mapping", mpr, MPR_ITERS),
                             ("cardiac MRF T1/T2 mapping", cmrf,
                              CMRF_ITERS)):
        per = run["per_iter"]
        print(f"[numbers] {what}: match {run['match_s'] * 1e3:.2f} ms; "
              f"{iters} Gauss-Newton iterations {run['gn_s']:.3f} s, per "
              f"iteration host build + match {per['host']:.4f} s + simulate "
              f"(kernel + assembly) {per['simulate']:.4f} s + update/solve "
              f"{per['solve']:.4f} s ({card})")
    return entries


# -- EPG-X: kernels vs twins, the spoiled, balanced and MT-prepared trains,
# the goldens, the qMT and exchange-rate Gauss-Newton fits --


def _x_errors(torch, got, want, jac):
    """(max |delta| of the signals, per-column relative errors) of two
    EPG-X kernel outputs: the Jacobian's columns are its variables (and,
    for the composite, its groups after the primal), each relative to the
    column's largest magnitude."""
    if not jac:
        return max(float((g - w).abs().max()) for g, w in zip(got, want)), []
    if isinstance(got[0], tuple):          # xgre: ((re, im), (jre, jim))
        (kre, kim), (kdre, kdim) = got
        (pre, pim), (pdre, pdim) = want
    else:                                  # xcomposite: (re, im) with G
        kre, kim, pre, pim = got[0][:, 0], got[1][:, 0], want[0][:, 0], \
            want[1][:, 0]
        kdre, kdim, pdre, pdim = got[0][:, 1:], got[1][:, 1:], \
            want[0][:, 1:], want[1][:, 1:]
    sig = max(float((kre - pre).abs().max()), float((kim - pim).abs().max()))
    cols = []
    for v in range(pdre.shape[1]):         # the variables' axis
        d = max(float((kdre[:, v] - pdre[:, v]).abs().max()),
                float((kdim[:, v] - pdim[:, v]).abs().max()))
        scale = max(float(pdre[:, v].abs().max()),
                    float(pdim[:, v].abs().max()), 1e-30)
        cols.append(d / scale)
    return sig, cols


def phase_xcases(torch, family, natoms=4096):
    """The EPG-X kernels (`family` "xgre" or "xcomp") vs their plain twins
    on the card over the option cases, the primal and the Jacobian with
    two variables; then the segmented Jacobian kernel's edges and ragged
    shapes (XGRE_EDGE_CASES and XGRE_SHAPES; XCOMP_EDGE_CASES and
    XCOMP_SHAPES); returns the worst signal |delta| and the worst
    per-column relative error."""
    from epgpy_torch.models import cuda_xcomposite, cuda_xgre

    if family == "xgre":
        cases, mk, mkj, tens = (XGRE_CASES, make_xgre_case,
                                make_xgre_jac_case, xgre_tensors)
        fns = ((cuda_xgre.xgre_dictionary_cuda,
                cuda_xgre.xgre_dictionary_plain),
               (cuda_xgre.xgre_jacobian_cuda, cuda_xgre.xgre_jacobian_plain))
    else:
        cases, mk, mkj, tens = (XCOMP_CASES, make_xcomp_case,
                                make_xcomp_jac_case, xcomp_tensors)
        fns = ((cuda_xcomposite.xcomposite_cuda,
                cuda_xcomposite.xcomposite_plain),
               (cuda_xcomposite.xcomposite_jacobian_cuda,
                cuda_xcomposite.xcomposite_jacobian_plain))
    worst_sig = worst_col = 0.0
    for case in cases:
        args, kw = mk(case, natoms)
        targs = tens(torch, args, DEVICE)
        k = fns[0][0](*targs, **kw)
        sig, _ = _x_errors(torch, k, fns[0][1](*targs, **kw), False)
        ok = _finite(torch, k)
        jargs, jkw = mkj(torch, case, natoms)
        targs = tens(torch, jargs, DEVICE, jac=True)
        kj = fns[1][0](*targs, **jkw)
        s_, cols = _x_errors(torch, kj, fns[1][1](*targs, **jkw), True)
        ok = ok and _finite(torch, kj)
        sig = max(sig, s_)
        print(f"[{family}-cases] {case['name']:14s} max|kernel - plain| = "
              f"{sig:.3e}, columns {', '.join(f'{c:.2e}' for c in cols)}")
        if not ok or not sig <= TOL_KERNEL or not max(cols) <= TOL_JAC_KERNEL:
            raise AssertionError(
                f"{family} case {case['name']}: kernel vs plain twin "
                f"{sig:.3e} / {max(cols):.3e} over {TOL_KERNEL} / "
                f"{TOL_JAC_KERNEL} or not finite")
        worst_sig, worst_col = max(worst_sig, sig), max(worst_col, max(cols))
    edges, shape, shapes, ragged, vs_twin = (
        (XGRE_EDGE_CASES, XGRE_EDGE_SHAPE, XGRE_SHAPES, XGRE_RAGGED_CASE,
         xgre_jac_vs_twin) if family == "xgre" else
        (XCOMP_EDGE_CASES, XCOMP_EDGE_SHAPE, XCOMP_SHAPES, XCOMP_RAGGED_CASE,
         xcomp_jac_vs_twin))
    wall = dict(edges=0.0, shapes=0.0)
    runs = [("edges", case, *shape) for case in edges]
    runs += [("shapes", ragged, n, ntr) for n, ntr in shapes]
    for part, case, n, ntr in runs:
        t0 = time.perf_counter()
        sig, cols = vs_twin(torch, case, n, ntr)
        print(f"[{family}-cases] {case['name']:16s} B={n:5d} N={ntr:3d} "
              f"max|kernel - plain| = {sig:.3e}, columns "
              f"{', '.join(f'{c:.2e}' for c in cols)}")
        worst_sig, worst_col = max(worst_sig, sig), max(worst_col, max(cols))
        wall[part] += time.perf_counter() - t0
    # the segmented primal kernel: its edges, then a repeated launch
    t0 = time.perf_counter()
    vs_primal = xgre_vs_twin if family == "xgre" else xcomp_vs_twin
    primal = 0.0
    for case, n, ntr in x_primal_runs(family):
        sig = vs_primal(torch, case, n, ntr)
        print(f"[{family}-cases] primal {case['name']:20s} B={n:5d} "
              f"N={ntr:3d} nstate={case['nstate']:3d} "
              f"max|kernel - plain| = {sig:.3e}")
        primal = max(primal, sig)
    same = x_primal_repeat(torch, family)
    print(f"[{family}-cases] primal: worst max|kernel - plain| over "
          f"{len(x_primal_runs(family))} edges {primal:.3e} (limit "
          f"{TOL_KERNEL}); a second launch on the same inputs "
          f"{'gives the same bits' if same else 'DIFFERS'}")
    if not same:
        raise AssertionError(f"{family} primal kernel: a repeated launch "
                             f"differs")
    worst_sig = max(worst_sig, primal)
    wall["primal"] = time.perf_counter() - t0
    _print_wall(f"phase_xcases {family} Jacobian and primal", wall)
    return worst_sig, worst_col


def _jac_vs_twin(torch, mod, fns, what, case, natoms, nstage, args, kw,
                 jac=True):
    """One launch of an EPG-X Jacobian kernel (`fns`: wrapper and twin of
    module `mod`; the primal kernel without `jac`) against its twin:
    (signal |delta|, per-column relative errors, none for the primal);
    raises past TOL_KERNEL / TOL_JAC_KERNEL, when not finite or not one
    launch."""
    counter = "JAC_LAUNCHES" if jac else "LAUNCHES"
    before = getattr(mod, counter)
    k = fns[0](*args, **kw)
    torch.cuda.synchronize()
    sig, cols = _x_errors(torch, k, fns[1](*args, **kw), jac)
    worst = max(cols, default=0.0)
    if (getattr(mod, counter) != before + 1 or not _finite(torch, k)
            or not sig <= TOL_KERNEL or not worst <= TOL_JAC_KERNEL):
        raise AssertionError(
            f"{what} {case['name']} (B={natoms}, N={nstage}): kernel vs "
            f"plain twin {sig:.3e} / {worst:.3e} over {TOL_KERNEL} / "
            f"{TOL_JAC_KERNEL}, not finite, or not one launch")
    return sig, cols


def xgre_jac_vs_twin(torch, case, natoms, ntr):
    """The xgre Jacobian kernel against its twin on one case of natoms
    atoms x ntr TRs (one launch; see _jac_vs_twin)."""
    from epgpy_torch.models import cuda_xgre

    jargs, jkw = make_xgre_jac_case(torch, case, natoms, ntr)
    return _jac_vs_twin(torch, cuda_xgre, (cuda_xgre.xgre_jacobian_cuda,
                                           cuda_xgre.xgre_jacobian_plain),
                        "xgre Jacobian", case, natoms, ntr,
                        xgre_tensors(torch, jargs, DEVICE, jac=True), jkw)


def xcomp_jac_vs_twin(torch, case, natoms, nstage):
    """The composite EPG-X Jacobian kernel against its twin on one case of
    natoms atoms x nstage stages (one launch; see _jac_vs_twin); the
    global-read case must take that mode."""
    from epgpy_torch.models import cuda_xcomposite as cx

    jargs, jkw = make_xcomp_jac_case(torch, case, natoms, nstage)
    C, nmat = len(jargs[11]), len(jargs[12][0])
    geo = cx.xcomp_jac_geometry(jkw["nstate"], C, case.get("V", 2) + 1, nmat)
    if geo["shared"] == ("ntaus" in case):
        raise AssertionError(f"composite EPG-X Jacobian {case['name']}: "
                             f"expected the other table mode, {geo}")
    return _jac_vs_twin(torch, cx, (cx.xcomposite_jacobian_cuda,
                                    cx.xcomposite_jacobian_plain),
                        "composite EPG-X Jacobian", case, natoms, nstage,
                        xcomp_tensors(torch, jargs, DEVICE, jac=True), jkw)


def xgre_vs_twin(torch, case, natoms, ntr):
    """The xgre primal kernel against its twin on one case of natoms atoms
    x ntr TRs: max |delta| over re and im (one launch; see
    _jac_vs_twin)."""
    from epgpy_torch.models import cuda_xgre

    args, kw = make_xgre_case(case, natoms, ntr)
    return _jac_vs_twin(torch, cuda_xgre, (cuda_xgre.xgre_dictionary_cuda,
                                           cuda_xgre.xgre_dictionary_plain),
                        "xgre", case, natoms, ntr,
                        xgre_tensors(torch, args, DEVICE), kw, jac=False)[0]


def xcomp_vs_twin(torch, case, natoms, nstage):
    """The composite EPG-X primal kernel against its twin on one case of
    natoms atoms x nstage stages: max |delta| over re and im (one launch;
    see _jac_vs_twin); a "global" case must take the device-memory table
    mode, every other the shared one."""
    from epgpy_torch.models import cuda_xcomposite as cx

    args, kw = make_xcomp_case(case, natoms, nstage)
    geo = cx.xcomp_geometry(kw["nstate"], len(args[11]), len(args[12]))
    if geo["shared"] == ("global" in case["name"]):
        raise AssertionError(f"composite EPG-X {case['name']}: expected the "
                             f"other table mode, {geo}")
    return _jac_vs_twin(torch, cx, (cx.xcomposite_cuda, cx.xcomposite_plain),
                        "composite EPG-X", case, natoms, nstage,
                        xcomp_tensors(torch, args, DEVICE), kw, jac=False)[0]


def x_primal_runs(family):
    """(case, atoms, TRs or stages) of a primal EPG-X kernel's edges
    (`family` "xgre" or "xcomp"): the row edges (X_ROW_EDGES) at one to
    four pools with every option (nstate 0 balanced or unshifted),
    XGRE_PRIMAL_CASES / XCOMP_PRIMAL_CASES, then the ragged shapes
    (XGRE_SHAPES / XCOMP_SHAPES: 1, 33 and 4,097 atoms, 1, 2 and 33 TRs or
    stages) of the case with every option at the main path's nstate."""
    if family == "xgre":
        base, n, extra, shapes = (_XGRE_ALL, XGRE_CASE_N, XGRE_PRIMAL_CASES,
                                  XGRE_SHAPES)
        flat, nstate = dict(balanced=True), XGRE_NSTATE
    else:
        base, n, extra, shapes = (_XCOMP_ALL, XCOMP_CASE_N,
                                  XCOMP_PRIMAL_CASES, XCOMP_SHAPES)
        flat, nstate = dict(shift="none"), XCOMP_NSTATE
    runs = [(dict(base, name=f"rows_c{C}_n{ns}", C=C, nstate=ns,
                  **(flat if ns == 0 else {})), X_PRIMAL_ATOMS, n)
            for C, nstates in X_ROW_EDGES.items() for ns in nstates]
    runs += [(c, X_PRIMAL_ATOMS, c.get("ntr", c.get("nstage", n)))
             for c in extra]
    return runs + [(dict(base, name=f"ragged_{b}x{t}", nstate=nstate), b, t)
                   for b, t in shapes]


def x_primal_repeat(torch, family, natoms=4097, n=100):
    """Two launches of a primal EPG-X kernel on the same inputs (its
    option case with every option, natoms atoms x n TRs or stages: four
    chunks, so that a chunk's table, staged echoes and flush follow each
    other in every block): whether they agree bit for bit."""
    from epgpy_torch.models import cuda_xcomposite as cx
    from epgpy_torch.models import cuda_xgre as cg

    if family == "xgre":
        args, kw = make_xgre_case(dict(_XGRE_ALL, name="repeat"), natoms, n)
        targs, fn = xgre_tensors(torch, args, DEVICE), cg.xgre_dictionary_cuda
    else:
        args, kw = make_xcomp_case(dict(_XCOMP_ALL, name="repeat"), natoms, n)
        targs, fn = xcomp_tensors(torch, args, DEVICE), cx.xcomposite_cuda
    first, again = fn(*targs, **kw), fn(*targs, **kw)
    torch.cuda.synchronize()
    return all(bool(torch.equal(a, b)) for a, b in zip(first, again))


def dess_jac_vs_twin(torch, case, natoms, npulse):
    """The DESS Jacobian kernel against its twin on one case of natoms
    atoms x npulse pulses (one launch): (signal |delta|, per-column
    relative errors); raises past TOL_KERNEL / TOL_JAC_KERNEL or when not
    finite."""
    from epgpy_torch.models import cuda_dess

    args, kw = _tensors(torch, *make_dess_case(case, natoms, npulse),
                        DEVICE)
    before = cuda_dess.JAC_LAUNCHES
    k = cuda_dess.dess_jacobian_echoes(*args, **kw)
    torch.cuda.synchronize()
    sig, cols = _pair_errors(torch, k, cuda_dess.dess_jacobian_echoes_plain(
        *args, **kw), True)
    if (cuda_dess.JAC_LAUNCHES != before + 1 or not _finite(torch, k)
            or not sig <= TOL_KERNEL or not max(cols) <= TOL_JAC_KERNEL):
        raise AssertionError(
            f"DESS Jacobian {case['name']} (B={natoms}, P={npulse}): kernel "
            f"vs plain twin {sig:.3e} / {max(cols):.3e} over {TOL_KERNEL} / "
            f"{TOL_JAC_KERNEL}, not finite, or not one launch")
    return sig, cols


def mt_saturation():
    """The bench's bound-pool saturation rate (1/ms): a 5 ms, 10 uT pulse
    2 kHz off resonance on a super-Lorentzian line of T2 12 us (Graham
    1997; bench.py:794-795)."""
    from epgpy_torch.utils import magnettransfer as mt

    return mt.saturation_rate(5.0, 10.0, mt.absorption_rate(
        12e-3, "super-lorentzian", 2.0))


def xgre_bench_sequence(epg, T2f, ntr=XGRE_NTR):
    """bench.py:799-811's two-pool MT-GRE train over a free-pool T2 sweep:
    [R(sat), T([10, 0]), ADC, X(10), S(1)] x ntr."""
    T2 = np.stack([np.asarray(T2f, float), np.full(len(T2f), 0.012)])
    khi = epg.exchange_matrix(XGRE_K, densities=list(XGRE_DENS))
    X = epg.X(XGRE_TAU, khi, axis=0, T1=np.asarray([1000.0, 1000.0]), T2=T2)
    sat = epg.R(0, rL=np.asarray([0.0, mt_saturation() * XGRE_SATDUR]),
                r0=None)
    seq = []
    for _ in range(ntr):
        seq += [sat, epg.T(np.asarray([10.0, 0.0]), 0), epg.ADC, X,
                epg.S(1)]
    return seq


def families_draws(natoms):
    """bench.py:1128-1132's draws (seed 12): 200 flips, T1 and T2 of
    `natoms` atoms."""
    rng = np.random.default_rng(12)
    FA = rng.uniform(12.0, 45.0, 200)
    T1 = rng.uniform(300.0, 2500.0, natoms)
    T2 = np.minimum(rng.uniform(20.0, 300.0, natoms), 0.8 * T1)
    return FA, T1, T2


def xbssfp_bench_sequence(epg, T2, FA):
    """bench.py:1306-1318's balanced two-pool train: [T([FA_i, 0], 180 (i %
    2)), X(3), ADC, X(7)] per TR, bound-pool T2 20 us."""
    khi = epg.exchange_matrix(0.004, ncomp=2, densities=[0.85, 0.15])
    T2x = np.stack([np.asarray(T2, float), np.full(len(T2), 0.02)])
    T1x = np.array([1000.0, 1100.0])
    X1 = epg.X(3.0, khi, axis=0, T1=T1x, T2=T2x)
    X2 = epg.X(7.0, khi, axis=0, T1=T1x, T2=T2x)
    seq = []
    for i in range(len(FA)):
        seq += [epg.T(np.array([float(FA[i]), 0.0]), 180.0 * (i % 2)), X1,
                epg.ADC, X2]
    return seq


def xcomp_bench_sequence(epg, T2f, FA, nseg=XCOMP_NSEG, nread=25):
    """bench.py:1266-1279's segmented MT-prepared train: per segment a
    saturation R and X(150), nread readouts [T([FA_i / 3, 0]), X(3), ADC,
    X(7), S(1)], X(150)."""
    khi = epg.exchange_matrix(0.005, ncomp=2, densities=[0.85, 0.15])
    T2p = np.stack([np.asarray(T2f, float), np.full(len(T2f), 0.012)])
    T1p = np.array([1000.0, 1100.0])
    Xte = epg.X(3.0, khi, axis=0, T1=T1p, T2=T2p)
    Xtr = epg.X(7.0, khi, axis=0, T1=T1p, T2=T2p)
    Xrec = epg.X(150.0, khi, axis=0, T1=T1p, T2=T2p)
    seq = []
    for _ in range(nseg):
        seq += [epg.R(0, rL=np.asarray([0.0, 0.3]), r0=None), Xrec]
        for i in range(nread):
            seq += [epg.T(np.asarray([float(FA[i] / 3), 0.0]), 0.0), Xte,
                    epg.ADC, Xtr, epg.S(1)]
        seq += [Xrec]
    return seq


def xgre_parity_train(epg):
    """tests/golden/xgre_parity.npz's train (tools/make_golden.py:1079)."""
    T2 = np.stack([np.linspace(40.0, 120.0, 4), np.full(4, 0.012)])
    X = epg.X(10.0, epg.exchange_matrix(0.005, densities=[0.8, 0.2]),
              axis=0, T1=np.asarray([1000.0, 1000.0]), T2=T2)
    sat = epg.R(0, rL=np.asarray([0.0, 2.5]), r0=None)
    seq = []
    for _ in range(20):
        seq += [sat, epg.T(np.asarray([10.0, 0.0]), 0), epg.ADC, X,
                epg.S(1)]
    return seq


def xbssfp_golden_train(epg, g):
    """tests/golden/xbssfp.npz's balanced train
    (tests/test_xgre_dispatch.py:459-485)."""
    khi = epg.exchange_matrix(0.004, axis=0, ncomp=2, densities=[0.85, 0.15])
    kw = dict(T1=[900.0, 400.0], T2=[70.0, 0.02], g=[0.003, 0.0])
    X1, X2 = epg.X(2.3, khi, axis=0, **kw), epg.X(5.0 - 2.3, khi, axis=0,
                                                   **kw)
    seq = []
    for i in range(len(g["FAs"])):
        seq += [epg.R(0, rL=np.asarray([0.0, 0.3])),
                epg.T(np.array([g["FAs"][i], 0.0]), float(g["phases"][i])),
                X1, epg.ADC, X2]
    return seq


def xcomp_golden_train(epg):
    """tests/golden/xcomp_gre.npz's train (tools/make_golden.py:1103)."""
    khi = epg.exchange_matrix(0.005, ncomp=2, densities=[0.85, 0.15])
    T2 = np.stack([np.linspace(50.0, 110.0, 4), np.full(4, 0.012)])
    T1 = np.array([1000.0, 1100.0])
    Xte, Xtr = (epg.X(3.0, khi, axis=0, T1=T1, T2=T2),
                epg.X(7.0, khi, axis=0, T1=T1, T2=T2))
    Xrec = epg.X(150.0, khi, axis=0, T1=T1, T2=T2)
    sat = epg.R(0, rL=np.asarray([0.0, 0.3]), r0=None)
    seq = []
    for seg in range(3):
        seq += [sat, Xrec]
        for i in range(6):
            seq += [epg.T(np.asarray([8.0 + i + seg, 0.0]), 0.0), Xte,
                    epg.ADC, Xtr, epg.S(1)]
        seq += [Xrec]
    return seq


def exchange_gre_train(epg):
    """tests/golden/exchange_gre.npz's train (tests/test_shiftnd.py:
    429-444): a scalar-rate X on the last axis (run with a custom initial
    state, so the general path takes it)."""
    X = epg.X(10.0, 0.01, axis=-1, T1=[1000.0, 500.0], T2=[80.0, 20.0],
              g=[0.0, 0.02])
    seq = []
    for _ in range(40):
        seq += [epg.T(15.0, 0), epg.ADC, X, epg.S(1)]
    return seq


def _x_goldens(torch, epg):
    """The EPG-X goldens on the card: xgre_parity, xbssfp and xcomp_gre
    through simulate() and the kernels (float32, relative to the golden's
    largest magnitude), exchange_gre through the general path in float64
    on the card, and the MT rates of mt_rates.npz (host numpy); returns
    {name: error}."""
    from epgpy_torch import config
    from epgpy_torch.utils import magnettransfer as mt

    err = {}
    for name, seq, kw in (
            ("xgre_parity", xgre_parity_train(epg),
             dict(max_nstate=10, density=[0.8, 0.2])),
            ("xbssfp", xbssfp_golden_train(epg, _golden("xbssfp")),
             dict(density=[0.85, 0.15])),
            ("xcomp_gre", xcomp_golden_train(epg),
             dict(max_nstate=8, density=[0.85, 0.15]))):
        g = _golden(name)["signal"]
        out = epg.simulate(seq, asarray=False, **kw)
        err[name] = float(np.abs(out.cpu().numpy() - g).max()
                          / np.abs(g).max())
        twin = _xcomp_twin_err if name == "xcomp_gre" else _xgre_twin_err
        err[name + " vs twin"] = twin(torch, seq, tuple(out.shape[1:]),
                                      kw["density"], kw.get("max_nstate", 0),
                                      out)
    old = config.precision()
    config.set_precision("float64")
    try:
        sig = epg.simulate(exchange_gre_train(epg), max_nstate=12,
                           init=np.array([0, 0, 0.5]) * np.ones((2, 1, 1)),
                           density=[0.5, 0.5])
    finally:
        config.set_precision(old)
    err["exchange_gre"] = float(np.abs(sig - _golden("exchange_gre")[
        "signal"]).max())
    g = _golden("mt_rates")
    off = g["offres"]
    rel = [np.abs(mt.absorption_rate(12e-3, s, off) / g[s] - 1).max()
           for s in ("gaussian", "lorentzian")]
    rel.append(abs(mt.saturation_rate(5.0, 10.0, mt.absorption_rate(
        12e-3, "gaussian", 2.0)) / g["satrate"] - 1))
    err["mt_rates"] = float(max(rel))
    sl = float(np.abs(mt.absorption_rate(12e-3, "super-lorentzian", off[2:])
                      / g["super_lorentzian"] - 1).max())
    print(f"[x-goldens] on the card: " + ", ".join(
        f"{k} {v:.3e}" for k, v in err.items())
        + f", super-Lorentzian {sl:.3e} (limits {TOL_X_GOLDEN} relative, "
        f"the kernels vs their twins {TOL_KERNEL}, exchange_gre "
        f"{TOL_XCHG_GOLDEN} in float64, mt_rates 1e-10 and 1e-6 relative)")
    if (max(err[k] for k in ("xgre_parity", "xbssfp", "xcomp_gre"))
            > TOL_X_GOLDEN or max(v for k, v in err.items()
                                  if k.endswith("twin")) > TOL_KERNEL
            or err["exchange_gre"] > TOL_XCHG_GOLDEN
            or err["mt_rates"] > 1e-10 or sl > 1e-6):
        raise AssertionError(f"EPG-X goldens out of bounds: {err}")
    return err


def _x_probe(torch, epg, build, atoms, kw, out):
    """max |float32 path - float64 general path| over the probe atoms:
    `build(idx)` builds the train over those atoms."""
    from epgpy_torch import config

    with cpu_float64(config):
        ref = epg.simulate(build(atoms), fisp_kernel=False, **kw)
    return float(np.abs(out[..., atoms].cpu().numpy() - ref).max())


def _xgre_args(fisp_dispatch, params, nstate):
    """The xgre kernels' positional tensors and keywords of a match."""
    d = fisp_dispatch._xgre_device_params(params)
    balanced = bool(params["balanced"])
    args = tuple(d[k] for k in ("alpha", "phi", "satf_re", "satf_im",
                                "satz_re", "satz_im", "dens", "stageA",
                                "stageB", "B1"))
    return args, dict(nstate=0 if balanced else max(int(nstate), 1),
                      shift=not balanced)


def _twin_err(torch, out, re, im):
    """max |simulate() output - plain twin| over re and im, the twin's
    (N, C, B) echoes laid out as the engine's output."""
    return max(float((out.real - re.reshape(out.shape)).abs().max()),
               float((out.imag - im.reshape(out.shape)).abs().max()))


def _xgre_twin_err(torch, seq, shape, dens, nstate, out):
    """max |out - xgre_dictionary_plain| on the card, all atoms: `out` is
    what simulate(density=) gave for `seq` (the xgre kernel's echoes), the
    twin runs on the same matched tensors."""
    from epgpy_torch import fisp_dispatch
    from epgpy_torch.models import cuda_xgre

    args, kw = _xgre_args(fisp_dispatch,
                          fisp_dispatch.match_xgre(seq, shape, dens), nstate)
    return _twin_err(torch, out, *cuda_xgre.xgre_dictionary_plain(*args,
                                                                  **kw))


def _xcomp_twin_err(torch, seq, shape, dens, nstate, out):
    """max |out - xcomposite_plain| on the card, all atoms, as
    _xgre_twin_err for the composite EPG-X kernel."""
    from epgpy_torch import fisp_dispatch
    from epgpy_torch.models import cuda_xcomposite

    params = fisp_dispatch.match_xcomposite(seq, shape, dens)
    args, d, kw = fisp_dispatch._xcomp_call(params, nstate)
    return _twin_err(torch, out, *cuda_xcomposite.xcomposite_plain(
        *args, params["taus"], params["khi"], d["T1"], d["T2"], d["g"],
        d["B1"], d["b1u"], **kw))


def _xgre_cut(torch, args):
    """cut(n) of kernel_entry for the xgre primal's arguments: the stages'
    (C, B) atoms and B1 cut to the first n atoms, on the CPU."""
    def cut(n):
        out = [a.cpu() for a in args[:7]]
        out += [(khi, T1[:, :n].cpu(), T2[:, :n].cpu(), g[:, :n].cpu(), tau)
                for khi, T1, T2, g, tau in args[7:9]]
        return tuple(out) + (None if args[9] is None else args[9][:n].cpu(),)
    return cut


def phase_xgre_path(torch, epg):
    """(a) the bench's spoiled MT-GRE train over XGRE_ATOMS atoms through
    simulate(density=) (first call and memoized) and through the xgre
    kernel on the matched parameters, 8 atoms against the float64 general
    path, and the EPG-X goldens on the card; returns the run's facts."""
    from epgpy_torch import fisp_dispatch
    from epgpy_torch.models import cuda_xcomposite, cuda_xgre

    T2f = np.linspace(40.0, 120.0, XGRE_ATOMS)
    seq = xgre_bench_sequence(epg, T2f)
    kw = dict(max_nstate=XGRE_NSTATE, density=list(XGRE_DENS),
              asarray=False)
    _reset_counts(cuda_xgre, cuda_xcomposite)
    out, first_s = _first_call(torch, lambda: epg.simulate(seq, **kw))
    params = fisp_dispatch.match_xgre(seq, (2, XGRE_ATOMS), list(XGRE_DENS))
    direct = fisp_dispatch.run_xgre_kernel(params, XGRE_NSTATE)
    same = bool(torch.equal(out, direct))
    del direct
    gerr = _x_goldens(torch, epg)
    torch.cuda.synchronize()
    _expect("xgre", (dict(fisp_dispatch.DISPATCH_COUNTS), cuda_xgre.LAUNCHES,
                     cuda_xcomposite.LAUNCHES),
            ({"xgre": 3, "xcomp": 1}, 4, 1))
    probe = np.linspace(0, XGRE_ATOMS - 1, 8).astype(int)
    err = _x_probe(torch, epg, lambda idx: xgre_bench_sequence(epg, T2f[idx]),
                   probe, dict(max_nstate=XGRE_NSTATE,
                               density=list(XGRE_DENS)), out)
    shape = (XGRE_NTR, 2, XGRE_ATOMS)
    print(f"[xgre] simulate(density=): the bench's MT-GRE, {XGRE_NTR} TRs x "
          f"{XGRE_ATOMS} atoms -> {tuple(out.shape)} {out.dtype} "
          f"({out.numel() * 8 / 1e6:.0f} MB); run_xgre_kernel on the match "
          f"{'==' if same else '!='} simulate(); 8 atoms vs the f64 general "
          f"path {err:.3e} (limit {TOL_PROBE})")
    if (tuple(out.shape) != shape or out.dtype != torch.complex64
            or not same or not _finite(torch, torch.view_as_real(out))
            or not err <= TOL_PROBE):
        raise AssertionError("xgre path: shape, finiteness, direct call or "
                             "f64 error out of bounds")
    del out
    memo_s = _host_s(torch, lambda: epg.simulate(seq, **kw), reps=3)
    print(f"[xgre] simulate() first {first_s:.4f} s, memoized "
          f"{memo_s * 1e3:.3f} ms")
    args, ckw = _xgre_args(fisp_dispatch, params, XGRE_NSTATE)
    return dict(args=args, kw=ckw, launches=4, comp_launches=1,
                first_s=first_s, memo_s=memo_s, gerr=gerr, err=err)


def phase_xbssfp_path(torch, epg):
    """(b) the bench's balanced two-pool train over XBSSFP_ATOMS atoms
    through simulate(density=) (nstate 0: the xgre kernel without the
    shift), 8 atoms against the float64 general path (to the bSSFP
    family's limit TOL_BSSFP_GOLDEN: a balanced train never spoils, so
    float32 rounding accumulates over its 200 TRs -- 1.6e-6 for the twin
    on the CPU); returns the run's facts."""
    from epgpy_torch import fisp_dispatch
    from epgpy_torch.models import cuda_xgre

    FA, _, T2 = families_draws(XBSSFP_ATOMS)
    seq = xbssfp_bench_sequence(epg, T2, FA)
    kw = dict(density=[0.85, 0.15], asarray=False)
    _reset_counts(cuda_xgre)
    out, first_s = _first_call(torch, lambda: epg.simulate(seq, **kw))
    _expect("xbssfp", (dict(fisp_dispatch.DISPATCH_COUNTS),
                       cuda_xgre.LAUNCHES), ({"xgre": 1}, 1))
    twin = _xgre_twin_err(torch, seq, (2, XBSSFP_ATOMS), [0.85, 0.15], 0,
                          out)
    probe = np.linspace(0, XBSSFP_ATOMS - 1, 8).astype(int)
    err = _x_probe(torch, epg,
                   lambda idx: xbssfp_bench_sequence(epg, T2[idx], FA),
                   probe, dict(density=[0.85, 0.15]), out)
    print(f"[xbssfp] simulate(density=): balanced two-pool, {len(FA)} TRs "
          f"x {XBSSFP_ATOMS} atoms -> {tuple(out.shape)}; all atoms vs "
          f"the plain twin on the card {twin:.3e} (limit {TOL_KERNEL}); 8 "
          f"atoms vs the f64 general path {err:.3e} (limit "
          f"{TOL_BSSFP_GOLDEN})")
    if (tuple(out.shape) != (len(FA), 2, XBSSFP_ATOMS)
            or not _finite(torch, torch.view_as_real(out))
            or not twin <= TOL_KERNEL or not err <= TOL_BSSFP_GOLDEN):
        raise AssertionError("balanced xgre path out of bounds")
    del out
    memo_s = _host_s(torch, lambda: epg.simulate(seq, **kw), reps=3)
    print(f"[xbssfp] simulate() first {first_s:.4f} s, memoized "
          f"{memo_s * 1e3:.3f} ms")
    return dict(launches=1, first_s=first_s, memo_s=memo_s, err=err,
                twin=twin)


def mtp_train(epg, k_exch, T2f, sat_rate):
    """examples/mt_prep_gre.py's segmented MT-prepared GRE (MTP_NSEG
    segments of MTP_NREAD readouts; the saturation power 0.5-1.5x per
    segment; khi = 0 for k_exch = 0); returns (sequence, densities)."""
    dens = np.asarray([0.88, 0.12]) / np.sum([0.88, 0.12])
    khi = (np.zeros((2, 2)) if k_exch == 0.0
           else epg.exchange_matrix(k_exch, ncomp=2, densities=dens))
    T2 = np.stack([np.asarray(T2f, float), np.full(len(T2f), 0.012)])
    T1 = np.asarray([1000.0, 1000.0])
    Xte = epg.X(MTP_TE, khi, axis=0, T1=T1, T2=T2)
    Xtr = epg.X(MTP_TRG - MTP_TE, khi, axis=0, T1=T1, T2=T2)
    Xrec = epg.X(MTP_TREC, khi, axis=0, T1=T1, T2=T2)
    seq = []
    for s in range(MTP_NSEG):
        if sat_rate > 0:
            scale = 0.5 + (s % 3) * 0.5
            seq.append(epg.R(0, rL=np.asarray([0.0, sat_rate * scale]),
                             r0=None))
        seq.append(Xrec)
        for _ in range(MTP_NREAD):
            seq += [epg.T(np.asarray([9.0, 0.0]), 0.0), Xte, epg.ADC, Xtr,
                    epg.S(1)]
        seq += [Xrec]
    return seq, list(dens)


def phase_xcomp_path(torch, epg):
    """(c) the bench's segmented MT-prepared train over 2 x XCOMP_NAT
    atoms through simulate(density=) and through the composite EPG-X
    kernel on the matched parameters, 8 atoms against the float64 general
    path, then examples/mt_prep_gre.py's MTR checks at the same width;
    returns the run's facts."""
    from epgpy_torch import fisp_dispatch
    from epgpy_torch.models import cuda_xcomposite

    FA, _, T2 = families_draws(XCOMP_NAT)
    T2f = np.concatenate([T2, T2])
    natx = len(T2f)
    seq = xcomp_bench_sequence(epg, T2f, FA)
    kw = dict(max_nstate=XCOMP_NSTATE, density=[0.85, 0.15], asarray=False)
    _reset_counts(cuda_xcomposite)
    out, first_s = _first_call(torch, lambda: epg.simulate(seq, **kw))
    params = fisp_dispatch.match_xcomposite(seq, (2, natx), [0.85, 0.15])
    direct = fisp_dispatch.run_xcomposite_kernel(params, XCOMP_NSTATE)
    same = bool(torch.equal(out, direct))
    del direct
    probe = np.linspace(0, natx - 1, 8).astype(int)
    err = _x_probe(torch, epg,
                   lambda idx: xcomp_bench_sequence(epg, T2f[idx], FA),
                   probe, dict(max_nstate=XCOMP_NSTATE,
                               density=[0.85, 0.15]), out)
    nadc = XCOMP_NSEG * 25
    print(f"[xcomp] simulate(density=): the bench's MT-prepared train, "
          f"{len(params['alpha'])} stages x {natx} atoms -> "
          f"{tuple(out.shape)}; run_xcomposite_kernel on the match "
          f"{'==' if same else '!='} simulate(); 8 atoms vs the f64 general "
          f"path {err:.3e} (limit {TOL_PROBE})")
    if (tuple(out.shape) != (nadc, 2, natx) or not same
            or not _finite(torch, torch.view_as_real(out))
            or not err <= TOL_PROBE):
        raise AssertionError("xcomp path out of bounds")
    del out

    # examples/mt_prep_gre.py's MTR checks, at natx voxels, each train's
    # kernel echoes held against the plain twin on all voxels
    T2v = np.random.default_rng(3).uniform(50.0, 120.0, natx)
    twins = []

    def mean_signal(k, rate):
        s, dens = mtp_train(epg, k, T2v, rate)
        sig = epg.simulate(s, max_nstate=XCOMP_NSTATE, density=dens,
                           asarray=False)
        twins.append(_xcomp_twin_err(torch, s, (2, natx), dens,
                                     XCOMP_NSTATE, sig))
        return sig[:, 0, :].abs().mean(dim=0).double().cpu().numpy()

    s_off = mean_signal(0.005, 0.0)
    mtr = [float(((s_off - mean_signal(0.005, r)) / s_off).mean())
           for r in (0.15, 0.3, 0.6)]
    mtr0 = float(np.abs((mean_signal(0.0, 0.0) - mean_signal(0.0, 0.6))
                        / mean_signal(0.0, 0.0)).max())
    print(f"[xcomp] examples/mt_prep_gre.py at {natx} voxels: MTR "
          f"{', '.join(f'{m:.4f}' for m in mtr)} at 0.15/0.3/0.6 per ms "
          f"(asserts: > 0.01, increasing); khi = 0 control max |MTR| "
          f"{mtr0:.2e} (assert < 1e-5); the {len(twins)} trains vs the "
          f"plain twin on the card, all voxels: max {max(twins):.3e} (limit "
          f"{TOL_KERNEL})")
    if not (mtr[0] > 0.01 and mtr[0] < mtr[1] < mtr[2]) or not mtr0 < 1e-5:
        raise AssertionError("mt_prep_gre MTR asserts failed")
    if not max(twins) <= TOL_KERNEL:
        raise AssertionError(f"xcomposite kernel vs plain twin on the MTR "
                             f"trains: {twins}")
    # the train and the 7 MTR trains through simulate(), the direct call
    _expect("xcomp", (dict(fisp_dispatch.DISPATCH_COUNTS),
                      cuda_xcomposite.LAUNCHES), ({"xcomp": 8}, 9))
    memo_s = _host_s(torch, lambda: epg.simulate(seq, **kw), reps=3)
    print(f"[xcomp] simulate() first {first_s:.4f} s, memoized "
          f"{memo_s * 1e3:.3f} ms")
    args, d, ckw = fisp_dispatch._xcomp_call(params, XCOMP_NSTATE)
    args = args + (params["taus"], params["khi"], d["T1"], d["T2"], d["g"],
                   d["B1"], d["b1u"])
    return dict(args=args, kw=ckw, launches=9, first_s=first_s,
                memo_s=memo_s, err=err, mtr=mtr, mtr0=mtr0, natoms=natx)


def _xcomp_cut(torch, args):
    """cut(n) for the composite EPG-X primal's arguments: T1, T2, g and B1
    cut to the first n atoms, on the CPU."""
    def cut(n):
        out = [a.cpu() if isinstance(a, torch.Tensor) else a
               for a in args[:14]]
        out += [a[:, :n].cpu() for a in args[14:17]]
        return tuple(out) + (None if args[17] is None else args[17][:n].cpu(),
                             args[18].cpu())
    return cut


def qmt_problem(torch, epg):
    """examples/mt_qmt_fit_refine.py's acquisition on the card: the (N, C)
    train tensors and the differentiable per-voxel stage map (f, T2f) ->
    (mr, mi, ml, dens) of its X(TR) stage."""
    from epgpy_torch.models import cuda_xgre

    FAS = 8.0 + 52.0 * np.abs(np.sin(np.arange(QMT_NTR) * 0.18))
    W = mt_saturation()
    dev = torch.device(DEVICE)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    Z = np.zeros((QMT_NTR, 2))
    train = (t(np.stack([FAS, np.zeros(QMT_NTR)], 1)), t(Z),
             t(np.ones((QMT_NTR, 2))), t(Z),
             t(np.stack([np.ones(QMT_NTR),
                         np.full(QMT_NTR, np.exp(-W * 10.0))], 1)), t(Z))

    def stage(f, T2f):
        d0, d1 = 1.0 - f, f
        khi = torch.stack([torch.stack([0.005 / d0, -0.005 / d1]),
                           torch.stack([-0.005 / d0, 0.005 / d1])])
        T2 = torch.stack([T2f, torch.full_like(T2f, 0.012)])
        T1 = torch.full_like(T2, 1000.0)
        return cuda_xgre.exchange_stage_mats(khi, T1, T2, None, 12.0) \
            + (torch.stack([d0, d1]),)

    return train, stage


def qmt_jac_args(torch, train, stage, f, T2f):
    """The xgre Jacobian's arguments for per-voxel (f, T2f): the identity
    stage A, the X(TR) stage B and its (df, dT2f) tangents by
    torch.func.jvp of the stage map."""
    one, zero = torch.ones_like(f), torch.zeros_like(f)
    (mr, mi, ml, dens), tf = torch.func.jvp(stage, (f, T2f), (one, zero))
    _, tt = torch.func.jvp(stage, (f, T2f), (zero, one))
    B = f.shape[0]
    eye = torch.eye(2, dtype=f.dtype, device=f.device).expand(B, 2, 2)
    matsA = (eye.contiguous(), torch.zeros_like(eye), eye.contiguous())
    dA = tuple(torch.zeros((2, B, 2, 2), dtype=f.dtype, device=f.device)
               for _ in range(3))
    dB = tuple(torch.stack([a, b]) for a, b in zip(tf[:3], tt[:3]))
    return train + (dens, matsA, (mr, mi, ml), dA, dB,
                    torch.stack([tf[3], tt[3]]))


def _qmt_mag(out):
    """|S| of the free pool (N, B) and d|S|/d(f, T2f) (N, B, 2) of an xgre
    Jacobian output."""
    (re, im), (jre, jim) = out
    sr, si = re[:, 0], im[:, 0]
    mag = (sr * sr + si * si).sqrt() + 1e-30
    jmag = (sr[:, None] * jre[:, :, 0] + si[:, None] * jim[:, :, 0]) \
        / mag[:, None]
    return mag, jmag.movedim(1, -1)


def _jac_cut(torch, args, axes, cpu=True):
    """cut(n) for a Jacobian entry point: the arguments at the positions
    of `axes` cut to their first n atoms along the axis it gives (tuples
    and lists walked), every tensor on the CPU (or where it is)."""
    def walk(a, n, ax):
        if isinstance(a, torch.Tensor):
            a = a if ax is None else a.narrow(ax, 0, n)
            return a.cpu() if cpu else a
        if isinstance(a, (tuple, list)):
            return type(a)(walk(x, n, ax) for x in a)
        return a

    def cut(n):
        return tuple(walk(a, n, axes.get(i)) for i, a in enumerate(args))
    return cut


#: atom axes of the xgre Jacobian's arguments: dens (C, B), matsA/B
#: (B, C, C), their tangents (V, B, C, C), ddens (V, C, B)
XGRE_JAC_AXES = {6: -1, 7: 0, 8: 0, 9: 1, 10: 1, 11: -1}
#: and of the composite EPG-X Jacobian's (shared dens): the tables (nmat,
#: B, C, C), their tangents, ddens (C, B)
XCOMP_JAC_AXES = {12: 1, 13: 1, 14: -1}


def phase_qmt_fit(torch, epg):
    """(d) examples/mt_qmt_fit_refine.py at QMT_NVOX voxels: noisy
    observations at random (f, T2f), a match against the example's 12 x 16
    (f, T2f) dictionary (one Jacobian kernel call), QMT_ITERS damped
    Gauss-Newton iterations (one Jacobian kernel call each), the example's
    asserts; the first iteration's Jacobian against the twin on its first
    8,192 voxels; returns the run's facts."""
    from epgpy_torch import config
    from epgpy_torch.models import cuda_xgre

    _reset_counts(cuda_xgre)
    train, stage = qmt_problem(torch, epg)
    dev = torch.device(DEVICE)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    def forward(f, T2f):
        return _qmt_mag(cuda_xgre.xgre_jacobian_echoes(
            *qmt_jac_args(torch, train, stage, t(f), t(T2f)),
            nstate=QMT_NSTATE))

    rng = np.random.default_rng(17)
    f_true = rng.uniform(0.08, 0.28, QMT_NVOX)
    t2_true = rng.uniform(45.0, 115.0, QMT_NVOX)
    t0 = time.perf_counter()
    mag_true, _ = forward(f_true, t2_true)
    obs = mag_true.double() + torch.as_tensor(
        rng.normal(0, 2e-4, (QMT_NTR, QMT_NVOX)), device=dev)
    bounds = np.array([[0.03, 0.40], [30.0, 140.0]])
    grid = np.stack(np.meshgrid(np.linspace(*bounds[0], 12),
                                np.linspace(*bounds[1], 16), indexing="ij"),
                    -1).reshape(-1, 2)
    D, _ = forward(grid[:, 0], grid[:, 1])
    D = D.double()
    with config.full_precision():
        hit = ((obs / obs.norm(dim=0)).T
               @ (D / D.norm(dim=0))).argmax(dim=1).cpu().numpy()
    theta = grid[hit].T.copy()
    match_s = time.perf_counter() - t0
    rms = lambda th: (float(np.sqrt(np.mean((th[0] - f_true) ** 2))),  # noqa
                      float(np.sqrt(np.mean((th[1] - t2_true) ** 2))))
    err0 = rms(theta)
    lam, twin = 1e-3, None
    lo, hi = (torch.as_tensor(bounds[:, i], device=dev)[:, None]
              for i in (0, 1))
    th = torch.as_tensor(theta, device=dev)
    t0 = time.perf_counter()
    for it in range(QMT_ITERS):
        if it == 0:
            args = qmt_jac_args(torch, train, stage, th[0].float(),
                                th[1].float())
            k = cuda_xgre.xgre_jacobian_echoes(*args, nstate=QMT_NSTATE)
            cut = _jac_cut(torch, args, XGRE_JAC_AXES, cpu=False)
            twin = _x_errors(torch, tuple(
                (a[..., :QMT_TWIN], b[..., :QMT_TWIN]) for a, b in k),
                cuda_xgre.xgre_jacobian_plain(*cut(QMT_TWIN),
                                              nstate=QMT_NSTATE), True)
            mag, J = _qmt_mag(k)
            del k, args
        else:
            mag, J = forward(th[0].cpu().numpy(), th[1].cpu().numpy())
        r, J = obs - mag.double(), J.double()
        A = torch.einsum("nbi,nbj->bij", J, J)
        diag = A.diagonal(dim1=1, dim2=2).clamp(min=1e-12)
        A = A + torch.diag_embed(lam * diag)
        g = torch.einsum("nbi,nb->bi", J, r)
        th = th + torch.linalg.solve(A, g[..., None])[..., 0].T
        th = torch.minimum(torch.maximum(th, lo), hi)
    torch.cuda.synchronize()
    gn_s = time.perf_counter() - t0
    err1 = rms(th.cpu().numpy())
    print(f"[qmt] examples/mt_qmt_fit_refine.py at {QMT_NVOX} voxels: match "
          f"RMS f {err0[0]:.4f}, T2f {err0[1]:.3f} ms ({match_s:.3f} s); "
          f"{QMT_ITERS} Gauss-Newton iterations ({gn_s:.3f} s) -> f "
          f"{err1[0]:.5f}, T2f {err1[1]:.4f} ms (asserts: below the match, "
          f"f < 0.01, T2f < 2 ms); first Jacobian vs the twin on "
          f"{QMT_TWIN} voxels: signal {twin[0]:.3e}, columns "
          f"{', '.join(f'{c:.3e}' for c in twin[1])}")
    if not (err1[0] < err0[0] and err1[1] < err0[1] and err1[0] < 0.01
            and err1[1] < 2.0):
        raise AssertionError(f"qMT fit asserts failed: {err0} -> {err1}")
    if not twin[0] <= TOL_KERNEL or not max(twin[1]) <= TOL_JAC_KERNEL:
        raise AssertionError("the xgre Jacobian kernel disagrees with its "
                             "twin on the qMT fit")
    _expect("qmt", (cuda_xgre.JAC_LAUNCHES,), (2 + QMT_ITERS,))
    f0 = torch.as_tensor(f_true, dtype=torch.float32, device=dev)
    t20 = torch.as_tensor(t2_true, dtype=torch.float32, device=dev)
    return dict(args=qmt_jac_args(torch, train, stage, f0, t20),
                kw=dict(nstate=QMT_NSTATE), launches=2 + QMT_ITERS,
                err0=err0, err1=err1, gn_s=gn_s, match_s=match_s, twin=twin)


def phase_kfit(torch, epg):
    """(e) examples/mt_prep_gre.py's exchange-rate fit at KFIT_NVOX voxels:
    the composite EPG-X Jacobian kernel at the per-voxel truth plus noise
    as the data, then 8 Gauss-Newton iterations of k through
    parallel.gauss_newton_refine (one kernel call each), k RMSE < 2e-4;
    the truth's Jacobian against the twin on its first 8,192 voxels;
    returns the run's facts."""
    from epgpy_torch import fisp_dispatch
    from epgpy_torch.models import cuda_xcomposite
    from epgpy_torch.parallel import gauss_newton_refine

    _reset_counts(cuda_xcomposite)
    rng = np.random.default_rng(3)
    n = KFIT_NVOX
    T2f = rng.uniform(50.0, 120.0, n)
    k_true = rng.uniform(0.003, 0.009, n)
    seq, dens = mtp_train(epg, 0.005, T2f, 0.3)
    params = fisp_dispatch.match_xcomposite(seq, (2, n), dens)
    args, _, kw = fisp_dispatch._xcomp_call(params, XCOMP_NSTATE)
    dev = torch.device(DEVICE)
    kron = torch.as_tensor(np.asarray([[1.0, -1.0], [-1.0, 1.0]])
                           / np.asarray(dens), dtype=torch.float32,
                           device=dev)
    T1m = torch.full((2, n), 1000.0, device=dev)
    T2 = torch.stack([torch.as_tensor(T2f, dtype=torch.float32, device=dev),
                      torch.full((n,), 0.012, device=dev)])
    zeros = torch.zeros((2, n), device=dev)

    def tables(k):
        return cuda_xcomposite.xcomposite_stage_mat_tables(
            k[None, None, :] * kron[:, :, None], T1m, T2, None,
            params["taus"])

    def jac_args(k):
        mats = tables(k)
        _, dk = torch.func.jvp(tables, (k,), (torch.ones_like(k),))
        return args[:12] + (mats, [dk], [zeros])

    def fused(k):
        re, im = cuda_xcomposite.xcomposite_jacobian_echoes(*jac_args(k),
                                                             **kw)
        return ((re[:, 0, 0], im[:, 0, 0]),
                (re[:, 1:, 0].movedim(1, -1), im[:, 1:, 0].movedim(1, -1)))

    kt = torch.as_tensor(k_true, dtype=torch.float32, device=dev)
    targs = jac_args(kt)
    k = cuda_xcomposite.xcomposite_jacobian_echoes(*targs, **kw)
    twin = _x_errors(torch, tuple(x[..., :QMT_TWIN] for x in k),
                     cuda_xcomposite.xcomposite_jacobian_plain(
                         *_jac_cut(torch, targs, XCOMP_JAC_AXES,
                                   cpu=False)(QMT_TWIN), **kw), True)
    noise = 2e-4
    mre = k[0][:, 0, 0].double().cpu().numpy() \
        + noise * rng.standard_normal((params["nadc"], n))
    mim = k[1][:, 0, 0].double().cpu().numpy() \
        + noise * rng.standard_normal((params["nadc"], n))
    del k
    t0 = time.perf_counter()
    theta = gauss_newton_refine(
        lambda th: fused(torch.as_tensor(th[0], dtype=torch.float32,
                                         device=dev)),
        np.full((1, n), 0.006), mre, mim, iters=8, bounds=[(5e-4, 0.05)],
        solve_scale=True)
    gn_s = time.perf_counter() - t0
    rms_k = float(np.sqrt(np.mean((theta[0] - k_true) ** 2)))
    print(f"[kfit] examples/mt_prep_gre.py's exchange-rate fit at {n} "
          f"voxels: 8 Gauss-Newton iterations ({gn_s:.3f} s), k RMSE "
          f"{rms_k:.3e} /ms (assert < 2e-4; truth 3-9e-3, start 6e-3); the "
          f"truth's Jacobian vs the twin on {QMT_TWIN} voxels: signal "
          f"{twin[0]:.3e}, column {twin[1][0]:.3e}")
    if not rms_k < 2e-4:
        raise AssertionError(f"exchange-rate fit RMSE {rms_k}")
    if not twin[0] <= TOL_KERNEL or not max(twin[1]) <= TOL_JAC_KERNEL:
        raise AssertionError("the composite EPG-X Jacobian kernel disagrees "
                             "with its twin on the exchange-rate fit")
    _expect("kfit", (cuda_xcomposite.JAC_LAUNCHES,), (9,))
    return dict(args=targs, kw=kw, launches=9, rms_k=rms_k, gn_s=gn_s,
                twin=twin, cut=_jac_cut(torch, targs, XCOMP_JAC_AXES))


@contextlib.contextmanager
def xgre_stage_a_passthrough():
    """The xgre twins with stage A's mix replaced by a pass-through (the
    first of each TR's two ``cuda_xgre._mix_groups`` calls returns its
    sets unchanged): the recurrence a warp of the Jacobian kernel runs
    when every atom it holds has the identity stage A with zero tangents,
    as the qMT fit's trains do."""
    from epgpy_torch.models import cuda_xgre

    mix, calls = cuda_xgre._mix_groups, [0]

    def passthrough(sets, m, dens):
        calls[0] += 1
        return list(sets) if calls[0] % 2 else mix(sets, m, dens)

    cuda_xgre._mix_groups = passthrough
    try:
        yield
    finally:
        cuda_xgre._mix_groups = mix


def xgre_jac_kernel_ops(torch, call, natoms):
    """Operations of the xgre Jacobian kernel on a train whose stage A is
    the identity with zero tangents for every atom (the qMT fit's): the
    twin's count (``call(n)`` on n atoms, ``linear_ops``) with stage A's
    mix replaced by a pass-through, as the kernel's warps skip it."""
    with xgre_stage_a_passthrough():
        return linear_ops(torch, call, natoms)


@contextlib.contextmanager
def x_identity_passthrough(mod, mixes=False):
    """The EPG-X twins of `mod` (``cuda_xgre`` or ``cuda_xcomposite``) with
    a pool's saturation and rotation passed through where they are the
    identity for every atom (factors (1, 0, 1, 0); a flip of 0, whose
    rotation coefficients are (1, 0, ..., 1, 0, ...)) and, with `mixes`,
    a primal exchange mix whose matrices are the identity for every atom:
    the work the kernels skip (the per-stage, per-pool flags of the
    composite Jacobian and both primal kernels; the primal kernels'
    identity stages).  The tests count no operation."""
    import torch

    from epgpy_torch.models import planes

    sat, rot, mix = mod._saturate, planes.apply_rot, mod._mix_groups
    one = (1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0)

    def same(vals, ref):
        return all(bool((torch.as_tensor(v) == w).all())
                   for v, w in zip(vals, ref))

    def saturate(s, f):
        return s if same(f, (1.0, 0.0, 1.0, 0.0)) else sat(s, f)

    def rotate(rc, s):
        return s if same(rc, one) else rot(rc, s)

    def mix_groups(sets, m, dens):
        C = len(sets[0])
        eye = len(sets) == 1 and same(
            [m(0, p, i, j) for p in range(3) for i in range(C)
             for j in range(C)],
            [float(p != 1 and i == j) for p in range(3) for i in range(C)
             for j in range(C)])
        return list(sets) if eye else mix(sets, m, dens)

    mod._saturate, planes.apply_rot = saturate, rotate
    if mixes:
        mod._mix_groups = mix_groups
    try:
        yield
    finally:
        mod._saturate, planes.apply_rot, mod._mix_groups = sat, rot, mix


def xcomp_jac_kernel_ops(torch, call, natoms):
    """Operations of the composite EPG-X Jacobian kernel: the twin's count
    (``call(n)`` on n atoms, ``linear_ops``) with the identity saturations
    and rotations passed through, as the kernel's stages skip them (the
    exchange-rate fit's bound pool is never flipped, and only the
    preparation stages saturate)."""
    from epgpy_torch.models import cuda_xcomposite

    with x_identity_passthrough(cuda_xcomposite):
        return linear_ops(torch, call, natoms)


def twin_ops(torch, mod, call, natoms):
    """Operations of the recurrence alone (``mod._twin``) in ``call(n)``,
    the twin on the first n atoms, at n = 2 and 4, extrapolated linearly
    to `natoms`: a primal EPG-X kernel's work, without the per-atom stage
    matrices its wrapper builds before the launch."""
    twin, got = mod._twin, []

    def counted(*a, **k):
        box = []
        got.append(count_ops(torch, lambda: box.append(twin(*a, **k))))
        return box[0]

    mod._twin = counted
    try:
        call(2)
        call(4)
    finally:
        mod._twin = twin
    a, b = got
    return a + (b - a) / 2.0 * (natoms - 2)


def xgre_kernel_ops(torch, call, natoms):
    """Operations of the xgre primal kernel: the twin's recurrence
    (``twin_ops``) with the identity saturations, rotations and exchange
    stages passed through, as the kernel skips them (the MT-GRE train's
    absent stage A, its unflipped bound pool and unsaturated free pool)."""
    from epgpy_torch.models import cuda_xgre

    with x_identity_passthrough(cuda_xgre, mixes=True):
        return twin_ops(torch, cuda_xgre, call, natoms)


def xcomp_kernel_ops(torch, call, natoms):
    """Operations of the composite EPG-X primal kernel: the twin's
    recurrence (``twin_ops``) with the identity saturations, rotations and
    mixes (table entry 0) passed through, as the kernel skips them."""
    from epgpy_torch.models import cuda_xcomposite

    with x_identity_passthrough(cuda_xcomposite, mixes=True):
        return twin_ops(torch, cuda_xcomposite, call, natoms)


def phase_x_numbers(torch, card, xg, xc, qmt, kfit):
    """The four EPG-X kernels at their main-path shapes: the xgre kernel at
    (a)'s (spoiled MT-GRE, 262,144 atoms), its Jacobian at (d)'s (48 TRs,
    262,144 voxels, 2 variables), the composite EPG-X kernel at (c)'s
    (131,072 atoms) and its Jacobian at (e)'s (65,536 voxels, 1
    variable); returns the JSON entries (launches filled in by main)."""
    from epgpy_torch.models import cuda_xcomposite as cx
    from epgpy_torch.models import cuda_xgre as cg

    def err(jac):
        return lambda k, p: _x_errors(torch, k, p, jac)

    entries = [
        kernel_entry(torch, card, "xgre",
                     "epgpy_tpu/models/pallas_xgre.py:48",
                     (cg.xgre_dictionary_echoes, cg.xgre_dictionary_plain),
                     xg["args"], xg["kw"], (), XGRE_ATOMS, 0, False,
                     cut=_xgre_cut(torch, xg["args"]), errors=err(False),
                     work=xgre_kernel_ops),
        kernel_entry(torch, card, "xgre_jac",
                     "epgpy_tpu/models/pallas_xgre.py:282",
                     (cg.xgre_jacobian_echoes, cg.xgre_jacobian_plain),
                     qmt["args"], qmt["kw"], (), QMT_NVOX, 0, True,
                     cut=_jac_cut(torch, qmt["args"], XGRE_JAC_AXES),
                     errors=err(True), work=xgre_jac_kernel_ops),
        kernel_entry(torch, card, "xcomposite",
                     "epgpy_tpu/models/pallas_xcomposite.py:51",
                     (cx.xcomposite_echoes, cx.xcomposite_plain),
                     xc["args"], xc["kw"], (), xc["natoms"], 0, False,
                     cut=_xcomp_cut(torch, xc["args"]), errors=err(False),
                     work=xcomp_kernel_ops),
        kernel_entry(torch, card, "xcomposite_jac",
                     "epgpy_tpu/models/pallas_xcomposite.py:292",
                     (cx.xcomposite_jacobian_echoes,
                      cx.xcomposite_jacobian_plain), kfit["args"],
                     kfit["kw"], (), KFIT_NVOX, 0, True, cut=kfit["cut"],
                     errors=err(True), work=xcomp_jac_kernel_ops),
    ]
    # the wrappers build the per-atom stage matrices (the primal) and
    # pack the coefficient rows before the launch: split the device time
    for e, run, key in zip(entries, (xg, qmt, xc, kfit),
                           ("xgre_kernel", "xgre_jac_kernel", "xcomp_kernel",
                            "xcomp_jac_kernel")):
        fn = {"xgre": cg.xgre_dictionary_echoes,
              "xgre_jac": cg.xgre_jacobian_echoes,
              "xcomposite": cx.xcomposite_echoes,
              "xcomposite_jac": cx.xcomposite_jacobian_echoes}[e["name"]]
        split = _profile_split(torch, lambda: fn(*run["args"], **run["kw"]),
                               key)
        _print_split(f"{e['name']} wrapper call", e["name"], split, card)
        own = _launch_ms(torch, lambda: fn(*run["args"], **run["kw"]),
                         f"epg_{e['name']}")
        print(f"[numbers] {e['name']} kernel alone (CUDA events around the "
              f"launch): {own:.3f} ms of the wrapper's {e['ms']:.3f} ms "
              f"({card})")
    print(f"[numbers] simulate(density=) spoiled MT-GRE, {XGRE_ATOMS} atoms:"
          f" first {xg['first_s']:.4f} s, memoized {xg['memo_s'] * 1e3:.3f} "
          f"ms against the kernel's {entries[0]['ms']:.3f} ms ({card})")
    print(f"[numbers] simulate(density=) MT-prepared, {xc['natoms']} atoms: "
          f"first {xc['first_s']:.4f} s, memoized {xc['memo_s'] * 1e3:.3f} "
          f"ms against the kernel's {entries[2]['ms']:.3f} ms ({card})")
    print(f"[numbers] qMT fit, {QMT_NVOX} voxels: match "
          f"{qmt['match_s']:.3f} s, {QMT_ITERS} Gauss-Newton iterations "
          f"{qmt['gn_s']:.3f} s; k fit, {KFIT_NVOX} voxels: 8 iterations "
          f"{kfit['gn_s']:.3f} s ({card})")
    return entries


def _memo_pair(torch, fn, reps=5):
    """Host-clock seconds of a memoized simulate() call fn(), with the
    preamble memo kept and with it cleared before every call (the matcher's
    memo stays): what the memo saves, within one run."""
    from epgpy_torch import engine

    kept = _host_s(torch, fn, reps=reps)

    def cleared():
        engine._PREAMBLE_CACHE.clear()
        fn()

    return kept, _host_s(torch, cleared, reps=reps)


def _print_wall(phase, wall):
    """One line of a phase's wall time split by its parts."""
    print(f"[time] {phase} by part: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in wall.items()))


def _timed(fn, *args):
    """fn(*args), printing its wall time under the phase's name."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[time] {fn.__name__}: {time.perf_counter() - t0:.1f} s")
    return out


def main():
    import torch

    t_start = time.perf_counter()
    card = phase_environment(torch)
    import epgpy_torch as epg

    epg.config.set_device(DEVICE)
    epg.config.set_precision("float32")
    _timed(phase_build)
    worst = _timed(phase_cases, torch)
    print(f"[cases] worst max|kernel - plain| = {worst:.3e} "
          f"(limit {TOL_KERNEL})")
    worst_sig, worst_col = _timed(phase_jac_cases, torch)
    print(f"[jac-cases] worst max|kernel - plain| = {worst_sig:.3e} (limit "
          f"{TOL_KERNEL}), worst column {worst_col:.3e} (limit "
          f"{TOL_JAC_KERNEL})")
    worst_hess = _timed(phase_hess_cases, torch)
    print(f"[hess-cases] worst per-block |kernel - plain| = {worst_hess:.3e} "
          f"(limit {TOL_HESS_KERNEL}) over {len(HESS_CASES)} cases, "
          f"{len(HESS_EDGE_CASES)} edges and {2 * len(HESS_SHAPES)} shapes")
    worst_mse, _ = _timed(phase_mse_cases, torch)
    print(f"[mse-cases] worst max|kernel - plain| = {worst_mse:.3e} (limit "
          f"{TOL_KERNEL}) over {len(MSE_CASES)} cases")
    worst_sig, worst_col = _timed(phase_mse_cases, torch, 4096, True)
    print(f"[mse-jac-cases] worst max|kernel - plain| = {worst_sig:.3e} "
          f"(limit {TOL_KERNEL}), worst column {worst_col:.3e} (limit "
          f"{TOL_JAC_KERNEL})")
    worst_design = _timed(phase_design_cases, torch)
    print(f"[design-cases] worst per-block |kernel - plain| = "
          f"{worst_design:.3e} (limit {TOL_DESIGN_KERNEL})")
    for family in ("bssfp", "dess"):
        worst_sig, worst_col = _timed(phase_ssfp_cases, torch, family)
        print(f"[{family}-cases] worst max|kernel - plain| = {worst_sig:.3e}"
              f" (limit {TOL_KERNEL}), worst column {worst_col:.3e} (limit "
              f"{TOL_JAC_KERNEL})")
    worst_sig, worst_col = _timed(phase_megre_cases, torch)
    print(f"[megre-cases] worst max|kernel - plain| = {worst_sig:.3e} (limit "
          f"{TOL_KERNEL}), worst column {worst_col:.3e} (limit "
          f"{TOL_JAC_KERNEL})")
    worst_full = _timed(phase_full_cases, torch)
    print(f"[full-cases] worst max|kernel - plain or fold| = "
          f"{worst_full:.3e} (limit {TOL_KERNEL})")
    worst_sig, worst_col = _timed(phase_comp_cases, torch)
    print(f"[comp-cases] worst max|kernel - plain| = {worst_sig:.3e} (limit "
          f"{TOL_KERNEL}), worst column {worst_col:.3e} (limit "
          f"{TOL_JAC_KERNEL})")
    for family in ("xgre", "xcomp"):
        worst_sig, worst_col = _timed(phase_xcases, torch, family)
        print(f"[{family}-cases] worst max|kernel - plain| = {worst_sig:.3e}"
              f" (limit {TOL_KERNEL}), worst column {worst_col:.3e} (limit "
              f"{TOL_JAC_KERNEL})")
    main_run = _timed(phase_main_path, torch, epg)
    full_run = _timed(phase_full_path, torch, main_run)
    jac_run = _timed(phase_jac_path, torch, epg)
    serve = _timed(phase_serving, torch, epg, main_run.pop("dictionary"))
    hess_run = _timed(phase_hess_path, torch, epg)
    design = _timed(phase_design, torch, epg)
    mse_run = _timed(phase_mse_path, torch, epg)
    mse_jac_run = _timed(phase_mse_jac_path, torch, epg)
    dw_run = _timed(phase_dw_path, torch, epg)
    t2b1 = _timed(phase_t2b1, torch, epg)
    tse = _timed(phase_tse_design, torch, epg)
    bssfp_run = _timed(phase_bssfp_path, torch, epg)
    bjac_run = _timed(phase_bssfp_jac_path, torch, epg)
    dess_run = _timed(phase_dess_path, torch, epg)
    mrfb = _timed(phase_bssfp_serving, torch, epg)
    dmap = _timed(phase_dess_mapping, torch, epg)
    megre_run = _timed(phase_megre_path, torch, epg)
    mjac_run = _timed(phase_megre_jac_path, torch, epg)
    b0 = _timed(phase_b0_mapping, torch, epg)
    dwf = _timed(phase_dwfisp_path, torch, epg)
    comp_run = _timed(phase_comp_path, torch, epg)
    cjac_run = _timed(phase_comp_jac_path, torch, epg)
    mpr = _timed(phase_mprage_mapping, torch, epg)
    cmrf = _timed(phase_cardiac_mapping, torch, epg, comp_run)
    del comp_run["dictionary"]
    xg = _timed(phase_xgre_path, torch, epg)
    xb = _timed(phase_xbssfp_path, torch, epg)
    xc = _timed(phase_xcomp_path, torch, epg)
    qmt = _timed(phase_qmt_fit, torch, epg)
    kfit = _timed(phase_kfit, torch, epg)
    entry = _timed(phase_numbers, torch, epg, card, main_run)
    jac_entry = _timed(phase_jac_numbers, torch, epg, card, jac_run)
    hess_entry = _timed(phase_hess_numbers, torch, epg, card, hess_run)
    # launches on the Hessian's main paths: the flagship (4c) and the SLSQP
    # run of the design (5c)
    hess_entry["launches"] += design["launches"]
    mse_entry, mse_jac_entry = _timed(phase_mse_numbers, torch, card,
                                      mse_run, mse_jac_run, t2b1)
    design_entry = _timed(phase_design_numbers, torch, card, tse)
    _timed(phase_occupancy)
    ssfp_entries = _timed(phase_ssfp_numbers, torch, card, bssfp_run,
                          bjac_run, dess_run)
    megre_entries = _timed(phase_megre_numbers, torch, card, megre_run,
                           mjac_run, full_run, b0, dwf, entry["bound_ms"])
    comp_entries = _timed(phase_comp_numbers, torch, card, comp_run,
                          cjac_run, mpr, cmrf)
    x_entries = _timed(phase_x_numbers, torch, card, xg, xc, qmt, kfit)
    # launches on the EPG-X paths: the spoiled train, its direct call and
    # the two xgre goldens (a, f) and the balanced train (b); the qMT fit
    # (d: truth, dictionary, one per iteration); the MT-prepared train, its
    # direct call and the 7 MTR trains (c) and the xcomp_gre golden (f);
    # the exchange-rate fit (e: truth, one per iteration)
    for entry_, n in zip(x_entries, (
            xg["launches"] + xb["launches"], qmt["launches"],
            xc["launches"] + xg["comp_launches"], kfit["launches"])):
        entry_["launches"] = n
    # launches on the composite paths: the cardiac MRF dictionary, its
    # direct call and the two golden trains (4n), the MPRAGE Jacobian (4o),
    # the two mappings (5i: dictionary, voxels and one Jacobian per
    # iteration; 5j: voxels, the example's dictionary and one Jacobian per
    # iteration)
    comp_entries[0]["launches"] = (comp_run["launches"]
                                   + mpr["launches"]["composite"]
                                   + cmrf["launches"]["composite"])
    comp_entries[1]["launches"] = (cjac_run["launches"]
                                   + mpr["launches"]["composite_jac"]
                                   + cmrf["launches"]["composite_jac"])
    # launches on the bSSFP and DESS paths: the dictionary, its direct
    # call and the golden train (4g), the Jacobian (4h) and MRF serving
    # (5f: dictionary, truth, one Jacobian per Gauss-Newton iteration, one
    # residual per start); the golden and mapping trains (4i) and the
    # mapping (5g: truth, one Jacobian per iteration)
    for entry_, n in zip(ssfp_entries, (
            bssfp_run["launches"] + mrfb["launches"]["bssfp"],
            bjac_run["launches"] + mrfb["launches"]["bssfp_jac"],
            dess_run["launches"] + dmap["launches"]["dess"],
            dess_run["jac_launches"] + dmap["launches"]["dess_jac"])):
        entry_["launches"] = n
    # launches on the ME-GRE paths: the train, its direct call and the
    # golden train (4j), the Jacobian (4k), T2/B0 mapping (5h: truth, one
    # Jacobian per iteration); the full-ladder path (4l)
    for entry_, n in zip(megre_entries, (
            megre_run["launches"] + b0["launches"]["megre"],
            mjac_run["launches"] + b0["launches"]["megre_jac"],
            full_run["launches"])):
        entry_["launches"] = n
    # launches on the CPMG paths: the published and scaled trains (4d), the
    # DW-TSE train (4f) and T2/B1 mapping (5d: truth and dictionary, one
    # Jacobian per Gauss-Newton iteration); the Jacobian (4e)
    mse_entry["launches"] += dw_run["launches"] + t2b1["launches"]["cpmg"]
    mse_jac_entry["launches"] += t2b1["launches"]["cpmg_jac"]
    # launches on the main paths: the dictionary (4), the Jacobian (4b),
    # serving (5b: truth fingerprints, one Jacobian per iteration) and the
    # DW-FISP train and its Jacobian (4m)
    entry["launches"] += serve["launches"]["fisp_half"] + dwf["launches"]
    jac_entry["launches"] += (serve["launches"]["fisp_jac"]
                              + dwf["jac_launches"])
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
    r = t2b1["rmse"]
    print(f"[numbers] T2/B1 mapping, {MAP_NVOX} voxels x {MAP_NECHO} echoes:"
          f" dictionary {t2b1['dict_s'] * 1e3:.2f} ms, match "
          f"{t2b1['match_s'] * 1e3:.2f} ms, {MAP_ITERS} Gauss-Newton "
          f"iterations {t2b1['gn_s']:.3f} s; T2 RMSE mono {r['mono']:.3f} / "
          f"match {r['match']:.3f} / refined {r['gn']:.3f} ms, B1 RMSE "
          f"{r['b1_gn']:.5f} ({card})")
    print(f"[numbers] TSE design, {TSE_NECHO} echoes: fused loss + gradient "
          f"{tse['fused_ms'][0]:.3f} ms (4 atoms), {tse['fused_ms'][1]:.3f} "
          f"ms (4096 atoms); SLSQP {tse['nit']} iterations in "
          f"{tse['slsqp_s']:.3f} s ({tse['eval_s'] / tse['slsqp_s']:.1%} in "
          f"evaluations), CRLB {tse['v0']:.6g} -> {tse['v1']:.6g} (constant "
          f"{tse['v_flat']:.6g}) ({card})")
    per = mrfb["per_iter"]
    print(f"[numbers] bSSFP MRF serving, {MRFB_NVOX} voxels x "
          f"{np.prod(MRFB_GRID)} atoms: dictionary + compression "
          f"{mrfb['dict_s']:.3f} s, match {mrfb['match_s'] * 1e3:.1f} ms; "
          f"Gauss-Newton per iteration {mrfb['gn_s'] / (4 * MRFB_ITERS):.3f}"
          f" s = host build + match {per['host']:.3f} s + simulate (kernel "
          f"+ assembly) {per['simulate']:.3f} s + update/solve "
          f"{per['solve']:.3f} s; RMSE T1 {mrfb['rmse1'][0]:.4f} ms, T2 "
          f"{mrfb['rmse1'][1]:.5f} ms, df {1e3 * mrfb['rmse1'][2]:.5f} Hz "
          f"({card})")
    print(f"[numbers] DESS T1/T2 mapping, {DESS_NVOX} voxels: {DESS_ITERS} "
          f"Gauss-Newton iterations {dmap['gn_s']:.3f} s (simulate "
          f"{dmap['split']['simulate']:.3f} s); T1 RMSE "
          f"{dmap['rmse'][0]:.3f} ms, T2 RMSE {dmap['rmse'][1]:.4f} ms "
          f"({card})")
    kernels = ([entry, jac_entry, hess_entry, mse_entry, mse_jac_entry,
                design_entry] + ssfp_entries + megre_entries + comp_entries
               + x_entries)
    print("[bound] share of the bound (bound_ms / ms): " + ", ".join(
        f"{k['name']} {k['bound_ms'] / k['ms']:.1%}" for k in kernels))
    print(f"[time] total: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
