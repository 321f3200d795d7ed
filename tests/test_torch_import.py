"""epgpy_torch imports without JAX and exposes the slice's public names
(the sequence DSL, the shaped pulses, the reference's flat aliases, the
EPG-NNLS fit, the streamed compression, the inverse Laplace transform,
traces and diagrams, the device mesh and its sharded wrappers included),
with the JAX package's argument order; every public name of the JAX
package has a counterpart but those not ported on purpose."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PUBLIC = ["config", "StateMatrix", "Operator", "EmptyOperator",
          "MultiOperator", "DiffOperator", "Wait", "T", "Tx", "Ty", "Phi",
          "E", "P", "R", "S", "D", "X", "exchange_matrix", "Probe", "Adc",
          "ADC", "Jacobian",
          "Hessian", "PartialsPruner", "simulate",
          "simulate_simple", "modify", "flatten_sequence", "getshape",
          "getnshift", "get_adc_times", "bssfp_sequence", "dess_sequence",
          "spgr_sequence", "G", "C", "DFT", "Imaging", "imaging", "dft",
          "Sequence", "Variable", "Constant", "Expression", "repeat",
          "sequence", "RFPulse", "load_pulse", "operator", "opscalar",
          "opmatrix", "transition", "evolution", "shift", "diffusion",
          "exchange", "probe", "rfpulse", "statematrix", "common",
          "functions", "operators", "core", "set_array_module",
          "get_array_module", "ilt1d"]
#: the reference's flat aliases: package attribute -> the module it names
ALIASES = {"operator": "epgpy_torch.ops.base",
           "opscalar": "epgpy_torch.ops.scalarop",
           "opmatrix": "epgpy_torch.ops.matrixop",
           "transition": "epgpy_torch.ops.transition",
           "evolution": "epgpy_torch.ops.evolution",
           "shift": "epgpy_torch.ops.shift",
           "diffusion": "epgpy_torch.ops.diffusion",
           "exchange": "epgpy_torch.ops.exchange",
           "probe": "epgpy_torch.ops.probe",
           "rfpulse": "epgpy_torch.ops.rfpulse",
           "statematrix": "epgpy_torch.statematrix",
           "common": "epgpy_torch.common",
           "functions": "epgpy_torch.engine",
           "operators": "epgpy_torch.ops",
           "core": "epgpy_torch.epg",
           "sequence": "epgpy_torch.sequence"}
MODULES = {
    "epgpy_torch.models.cuda_fisp": ["fisp_dictionary_cuda",
                                     "fisp_dictionary_plain", "kernel_fits",
                                     "LAUNCHES", "fisp_jacobian_cuda",
                                     "fisp_jacobian_plain",
                                     "fisp_jacobian_echoes",
                                     "jac_kernel_fits", "JAC_LAUNCHES"],
    "epgpy_torch.models.cuda_hessian": ["fisp_hessian_cuda",
                                        "fisp_hessian_plain",
                                        "hess_kernel_fits",
                                        "hess_geometry", "HESS_LAUNCHES"],
    "epgpy_torch.models.cuda_mse": ["cpmg_dictionary_cuda",
                                    "cpmg_dictionary_plain",
                                    "cpmg_jacobian_cuda",
                                    "cpmg_jacobian_plain", "cpmg_echoes",
                                    "cpmg_jacobian_echoes",
                                    "mse_kernel_fits", "mse_jac_kernel_fits",
                                    "LAUNCHES", "JAC_LAUNCHES"],
    "epgpy_torch.models.cuda_msedesign": ["cpmg_design_cuda",
                                          "cpmg_design_plain",
                                          "design_kernel_fits",
                                          "design_tile", "DESIGN_LAUNCHES"],
    "epgpy_torch.models.cuda_bssfp": ["bssfp_dictionary_cuda",
                                      "bssfp_dictionary_plain",
                                      "bssfp_jacobian_cuda",
                                      "bssfp_jacobian_plain",
                                      "bssfp_echoes",
                                      "bssfp_jacobian_echoes", "LAUNCHES",
                                      "JAC_LAUNCHES"],
    "epgpy_torch.models.cuda_dess": ["dess_dictionary_cuda",
                                     "dess_dictionary_plain",
                                     "dess_jacobian_cuda",
                                     "dess_jacobian_plain", "dess_echoes",
                                     "dess_jacobian_echoes", "LAUNCHES",
                                     "JAC_LAUNCHES"],
    "epgpy_torch.models.cuda_megre": ["megre_dictionary_cuda",
                                      "megre_dictionary_plain",
                                      "megre_jacobian_cuda",
                                      "megre_jacobian_plain", "megre_echoes",
                                      "megre_jacobian_echoes",
                                      "megre_kernel_fits",
                                      "megre_jac_kernel_fits", "LAUNCHES",
                                      "JAC_LAUNCHES"],
    "epgpy_torch.models.cuda_composite": ["composite_cuda",
                                          "composite_plain",
                                          "composite_jacobian_cuda",
                                          "composite_jacobian_plain",
                                          "composite_echoes",
                                          "composite_jacobian_echoes",
                                          "composite_kernel_fits",
                                          "composite_jac_kernel_fits",
                                          "COMP_JAC_GROUPS", "LAUNCHES",
                                          "JAC_LAUNCHES"],
    "epgpy_torch.models.cuda_fisp": ["fisp_full_ladder_cuda",
                                     "fisp_full_ladder_plain",
                                     "fisp_full_echoes", "full_kernel_fits",
                                     "FULL_LAUNCHES"],
    "epgpy_torch.engine": ["clear_caches", "simulate"],
    "epgpy_torch.models.ssfp": ["spgr_sequence", "bssfp_sequence",
                                "dess_sequence"],
    "epgpy_torch.models.mse": ["cpmg_sequence", "mse_signal"],
    "epgpy_torch.ops.diffusion": ["D", "compute_bmatrix",
                                  "diffusion_operator"],
    "epgpy_torch.models.mrf": ["fisp_mrf_signal", "fisp_mrf_dictionary",
                               "fisp_mrf_jacobian", "save_dictionary",
                               "load_dictionary"],
    "epgpy_torch.models.planes": ["cmul", "rot_coeffs", "rot_coeffs_db1",
                                  "rot_A", "rot_B", "rot_Z", "apply_rot",
                                  "rot_k0", "shift_fold", "echo_copy",
                                  "df_tangent", "relax_tangents",
                                  "relax_tau_terms", "inversion_prep",
                                  "diff_attenuation", "shift_down",
                                  "stage_attenuation", "mix_planes",
                                  "mix_tangent"],
    "epgpy_torch.models.cuda_xgre": ["xgre_dictionary_cuda",
                                     "xgre_dictionary_plain",
                                     "xgre_dictionary_echoes",
                                     "xgre_jacobian_cuda",
                                     "xgre_jacobian_plain",
                                     "xgre_jacobian_echoes",
                                     "exchange_stage_mats",
                                     "xgre_kernel_fits",
                                     "xgre_jac_kernel_fits", "LAUNCHES",
                                     "JAC_LAUNCHES"],
    "epgpy_torch.models.cuda_xcomposite": ["xcomposite_cuda",
                                           "xcomposite_plain",
                                           "xcomposite_echoes",
                                           "xcomposite_jacobian_cuda",
                                           "xcomposite_jacobian_plain",
                                           "xcomposite_jacobian_echoes",
                                           "xcomposite_stage_mat_tables",
                                           "LAUNCHES", "JAC_LAUNCHES"],
    "epgpy_torch.ops.exchange": ["X", "exchange_matrix", "exchange_operator",
                                 "PrecomputedExchange",
                                 "precompute_exchange"],
    "epgpy_torch.ops.shiftnd": ["apply_shift", "shiftnd_table",
                                "shiftmerge_table",
                                "shiftmerge_table_batched"],
    "epgpy_torch.ops.shiftdense": ["shiftmerge_dense",
                                   "shiftmerge_dense_varying"],
    "epgpy_torch.utils.imaging": ["imaging", "dft"],
    "epgpy_torch.utils.magnettransfer": ["saturation_rate",
                                         "absorption_rate"],
    "epgpy_torch.utils.constants": ["gamma_1H", "gamma_23Na"],
    "epgpy_torch.fisp_dispatch": ["match_fisp", "run_fisp_kernel",
                                  "kernel_fits", "DISPATCH_COUNTS",
                                  "count_dispatch", "jac_kernel_fits",
                                  "match_jacobian_probes",
                                  "run_fisp_jacobian", "match_fisp_hessian",
                                  "match_hessian_probes",
                                  "run_fisp_hessian", "hess_kernel_fits",
                                  "match_mse", "run_mse_kernel",
                                  "run_mse_jacobian", "mse_kernel_fits",
                                  "mse_jac_kernel_fits", "match_bssfp",
                                  "run_bssfp_kernel", "run_bssfp_jacobian",
                                  "match_dess", "run_dess_kernel",
                                  "run_dess_jacobian", "match_megre",
                                  "run_megre_kernel", "run_megre_jacobian",
                                  "match_dwfisp",
                                  "run_dwfisp_kernel",
                                  "run_dwfisp_jacobian", "match_composite",
                                  "run_composite_kernel",
                                  "run_composite_jacobian",
                                  "composite_jac_groups", "match_xgre",
                                  "run_xgre_kernel", "xgre_kernel_fits",
                                  "match_xcomposite", "run_xcomposite_kernel",
                                  "xcomposite_kernel_fits"],
    "epgpy_torch.parallel.mesh": ["Mesh", "make_mesh", "atom_sharding"],
    "epgpy_torch.ops.evolution": ["evolution_operator",
                                  "relaxation_operator",
                                  "precession_operator"],
    "epgpy_torch.diff": ["Jacobian", "Hessian", "parse_order1",
                         "parse_order2", "simulate_diff", "substitute"],
    "epgpy_torch.parallel": ["make_mesh", "atom_sharding",
                             "fingerprint_crlb_loss", "crlb_train_step",
                             "dictionary_match", "compress_dictionary",
                             "streamed_compress_dictionary",
                             "save_compression", "load_compression",
                             "t2_basis", "nnls", "t2_spectrum_map",
                             "project_signals", "mrf_reconstruct",
                             "gauss_newton_refine", "mrf_design_loss",
                             "mrf_design_loss_grad_fused",
                             "mrf_design_slsqp", "mrf_design_step",
                             "mse_design_loss_grad_fused",
                             "tse_design_slsqp", "FA_BOUNDS", "TR_BOUNDS"],
    "epgpy_torch.stats": ["crlb", "crlb_split", "confint",
                          "get_tstat_interval"],
    "epgpy_torch.convert": ["from_numpy_params", "from_numpy_xparams",
                            "from_numpy_states"],
    "epgpy_torch.config": ["set_precision", "real_dtype", "complex_dtype",
                           "int_dtype", "set_device", "device"],
    "epgpy_torch.common": ["shape_with_axes", "set_axes", "asnumpy",
                           "expand_dims_after", "extend_operators",
                           "repr_value", "repr_operator"],
    "epgpy_torch.parallel.t2spectrum": ["t2_basis", "nnls",
                                        "t2_spectrum_map"],
    "epgpy_torch.utils.ilt1d": ["ilt1d", "ilt1d_ls", "flt1d", "ilt1d_crb",
                                "quasi_continuous", "get_bounds",
                                "get_kernel", "get_resolution"],
    "epgpy_torch.utils": ["ilt1d_ls", "flt1d", "ilt1d_crb",
                          "quasi_continuous", "ilt1d", "plotting",
                          "profiling"],
    "epgpy_torch.utils.profiling": ["trace", "annotate"],
    "epgpy_torch.utils.plotting": ["plot_epg", "show", "k_colors_1d",
                                   "k_colors_2d"],
    "epgpy_torch.ops": ["Jacobian", "Hessian"],
    "epgpy_torch.sequence": ["Sequence", "Variable", "Constant",
                             "Expression", "VirtualOperator", "repeat",
                             "operators", "functions", "math", "T", "E",
                             "P", "R", "Phi", "STR_OPERATORS"],
    "epgpy_torch.ops.rfpulse": ["RFPulse", "make_pulse_sequence",
                                "estimate_rf", "estimate_alpha",
                                "encode_phase"],
    "epgpy_torch.utils.pulseio": ["load_pulse", "read_pulse", "load_pta",
                                  "resample_pulse", "PTA_PULSE_KEYS"],
    "epgpy_torch.models.slice_profile": ["slice_profile_scales",
                                         "fisp_mrf_dictionary_sliced"],
    "epgpy_torch.models": ["slice_profile_scales",
                           "fisp_mrf_dictionary_sliced"],
    "epgpy_torch.epg": ["Sequence", "Variable", "Constant", "Expression",
                        "repeat", "operators", "functions", "RFPulse",
                        "ilt1d",
                        "load_pulse", "rfpulse", "opscalar",
                        "set_array_module", "get_array_module"],
}


def test_import_leaves_jax_out():
    code = ("import sys, importlib, epgpy_torch\n"
            f"for m in {sorted(MODULES)!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith(('jax.', 'epgpy_tpu')))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_public_names():
    import importlib

    import epgpy_torch

    missing = [n for n in PUBLIC if not hasattr(epgpy_torch, n)]
    for mod, names in MODULES.items():
        m = importlib.import_module(mod)
        missing += [f"{mod}.{n}" for n in names if not hasattr(m, n)]
    assert not missing, missing


def test_flat_aliases_name_their_modules():
    """The reference's submodule aliases (epgpy_tpu/__init__.py:50-98) name
    the port's modules; the array-module shims return torch."""
    import importlib

    import torch

    import epgpy_torch

    for name, mod in ALIASES.items():
        assert getattr(epgpy_torch, name) is importlib.import_module(mod), \
            name
    assert epgpy_torch.set_array_module("numpy") is torch
    assert epgpy_torch.get_array_module() is torch
    assert epgpy_torch.epg.operators is epgpy_torch.sequence.operators


def test_default_device_is_cuda():
    """No automatic CPU fallback: the default device is CUDA."""
    code = ("import epgpy_torch\n"
            "assert epgpy_torch.config.device().type == 'cuda'\n"
            "assert epgpy_torch.config.precision() == 'float32'\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


#: port function -> its JAX counterpart; their parameters must agree in
#: name and order once the JAX-only knobs are set aside
SAME_ARGS = {
    "epgpy_torch.ops.diffusion:D": "epgpy_tpu.ops.diffusion:D",
    "epgpy_torch.models.mse:cpmg_sequence": "epgpy_tpu.models.mse:"
                                            "cpmg_sequence",
    "epgpy_torch.models.mse:mse_signal": "epgpy_tpu.models.mse:mse_signal",
    "epgpy_torch.parallel.crlb:mse_design_loss_grad_fused":
        "epgpy_tpu.parallel.crlb:mse_design_loss_grad_fused",
    "epgpy_torch.parallel.crlb:tse_design_slsqp":
        "epgpy_tpu.parallel.crlb:tse_design_slsqp",
    "epgpy_torch.models.cuda_mse:cpmg_dictionary_cuda":
        "epgpy_tpu.models.pallas_mse:cpmg_dictionary_pallas",
    "epgpy_torch.models.cuda_mse:cpmg_jacobian_cuda":
        "epgpy_tpu.models.pallas_mse:cpmg_jacobian_pallas",
    "epgpy_torch.models.cuda_msedesign:cpmg_design_cuda":
        "epgpy_tpu.models.pallas_msedesign:cpmg_design_pallas",
    "epgpy_torch.models.cuda_bssfp:bssfp_dictionary_cuda":
        "epgpy_tpu.models.pallas_bssfp:bssfp_dictionary_pallas",
    "epgpy_torch.models.cuda_bssfp:bssfp_jacobian_cuda":
        "epgpy_tpu.models.pallas_bssfp:bssfp_jacobian_pallas",
    "epgpy_torch.models.cuda_dess:dess_dictionary_cuda":
        "epgpy_tpu.models.pallas_dess:dess_dictionary_pallas",
    "epgpy_torch.models.cuda_dess:dess_jacobian_cuda":
        "epgpy_tpu.models.pallas_dess:dess_jacobian_pallas",
    "epgpy_torch.models.cuda_megre:megre_dictionary_cuda":
        "epgpy_tpu.models.pallas_megre:megre_dictionary_pallas",
    "epgpy_torch.models.cuda_megre:megre_jacobian_cuda":
        "epgpy_tpu.models.pallas_megre:megre_jacobian_pallas",
    "epgpy_torch.fisp_dispatch:match_dwfisp":
        "epgpy_tpu.fisp_dispatch:match_dwfisp",
    "epgpy_torch.models.cuda_composite:composite_cuda":
        "epgpy_tpu.models.pallas_composite:composite_pallas",
    "epgpy_torch.models.cuda_composite:composite_jacobian_cuda":
        "epgpy_tpu.models.pallas_composite:composite_jacobian_pallas",
    "epgpy_torch.fisp_dispatch:match_composite":
        "epgpy_tpu.fisp_dispatch:match_composite",
    "epgpy_torch.fisp_dispatch:run_composite_kernel":
        "epgpy_tpu.fisp_dispatch:run_composite_kernel",
    "epgpy_torch.fisp_dispatch:run_composite_jacobian":
        "epgpy_tpu.fisp_dispatch:run_composite_jacobian",
    "epgpy_torch.fisp_dispatch:composite_jac_groups":
        "epgpy_tpu.fisp_dispatch:composite_jac_groups",
    "epgpy_torch.ops.exchange:X": "epgpy_tpu.ops.exchange:X",
    "epgpy_torch.ops.exchange:exchange_matrix":
        "epgpy_tpu.ops.exchange:exchange_matrix",
    "epgpy_torch.ops.exchange:exchange_operator":
        "epgpy_tpu.ops.exchange:exchange_operator",
    "epgpy_torch.utils.magnettransfer:saturation_rate":
        "epgpy_tpu.utils.magnettransfer:saturation_rate",
    "epgpy_torch.utils.magnettransfer:absorption_rate":
        "epgpy_tpu.utils.magnettransfer:absorption_rate",
    "epgpy_torch.models.cuda_xgre:xgre_dictionary_cuda":
        "epgpy_tpu.models.pallas_xgre:xgre_dictionary_pallas",
    "epgpy_torch.models.cuda_xgre:xgre_jacobian_cuda":
        "epgpy_tpu.models.pallas_xgre:xgre_jacobian_pallas",
    "epgpy_torch.models.cuda_xgre:exchange_stage_mats":
        "epgpy_tpu.models.pallas_xgre:exchange_stage_mats",
    "epgpy_torch.models.cuda_xcomposite:xcomposite_cuda":
        "epgpy_tpu.models.pallas_xcomposite:xcomposite_pallas",
    "epgpy_torch.models.cuda_xcomposite:xcomposite_jacobian_cuda":
        "epgpy_tpu.models.pallas_xcomposite:xcomposite_jacobian_pallas",
    "epgpy_torch.models.cuda_xcomposite:xcomposite_stage_mat_tables":
        "epgpy_tpu.models.pallas_xcomposite:xcomposite_stage_mat_tables",
    "epgpy_torch.fisp_dispatch:match_xgre":
        "epgpy_tpu.fisp_dispatch:match_xgre",
    "epgpy_torch.fisp_dispatch:run_xgre_kernel":
        "epgpy_tpu.fisp_dispatch:run_xgre_kernel",
    "epgpy_torch.fisp_dispatch:match_xcomposite":
        "epgpy_tpu.fisp_dispatch:match_xcomposite",
    "epgpy_torch.fisp_dispatch:run_xcomposite_kernel":
        "epgpy_tpu.fisp_dispatch:run_xcomposite_kernel",
    "epgpy_torch.models.ssfp:spgr_sequence":
        "epgpy_tpu.models.ssfp:spgr_sequence",
    "epgpy_torch.models.ssfp:bssfp_sequence":
        "epgpy_tpu.models.ssfp:bssfp_sequence",
    "epgpy_torch.models.ssfp:dess_sequence":
        "epgpy_tpu.models.ssfp:dess_sequence",
    "epgpy_torch.ops.shift:S": "epgpy_tpu.ops.shift:S",
    "epgpy_torch.ops.shift:G": "epgpy_tpu.ops.shift:G",
    "epgpy_torch.ops.shift:C": "epgpy_tpu.ops.shift:C",
    "epgpy_torch.ops.shiftdense:shiftmerge_dense":
        "epgpy_tpu.ops.shiftdense:shiftmerge_dense",
    "epgpy_torch.ops.probe:Adc": "epgpy_tpu.ops.probe:Adc",
    "epgpy_torch.ops.probe:DFT": "epgpy_tpu.ops.probe:DFT",
    "epgpy_torch.ops.probe:Imaging": "epgpy_tpu.ops.probe:Imaging",
    "epgpy_torch.utils.imaging:imaging": "epgpy_tpu.utils.imaging:imaging",
    "epgpy_torch.utils.imaging:dft": "epgpy_tpu.utils.imaging:dft",
    "epgpy_torch.statematrix:StateMatrix":
        "epgpy_tpu.statematrix:StateMatrix",
    "epgpy_torch.ops.transition:T": "epgpy_tpu.ops.transition:T",
    "epgpy_torch.ops.transition:Phi": "epgpy_tpu.ops.transition:Phi",
    "epgpy_torch.ops.evolution:E": "epgpy_tpu.ops.evolution:E",
    "epgpy_torch.ops.evolution:P": "epgpy_tpu.ops.evolution:P",
    "epgpy_torch.ops.evolution:R": "epgpy_tpu.ops.evolution:R",
    "epgpy_torch.ops.scalarop:ScalarOp": "epgpy_tpu.ops.scalarop:ScalarOp",
    "epgpy_torch.ops.matrixop:MatrixOp": "epgpy_tpu.ops.matrixop:MatrixOp",
    "epgpy_torch.common:shape_with_axes": "epgpy_tpu.common:shape_with_axes",
    "epgpy_torch.common:set_axes": "epgpy_tpu.common:set_axes",
    "epgpy_torch.ops.rfpulse:RFPulse": "epgpy_tpu.ops.rfpulse:RFPulse",
    "epgpy_torch.ops.rfpulse:make_pulse_sequence":
        "epgpy_tpu.ops.rfpulse:make_pulse_sequence",
    "epgpy_torch.ops.rfpulse:estimate_rf": "epgpy_tpu.ops.rfpulse:estimate_rf",
    "epgpy_torch.ops.rfpulse:estimate_alpha":
        "epgpy_tpu.ops.rfpulse:estimate_alpha",
    "epgpy_torch.ops.rfpulse:encode_phase":
        "epgpy_tpu.ops.rfpulse:encode_phase",
    "epgpy_torch.utils.pulseio:load_pulse": "epgpy_tpu.utils.pulseio:load_pulse",
    "epgpy_torch.utils.pulseio:read_pulse": "epgpy_tpu.utils.pulseio:read_pulse",
    "epgpy_torch.utils.pulseio:load_pta": "epgpy_tpu.utils.pulseio:load_pta",
    "epgpy_torch.utils.pulseio:resample_pulse":
        "epgpy_tpu.utils.pulseio:resample_pulse",
    "epgpy_torch.models.slice_profile:slice_profile_scales":
        "epgpy_tpu.models.slice_profile:slice_profile_scales",
    "epgpy_torch.models.slice_profile:fisp_mrf_dictionary_sliced":
        "epgpy_tpu.models.slice_profile:fisp_mrf_dictionary_sliced",
    "epgpy_torch.sequence:Sequence": "epgpy_tpu.sequence:Sequence",
    "epgpy_torch.sequence:repeat": "epgpy_tpu.sequence:repeat",
    "epgpy_torch.sequence:VirtualOperator":
        "epgpy_tpu.sequence:VirtualOperator",
    "epgpy_torch.parallel.t2spectrum:t2_basis":
        "epgpy_tpu.parallel.t2spectrum:t2_basis",
    "epgpy_torch.parallel.t2spectrum:nnls":
        "epgpy_tpu.parallel.t2spectrum:nnls",
    "epgpy_torch.parallel.t2spectrum:t2_spectrum_map":
        "epgpy_tpu.parallel.t2spectrum:t2_spectrum_map",
    "epgpy_torch.parallel.match:streamed_compress_dictionary":
        "epgpy_tpu.parallel.match:streamed_compress_dictionary",
    "epgpy_torch.parallel.match:save_compression":
        "epgpy_tpu.parallel.match:save_compression",
    "epgpy_torch.parallel.match:load_compression":
        "epgpy_tpu.parallel.match:load_compression",
    "epgpy_torch.utils.ilt1d:ilt1d": "epgpy_tpu.utils.ilt1d:ilt1d",
    "epgpy_torch.utils.ilt1d:ilt1d_ls": "epgpy_tpu.utils.ilt1d:ilt1d_ls",
    "epgpy_torch.utils.ilt1d:flt1d": "epgpy_tpu.utils.ilt1d:flt1d",
    "epgpy_torch.utils.ilt1d:ilt1d_crb": "epgpy_tpu.utils.ilt1d:ilt1d_crb",
    "epgpy_torch.utils.ilt1d:quasi_continuous":
        "epgpy_tpu.utils.ilt1d:quasi_continuous",
    "epgpy_torch.utils.ilt1d:get_bounds": "epgpy_tpu.utils.ilt1d:get_bounds",
    "epgpy_torch.utils.ilt1d:get_kernel": "epgpy_tpu.utils.ilt1d:get_kernel",
    "epgpy_torch.utils.ilt1d:get_resolution":
        "epgpy_tpu.utils.ilt1d:get_resolution",
    "epgpy_torch.utils.profiling:trace": "epgpy_tpu.utils.profiling:trace",
    "epgpy_torch.utils.profiling:annotate":
        "epgpy_tpu.utils.profiling:annotate",
    "epgpy_torch.utils.plotting:plot_epg": "epgpy_tpu.utils.plotting:plot_epg",
    "epgpy_torch.utils.plotting:show": "epgpy_tpu.utils.plotting:show",
    "epgpy_torch.utils.plotting:k_colors_1d":
        "epgpy_tpu.utils.plotting:k_colors_1d",
    "epgpy_torch.utils.plotting:k_colors_2d":
        "epgpy_tpu.utils.plotting:k_colors_2d",
    "epgpy_torch.common:asnumpy": "epgpy_tpu.common:asnumpy",
    "epgpy_torch.common:expand_dims_after":
        "epgpy_tpu.common:expand_dims_after",
    "epgpy_torch.common:extend_operators": "epgpy_tpu.common:extend_operators",
    "epgpy_torch.common:repr_value": "epgpy_tpu.common:repr_value",
    "epgpy_torch.common:repr_operator": "epgpy_tpu.common:repr_operator",
    "epgpy_torch.config:int_dtype": "epgpy_tpu.config:int_dtype",
    "epgpy_torch.parallel.mesh:make_mesh": "epgpy_tpu.parallel.mesh:make_mesh",
    "epgpy_torch.parallel.mesh:atom_sharding":
        "epgpy_tpu.parallel.mesh:atom_sharding",
    "epgpy_torch.parallel.crlb:fingerprint_crlb_loss":
        "epgpy_tpu.parallel.crlb:fingerprint_crlb_loss",
    "epgpy_torch.parallel.crlb:crlb_train_step":
        "epgpy_tpu.parallel.crlb:crlb_train_step",
    "epgpy_torch.parallel.crlb:mrf_design_loss":
        "epgpy_tpu.parallel.crlb:mrf_design_loss",
    "epgpy_torch.parallel.crlb:mrf_design_loss_grad_fused":
        "epgpy_tpu.parallel.crlb:mrf_design_loss_grad_fused",
    "epgpy_torch.parallel.crlb:mrf_design_slsqp":
        "epgpy_tpu.parallel.crlb:mrf_design_slsqp",
    "epgpy_torch.parallel.crlb:mrf_design_step":
        "epgpy_tpu.parallel.crlb:mrf_design_step",
    "epgpy_torch.parallel.match:dictionary_match":
        "epgpy_tpu.parallel.match:dictionary_match",
    "epgpy_torch.parallel.recon:mrf_reconstruct":
        "epgpy_tpu.parallel.recon:mrf_reconstruct",
    "epgpy_torch.models.mrf:fisp_mrf_dictionary":
        "epgpy_tpu.models.mrf:fisp_mrf_dictionary",
    "epgpy_torch.ops.evolution:evolution_operator":
        "epgpy_tpu.ops.evolution:evolution_operator",
    "epgpy_torch.ops.evolution:relaxation_operator":
        "epgpy_tpu.ops.evolution:relaxation_operator",
    "epgpy_torch.ops.evolution:precession_operator":
        "epgpy_tpu.ops.evolution:precession_operator",
    **{f"epgpy_torch.models.cuda_{mod}:{name}_cuda_sharded":
       f"epgpy_tpu.models.pallas_{mod}:{name}_pallas_sharded"
       for mod, name in (("fisp", "fisp_dictionary"),
                         ("fisp", "fisp_jacobian"),
                         ("mse", "cpmg_dictionary"), ("mse", "cpmg_jacobian"),
                         ("bssfp", "bssfp_dictionary"),
                         ("hessian", "fisp_hessian"),
                         ("composite", "composite_jacobian"),
                         ("xgre", "xgre_dictionary"),
                         ("xcomposite", "xcomposite"),
                         ("msedesign", "cpmg_design"))},
}
#: TPU-only knobs the port does not take
TPU_ONLY = {"interpret", "btile", "pchunk"}


@pytest.mark.parametrize("port", sorted(SAME_ARGS))
def test_jax_names_and_argument_order(port):
    import importlib
    import inspect

    def params(path, drop=()):
        """(parameter names, whether it takes **kwargs)."""
        mod, name = path.split(":")
        fn = getattr(importlib.import_module(mod), name)
        if inspect.isclass(fn):
            fn = fn.__init__
        ps = inspect.signature(fn).parameters.values()
        return ([p.name for p in ps if p.name not in drop and p.name != "self"
                 and p.kind is not p.VAR_KEYWORD],
                any(p.kind is p.VAR_KEYWORD for p in ps))

    got, _ = params(port)
    want, open_tail = params(SAME_ARGS[port], TPU_ONLY)
    # where the JAX function forwards **kwargs, the port may name them
    assert (got[:len(want)] if open_tail else got) == want, (got, want)


#: public names of the JAX package that have no counterpart in the port, on
#: purpose (ROADMAP.md, "Not ported, on purpose")
NOT_PORTED = {
    "epgpy_tpu.config": {"x64_enabled", "setup_compilation_cache"},
    "epgpy_tpu.ops.base": {"register_op"},
    "epgpy_tpu.ops.scalarop": {"split_complex", "join_complex"},
    "epgpy_tpu.ops.shiftdense": {"shiftmerge_dense_lanes",
                                 "shiftmerge_dense_varying_lanes"},
}


def test_every_jax_public_name_has_a_counterpart():
    """The ``__all__`` of every module of epgpy_tpu against the port's
    module of the same name (``pallas_`` -> ``cuda_`` in module names,
    ``_pallas`` -> ``_cuda`` in function names): nothing is missing but
    NOT_PORTED, and every NOT_PORTED name is still a JAX name the port
    lacks, so that the list cannot go stale."""
    import importlib

    missing = {}
    for d, _, fs in os.walk(os.path.join(ROOT, "epgpy_tpu")):
        for f in sorted(fs):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(d, f), ROOT)[:-3]
            name = rel.replace(os.sep, ".").removesuffix(".__init__")
            names = getattr(importlib.import_module(name), "__all__", ())
            if not names:
                continue
            port = importlib.import_module(
                name.replace("epgpy_tpu", "epgpy_torch", 1).replace(
                    "pallas_", "cuda_"))
            gap = {n for n in names
                   if not hasattr(port, n.replace("_pallas", "_cuda"))}
            if gap:
                missing[name] = gap
    assert missing == NOT_PORTED, missing


#: every source of the port, and the card's smoke test
SOURCES = sorted(
    os.path.relpath(os.path.join(d, f), ROOT)
    for d, _, fs in os.walk(os.path.join(ROOT, "epgpy_torch"))
    for f in fs if f.endswith(".py")) + ["chip_smoke.py"]


@pytest.mark.parametrize("path", SOURCES)
def test_source_imports_neither_jax_nor_the_jax_package(path):
    """No source line of the port (or chip_smoke.py) imports jax or
    epgpy_tpu, the EPG-X modules included."""
    import re

    pat = re.compile(r"^\s*(import|from)\s+(jax|epgpy_tpu)\b")
    with open(os.path.join(ROOT, path)) as fh:
        bad = [i for i, line in enumerate(fh, 1) if pat.match(line)]
    assert not bad, (path, bad)


def _c_entry_points():
    """{name: [ctypes type per parameter]} of every extern "C" entry point
    in the port's CUDA sources (pointers, float, int)."""
    import ctypes
    import glob
    import re

    def ctype(decl):
        if "*" in decl:
            return ctypes.c_void_p
        return {"float": ctypes.c_float, "int": ctypes.c_int}[
            decl.split()[-2]]

    out = {}
    for path in sorted(glob.glob(os.path.join(ROOT, "epgpy_torch", "csrc",
                                              "*.cu"))):
        with open(path) as fh:
            src = fh.read()
        for m in re.finditer(r'extern "C"\s+int\s+(\w+)\s*\(([^)]*)\)\s*\{',
                             src):
            out[m.group(1)] = [ctype(a) for a in m.group(2).split(",")]
    return out


def test_c_entry_points_match_their_bindings():
    """Every C entry point of csrc/ has a ctypes binding in _build with its
    parameters' count and types, so a launch argument added on one side
    (the rows per lane that the Hessian and composite-Jacobian wrappers
    pass) cannot shift the others."""
    from epgpy_torch import _build

    entries = _c_entry_points()
    assert set(entries) == set(_build._SIGNATURES)
    for name, types in entries.items():
        assert types == _build._SIGNATURES[name], name


def test_common_helpers_match_jax():
    """The shape and repr helpers of common and config.int_dtype give
    JAX's results (on tensors, and on host values)."""
    import numpy as np
    import torch

    from epgpy_torch import common as tc, config as tcfg
    from epgpy_tpu import common as jc

    a = np.arange(6.0).reshape(2, 3)
    assert tuple(tc.expand_dims_after(torch.as_tensor(a), 4).shape) == \
        jc.expand_dims_after(a, 4).shape == (2, 3, 1, 1)
    x, y = np.ones((2, 3, 3)), np.ones((2, 5, 3, 3))
    got = tc.extend_operators(2, torch.as_tensor(x), None,
                              torch.as_tensor(y))
    want = jc.extend_operators(2, x, None, y)
    assert got[1] is None and want[1] is None
    assert [tuple(g.shape) for g in got[::2]] == [w.shape for w in want[::2]]
    for v, f in ((1.5, ".2f"), (np.float64(2.0), ""), (a, ""), (None, "")):
        assert tc.repr_value(v, f) == jc.repr_value(v, f)
    assert tc.repr_value(torch.tensor(0.25), ".3f") == "0.250"
    assert tc.repr_operator("X", ["tau", "khi", "T1"], [5.0, a, None],
                            [".1f"]) == jc.repr_operator(
        "X", ["tau", "khi", "T1"], [5.0, a, None], [".1f"]) == \
        "X(5.0, array(2, 3))"
    assert np.array_equal(tc.asnumpy(torch.as_tensor(a)), jc.asnumpy(a))
    old = tcfg.precision()
    try:
        tcfg.set_precision("float64")
        assert tcfg.int_dtype() is torch.int64
        tcfg.set_precision("float32")
        assert tcfg.int_dtype() is torch.int32
    finally:
        tcfg.set_precision(old)
