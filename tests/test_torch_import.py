"""epgpy_torch imports without JAX and exposes the slice's public names."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PUBLIC = ["config", "StateMatrix", "Operator", "EmptyOperator",
          "MultiOperator", "DiffOperator", "Wait", "T", "Tx", "Ty", "Phi",
          "E", "P", "R", "S", "Probe", "Adc", "ADC", "Jacobian", "Hessian",
          "PartialsPruner", "simulate",
          "simulate_simple", "modify", "flatten_sequence", "getshape",
          "getnshift", "get_adc_times"]
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
                                        "hess_block_size", "HESS_LAUNCHES"],
    "epgpy_torch.models.mrf": ["fisp_mrf_signal", "fisp_mrf_dictionary",
                               "fisp_mrf_jacobian", "save_dictionary",
                               "load_dictionary"],
    "epgpy_torch.models.planes": ["cmul", "rot_coeffs", "rot_coeffs_db1",
                                  "rot_A", "rot_B", "rot_Z", "apply_rot",
                                  "shift_fold", "relax_tangents",
                                  "relax_tau_terms", "inversion_prep",
                                  "diff_attenuation"],
    "epgpy_torch.fisp_dispatch": ["match_fisp", "run_fisp_kernel",
                                  "kernel_fits", "DISPATCH_COUNTS",
                                  "count_dispatch", "jac_kernel_fits",
                                  "match_jacobian_probes",
                                  "run_fisp_jacobian", "match_fisp_hessian",
                                  "match_hessian_probes",
                                  "run_fisp_hessian", "hess_kernel_fits"],
    "epgpy_torch.diff": ["Jacobian", "Hessian", "parse_order1",
                         "parse_order2", "simulate_diff", "substitute"],
    "epgpy_torch.parallel": ["dictionary_match", "compress_dictionary",
                             "project_signals", "mrf_reconstruct",
                             "gauss_newton_refine", "mrf_design_loss",
                             "mrf_design_loss_grad_fused",
                             "mrf_design_slsqp", "mrf_design_step",
                             "FA_BOUNDS", "TR_BOUNDS"],
    "epgpy_torch.stats": ["crlb", "crlb_split", "confint",
                          "get_tstat_interval"],
    "epgpy_torch.convert": ["from_numpy_params", "from_numpy_states"],
    "epgpy_torch.config": ["set_precision", "real_dtype", "complex_dtype",
                           "set_device", "device"],
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


def test_default_device_is_cuda():
    """No automatic CPU fallback: the default device is CUDA."""
    code = ("import epgpy_torch\n"
            "assert epgpy_torch.config.device().type == 'cuda'\n"
            "assert epgpy_torch.config.precision() == 'float32'\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
