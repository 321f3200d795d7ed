"""Build and load the package's CUDA kernels at first use.

All ``csrc/*.cu`` files compile with ``nvcc`` (one process per source, all
started together) and link into one shared library with a plain C
interface, ``build/epgpy_torch/libepgpy_torch_<hash>.so`` beside the
package (the hash covers every source and header, so an edited source
builds a new library), which is loaded with ``ctypes``.  Nothing here runs
at import: the first kernel launch calls :func:`load`.  There is no
fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["build", "load", "build_info", "library_path", "BUILD_DIR",
           "NVCC_FLAGS"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "epgpy_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _F, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
#: C entry points and their argument types (see csrc/*.cu)
_SIGNATURES = {
    "epg_fisp_half": [_P, _P, _P, _P, _F, _F, _P, _P, _P, _P, _P, _F, _F,
                      _P] + [_I] * 14 + [_P],
    "epg_fisp_jac": [_P, _P, _P, _P, _F, _F, _P, _P, _P, _P, _P, _F, _F, _P,
                     _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                     _P],
    "epg_fisp_hess": [_P] * 3 + [_F] * 2 + [_P] * 5 + [_I] * 8 + [_P],
    "epg_cpmg": [_F, _F, _F, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _F, _F,
                 _F, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "epg_cpmg_jac": [_F, _F, _F, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _F,
                     _F, _F, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "epg_cpmg_design": [_F, _F, _F, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                        _I, _I, _I, _P],
    "epg_bssfp": [_P, _P, _P, _P, _F, _F, _P, _P, _P, _P, _P] + [_I] * 8
    + [_P],
    "epg_bssfp_jac": [_P, _P, _P, _P, _F, _F, _P, _P, _P, _P, _P] + [_I] * 9
    + [_P],
    "epg_dess": [_P, _P, _P, _P, _F, _P, _P, _P, _P, _P] + [_I] * 8 + [_P],
    "epg_dess_jac": [_P, _P, _P, _P, _F, _P, _P, _P, _P, _P] + [_I] * 10
    + [_P],
    "epg_megre": [_P] * 9 + [_I] * 9 + [_P],
    "epg_megre_jac": [_P] * 9 + [_I] * 8 + [_P],
    "epg_fisp_full": [_P, _P, _P, _P, _F, _F, _P, _P, _P, _P, _P, _P]
    + [_I] * 10 + [_P],
    "epg_composite": [_P] * 16 + [_I] * 14 + [_P],
    "epg_composite_jac": [_P] * 16 + [_I] * 14 + [_P],
    "epg_xgre": [_P] * 10 + [_I] * 9 + [_P],
    "epg_xgre_jac": [_P] * 10 + [_I] * 10 + [_P],
    "epg_xcomposite": [_P] * 16 + [_I] * 16 + [_P],
    "epg_xcomposite_jac": [_P] * 16 + [_I] * 17 + [_P],
}

#: the loaded library and what its build printed: {"lib", "path",
#: "seconds", "log"}; "seconds" is None when the library was already built
_loaded: dict = {}


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives."""
    cu, cuh = _sources()
    h = hashlib.sha256()
    for f in cu + cuh + [Path(__file__)]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libepgpy_torch_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the epgpy_torch CUDA kernels build from source")


def build() -> dict:
    """Compile the library if the current sources have none yet.

    Returns {"path", "seconds", "log"}: the build's wall time (None when
    nothing was compiled) and nvcc's output (register and shared-memory
    use per kernel from ``-Xptxas -v``)."""
    path = library_path()
    if path.exists():
        return {"path": path, "seconds": None, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    tag = f"{path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{f.stem}.o" for f in cu]
    tmp = path.with_name(f"{tag}.so.tmp")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o),
                               str(f)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for f, o in zip(cu, objs)]
    logs = [f"== {f.name}\n{p.communicate()[0]}" for f, p in zip(cu, procs)]
    failed = [f.name for f, p in zip(cu, procs) if p.returncode != 0]
    if not failed:
        link = subprocess.run([_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o",
                               str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed = ["link"]
    for o in objs:
        o.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
    os.replace(tmp, path)        # atomic: concurrent builds agree
    return {"path": path, "seconds": seconds, "log": log}


def load():
    """The kernel library (built first if needed) as a ctypes.CDLL with
    every entry point's argtypes/restype declared."""
    if "lib" not in _loaded:
        info = build()
        lib = ctypes.CDLL(str(info["path"]))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded.update(info, lib=lib)
    return _loaded["lib"]


def build_info() -> dict:
    """{"path", "seconds", "log"} of the loaded library (after load())."""
    return {k: _loaded[k] for k in ("path", "seconds", "log")}
