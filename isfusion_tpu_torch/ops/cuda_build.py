"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C entry point and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes`` (no PyTorch headers: a build takes seconds, not minutes).
Libraries go to ``build/isfusion_tpu_torch_kernels/`` at the repository
root (listed in ``.gitignore``), named by a hash of the source and flags,
and are built at first use — so a fresh checkout builds them from its own
sources. Nothing here runs at import time: the CPU tests import every
module on a machine with no ``nvcc``.

``LAUNCHES`` holds one launch counter per kernel. A wrapper adds one where
it launches its kernel and nowhere else, so a run can show that the main
path went through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "isfusion_tpu_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# C signature of each kernel's entry point: (argtypes, restype)
_P, _LL = ctypes.c_void_p, ctypes.c_longlong
SIGNATURES = {
    "masked_gather": ([_P, _P, _P, _P, _LL, _LL, _LL, _P], ctypes.c_int),
}

LAUNCHES: Dict[str, int] = {name: 0 for name in SIGNATURES}
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def find_nvcc() -> str:
    cands = [os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"]
    for root in cands:
        p = Path(root) / "bin" / "nvcc"
        if root and p.is_file():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{h[:12]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = _lib_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC_DIR / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stderr}")
    os.replace(tmp, out)
    return out


def build_all() -> float:
    """Build every kernel, one ``nvcc`` per source, all started together.
    Returns the wall seconds taken."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(SIGNATURES)) as ex:
        list(ex.map(build, SIGNATURES))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = SIGNATURES[name]
        _LIBS[name] = lib
    return lib
