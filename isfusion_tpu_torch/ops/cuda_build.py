"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C entry point (``SOURCES`` names
the file of an entry point that shares another's) and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes`` (no PyTorch headers: a build takes seconds, not minutes).
Libraries go to ``build/isfusion_tpu_torch_kernels/`` at the repository
root (listed in ``.gitignore``), named by a hash of the source, the shared
headers (``csrc/*.cuh``) and the flags,
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
import re
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
_P, _LL, _F, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float, \
    ctypes.c_int
SIGNATURES = {
    "masked_gather": ([_P, _P, _P, _P, _LL, _LL, _LL, _P], ctypes.c_int),
    "boxes_iou_3d": ([_P, _P, _P, _LL, _LL, _LL, _P, _P], ctypes.c_int),
    "boxes_iou_bev": ([_P, _P, _P, _LL, _LL, _LL, _P, _P, _P], ctypes.c_int),
    "nms_bev": ([_P, _P, _P, _P, _P, _LL, _LL, _LL, _F, ctypes.c_int, _P,
                 _P], ctypes.c_int),
    "nms_circle": ([_P, _P, _P, _P, _F, _P, _LL, _LL, _P, _P], ctypes.c_int),
    "nms_circle_pairwise": ([_P, _P, _P, _P, _F, _P, _P, _LL, _LL, _P, _P],
                            ctypes.c_int),
    "nms_normal_bev": ([_P, _P, _P, _P, _P, _LL, _LL, _LL, _F, _P, _P],
                       ctypes.c_int),
    "gaussian_heatmap": ([_P, _P, _P, _P, _P, _LL, _LL, _LL, _LL, _LL, _P],
                         ctypes.c_int),
    "dynamic_voxelize": ([_I, _P, _P, _P, _LL, _LL, _LL, _LL, _F, _F, _F,
                          _F, _F, _F, _I, _I, _I, _P, _P, _P, _P, _P, _P],
                         _I),
    "dynamic_scatter": ([_I, _P, _P, _P, _LL, _LL, _LL, _P, _P, _P, _P],
                        _I),
    "roiaware_pool": ([_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL,
                       _LL, _LL, _LL, _LL, _P], _I),
    # K14: the PointNet++ ops (ops/pointnet_ops.py)
    "furthest_point_sample": ([_P, _P, _LL, _LL, _LL, _P, _I, _P, _P], _I),
    "fps_cluster": ([_LL], _I),
    "ball_query": ([_P, _P, _P, _LL, _LL, _LL, _LL, _F, _I, _F, _F, _I, _P,
                    _P, _P, _P], _I),
    "ball_query_scratch": ([_LL, _LL, _LL], _LL),
    "three_nn": ([_P, _P, _P, _LL, _LL, _LL, _LL, _P, _P, _P], _I),
    "point_gather": ([_P, _P], _I),
    "point_gather_scratch": ([_LL, _LL], _LL),
    # K15: PAConv's contractions (ops/paconv.py)
    "paconv_bank": ([_P, _P], _I),
    "paconv_bank_scratch": ([_LL, _LL, _LL, _LL, _LL], _LL),
    "paconv_score": ([_P, _P], _I),
    # K17: SST's window partition and token moves (ops/sst_window.py)
    "sst_partition": ([_P, _P], _I),
    "sst_partition_scratch": ([_LL, _LL, _LL, _LL], _LL),
    "sst_move": ([_P, _P], _I),
    # no kernel of a path: the floor of one launch, timed by chip_smoke.py
    "empty_launch": ([_P], _I),
}

# entry points that live in another kernel's source: K10-BEV is K10's
# kernel without the vertical overlap; K10-circle's route past its
# one-launch size shares its source; K14-FPS's cluster size and
# K14-gather's and K14-ball's scratch words (queries, no launch); K15's
# two kernels and K15-bank's scratch query share one source, as K17's do
SOURCES = {"boxes_iou_bev": "boxes_iou_3d",
           "nms_circle_pairwise": "nms_circle",
           "fps_cluster": "furthest_point_sample",
           "point_gather_scratch": "point_gather",
           "ball_query_scratch": "ball_query",
           "paconv_bank": "paconv", "paconv_bank_scratch": "paconv",
           "paconv_score": "paconv", "sst_partition": "sst_window",
           "sst_partition_scratch": "sst_window", "sst_move": "sst_window"}

# launches per kernel, and "segment_layout": the lists that K1's list stage
# built for a K2 caller that passed none (ops/voxel.py:segment_layout);
# "point_gather_layout": the slot lists K14-gather built (its backward's,
# ops/pointnet_ops.py:slot_lists)
LAUNCHES: Dict[str, int] = {name: 0 for name in SIGNATURES}
LAUNCHES["segment_layout"] = 0
LAUNCHES["point_gather_layout"] = 0
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


def source_of(name: str) -> str:
    """The ``csrc/<source>.cu`` stem that holds kernel ``name``."""
    return SOURCES.get(name, name)


def _lib_path(name: str) -> Path:
    name = source_of(name)
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    for hdr in sorted(CSRC_DIR.glob("*.cuh")):
        src += hdr.read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{h[:12]}.so"


def build(name: str) -> Path:
    """Compile the source of kernel ``name`` unless its library is already
    built."""
    out = _lib_path(name)
    name = source_of(name)
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
    sources = sorted({source_of(n) for n in SIGNATURES})
    with ThreadPoolExecutor(max_workers=len(sources)) as ex:
        list(ex.map(build, sources))
    return time.perf_counter() - t0


def ptxas_usage(source) -> Dict[str, dict]:
    """Registers, stack frame and spill bytes of each kernel of the CUDA
    source ``source`` (a path), as ``ptxas -v`` reports them for sm_90a
    with the build's flags; compiles a cubin beside the libraries and
    removes it. Keys are the kernels' names (and those of device
    functions that were not inlined)."""
    source = Path(source)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{source.stem}.{os.getpid()}.cubin"
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                "-fPIC")]
    try:
        res = subprocess.run([find_nvcc(), *flags, "-cubin", "-Xptxas",
                              "-v", "-o", str(tmp), str(source)],
                             capture_output=True, text=True)
    finally:
        tmp.unlink(missing_ok=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{res.stderr}")
    def short(mangled):
        # the last name of an Itanium-mangled (nested) name
        i = 2 + (mangled[2:3] == "N") if mangled.startswith("_Z") else 0
        name = mangled
        while i < len(mangled) and mangled[i].isdigit():
            j = i
            while mangled[j].isdigit():
                j += 1
            name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
        return name

    # "Function properties for F" (an entry or a called device function)
    # precedes F's stack and spill line; "Used N registers" follows its
    # entry's "Compiling entry function" line
    usage, entry, target = {}, None, None
    for line in res.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = usage.setdefault(short(m.group(1)), {})
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            target = usage.setdefault(short(m.group(1)), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and target is not None:
            target.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                          spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            entry["registers"] = int(m.group(1))
    return usage


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = SIGNATURES[name]
        _LIBS[name] = lib
    return lib
