"""Build the CUDA sources under `csrc/` and load them with ctypes.

Each `csrc/<name>.cu` exposes plain C functions (no PyTorch headers), so
`nvcc` compiles it in seconds into `<name>-<hash>.so` under
`utils.build_dir()`: the package's `_build/` (listed in `.gitignore`),
or the directory of `--compile_cache`. The hash covers the source,
the shared headers `csrc/*.cuh` and the flags, so an edited source or
header never loads a stale library. `load(name)` compiles its own
source on first use, so a model pays only for the kernels it runs;
later calls in the process return the loaded library. `build()`
compiles every source at once, one `nvcc` each, in parallel.

Nothing is built at import time: the CPU tests import every module of
the package on a host without `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

from ...utils import build_dir

CSRC = Path(__file__).resolve().parents[2] / "csrc"
SOURCES = ("sigmoid_nms", "sigmoid_nms_topk", "sigmoid_nms_topk_rowmax", "swin_window_attention")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# ctypes signatures: every pointer and the stream as c_void_p, ints as c_int
_SIGNATURES = {
    "sigmoid_nms": {
        "sdnet_sigmoid_nms": [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
        + [ctypes.c_void_p],
    },
    "sigmoid_nms_topk": {
        "sdnet_sigmoid_nms_topk": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
        + [ctypes.c_void_p],
        "sdnet_topk_candidate_slots": [ctypes.c_int] * 3,
    },
    "sigmoid_nms_topk_rowmax": {
        "sdnet_sigmoid_nms_topk_rowmax": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
        + [ctypes.c_void_p],
        "sdnet_rowmax_active_clusters": [ctypes.c_int] * 3,
    },
    "swin_window_attention": {
        "sdnet_swin_window_attention": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
        + [ctypes.c_void_p],
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}  # name -> nvcc's stderr (ptxas register/smem report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are compiled on first use "
        "and need the CUDA toolkit (nvcc on PATH or under /usr/local/cuda)"
    )


def _target(name: str) -> Path:
    content = b"".join(p.read_bytes() for p in
                       [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(content + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> float:
    """Compile each of `names` whose library is missing, all in parallel.
    Returns the wall seconds spent; raises on any compiler error."""
    t0 = time.perf_counter()
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = _target(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, err = proc.communicate()
        build_log[name] = (out + err).strip()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{err}")
            continue
        os.replace(tmp, _target(name))  # atomic: no half-written library
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib
