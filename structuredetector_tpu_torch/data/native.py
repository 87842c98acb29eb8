"""The native input tier: ctypes bindings over `native/sdnet_io.cpp`.

The port of `structuredetector_tpu/data/native.py`. One C++ call decodes
a JPEG or PNG, resizes it, flips it and either ImageNet-normalizes it,
scales it to raw [0, 1] or leaves the uint8 pixels, into a buffer the
caller owns; `load_batch` fills a whole NHWC batch on threads of its own.
Every call releases the GIL (`ctypes.CDLL`, not `PyDLL`).

- exact mode (the default) is byte-equal to the PIL path: full decode,
  Pillow's bilinear resample, the same float32 operations;
- fast mode (`exact=False`, the training feed of `--native_io_fast`)
  decodes JPEG in DCT space at a reduced scale and resizes with a 2-tap
  bilinear: close to PIL, not equal.

The library is built at first use, never at import: g++ with
`native/Makefile`'s flags compiles the source where it lies into
`sdnet_io-<hash>.so` under `utils.build_dir()` (the package's `_build/`,
or `--compile_cache DIR`). Two routes are tried in turn:

- "system": the host's libjpeg and libpng headers and `-ljpeg -lpng`,
  as `native/Makefile` builds it;
- "pillow": the headers kept under `third_party/include/` (libjpeg-turbo
  at the libjpeg 6.2 ABI, libpng 1.6) against the libjpeg and libpng16
  that Pillow's wheel ships in `pillow.libs/`, found through an rpath.
  A host without the -dev packages still builds, and decodes with the
  very libraries PIL decodes with.

The hash covers the source, the route's arguments (and its headers) and
the host CPU's model and flags (`-march=native`), so a tree carried to
another machine never loads a library with instructions its CPU lacks.
The write is atomic (a temporary file, then `os.replace`), so processes
that build at once leave one valid library.

When no route builds, `available()` is False and the callers decode with
PIL; the compilers' messages are printed once to stderr and kept in
`build_error()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..ops.device_augment import IMAGENET_MEAN, IMAGENET_STD
from ..utils import build_dir

SOURCE = Path(__file__).resolve().parents[2] / "native" / "sdnet_io.cpp"
VENDORED_INCLUDE = Path(__file__).resolve().parents[1] / "third_party" / "include"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")
LIBS = ("-ljpeg", "-lpng", "-lpthread")
MIN_VERSION = 4  # v4 adds the in-memory decode of the serving path

# /proc/cpuinfo keys that name the CPU model and its instruction sets
_CPU_KEYS = {"vendor_id", "cpu family", "model", "model name", "stepping", "flags",
             "Features", "CPU implementer", "CPU architecture", "CPU variant", "CPU part"}

_lock = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_ROUTE: Optional[str] = None
_TRIED = False
_BUILD_ERROR: Optional[str] = None


class Route(NamedTuple):
    """One way to build the library: g++'s arguments before the source
    (headers) and after it (libraries)."""

    name: str
    includes: Tuple[str, ...]
    libs: Tuple[str, ...]
    hashed: bytes = b""  # what else the build depends on (the kept headers)


def _pillow_libs() -> Optional[Tuple[Path, Path]]:
    """The libjpeg (ABI 6.2, soname .so.62) and libpng16 that Pillow's
    wheel bundles, or None where Pillow links the system's."""
    try:
        import PIL
    except ImportError:
        return None
    bundle = Path(PIL.__file__).resolve().parent.parent / "pillow.libs"
    jpeg = sorted(bundle.glob("libjpeg-*.so.62*"))
    png = sorted(bundle.glob("libpng16-*.so.16*"))
    return (jpeg[0], png[0]) if jpeg and png else None


def routes() -> List[Route]:
    """The routes to try, in order: the system's, then Pillow's bundle."""
    out = [Route("system", (), LIBS)]
    bundled = _pillow_libs()
    if bundled is not None:
        jpeg, png = bundled
        headers = b"".join(f.read_bytes() for f in sorted(VENDORED_INCLUDE.glob("*.h")))
        out.append(Route("pillow", ("-I", str(VENDORED_INCLUDE)),
                         (str(jpeg), str(png), "-lpthread", f"-Wl,-rpath,{jpeg.parent}"),
                         headers))
    return out


def _host_cpu() -> bytes:
    """The first processor's model and flags from /proc/cpuinfo."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        import platform

        return platform.processor().encode()
    first = text.split("\n\n", 1)[0]
    keep = [line for line in first.splitlines()
            if line.split(":", 1)[0].strip() in _CPU_KEYS]
    return "\n".join(keep).encode()


def _route_path(route: Route) -> Path:
    """Where the library of this source, this route and this CPU lives."""
    args = " ".join(CXX_FLAGS + route.includes + route.libs).encode()
    digest = hashlib.sha256(
        SOURCE.read_bytes() + args + route.hashed + _host_cpu()).hexdigest()[:16]
    return build_dir() / f"sdnet_io-{digest}.so"


def _built() -> Optional[Tuple[Route, Path]]:
    """The first route whose library is already built here, with its path."""
    for route in routes():
        path = _route_path(route)
        if path.exists():
            return route, path
    return None


def library_path() -> Path:
    """The library in use: the first route's that is built, else where the
    first route would build it."""
    found = _built()
    return found[1] if found else _route_path(routes()[0])


def build() -> float:
    """Compile the library unless a route's is there, trying the routes in
    turn. Returns the wall seconds spent (0.0 when it was there); raises
    RuntimeError, with each route's compiler message, when the source or
    g++ is missing or no route builds."""
    if not SOURCE.is_file():
        raise RuntimeError(f"native I/O source not found: {SOURCE}")
    if _built() is not None:
        return 0.0
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native I/O library is compiled on first use")
    t0 = time.perf_counter()
    errors = []
    for route in routes():
        target = _route_path(route)
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        proc = subprocess.run([cxx, *CXX_FLAGS, *route.includes, "-o", str(tmp), str(SOURCE),
                               *route.libs], capture_output=True, text=True)
        if proc.returncode == 0:
            os.replace(tmp, target)  # atomic: no half-written library
            return time.perf_counter() - t0
        tmp.unlink(missing_ok=True)
        errors.append(f"[{route.name}] exit {proc.returncode}:\n{proc.stderr.strip()}")
    raise RuntimeError(f"g++ failed for {SOURCE} on every route:\n" + "\n".join(errors))


def _declare(lib: ctypes.CDLL) -> None:
    c_int, c_float, c_u8 = ctypes.c_int, ctypes.c_float, ctypes.c_uint8
    f_p, i_p, u8_p = (ctypes.POINTER(c_float), ctypes.POINTER(c_int),
                      ctypes.POINTER(c_u8))
    str_p = ctypes.POINTER(ctypes.c_char_p)
    signatures = {
        "sdnet_load_image": [ctypes.c_char_p, c_int, c_int, c_int, c_int,
                             f_p, f_p, f_p, i_p, i_p, c_int],
        "sdnet_load_batch": [str_p, c_int, c_int, c_int, i_p, f_p, f_p, f_p,
                             i_p, i_p, c_int, c_int],
        "sdnet_load_image_u8": [ctypes.c_char_p, c_int, c_int, c_int, c_int,
                                u8_p, i_p, i_p, c_int],
        "sdnet_load_batch_u8": [str_p, c_int, c_int, c_int, i_p, u8_p, i_p, i_p,
                                c_int, c_int],
        "sdnet_decode_mem": [u8_p, ctypes.c_long, c_int, c_int, f_p, f_p, f_p,
                             i_p, i_p, c_int],
        "sdnet_decode_mem_u8": [u8_p, ctypes.c_long, c_int, c_int, u8_p, i_p, i_p,
                                c_int],
        "sdnet_io_version": [],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = c_int


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built on the first call; None when it cannot
    be built or loaded (the reason is in `build_error()`)."""
    global _LIB, _ROUTE, _TRIED, _BUILD_ERROR
    with _lock:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            build()
            route, path = _built()
            lib = ctypes.CDLL(str(path))
            _declare(lib)
            version = lib.sdnet_io_version()
            if version < MIN_VERSION:
                raise RuntimeError(f"{path} is version {version}, below {MIN_VERSION}")
        except (RuntimeError, OSError, AttributeError) as e:
            _BUILD_ERROR = str(e)
            print(f"native I/O unavailable, decoding with PIL: {e}", file=sys.stderr,
                  flush=True)
            return None
        _LIB, _ROUTE = lib, route.name
        return lib


def available() -> bool:
    """True when the library is built and loaded (building it if need be)."""
    return _load() is not None


# JAX's name for the serving check: the library is held to version 4,
# which has the in-memory decode, so it is `available()`
supports_decode_bytes = available


def route() -> Optional[str]:
    """The route ("system" or "pillow") of the loaded library, or None."""
    return _ROUTE if _load() is not None else None


def build_error() -> Optional[str]:
    """Why the library is unavailable (the compiler's message), or None."""
    return _BUILD_ERROR


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native I/O library unavailable: {_BUILD_ERROR}")
    return lib


_MEAN = np.ascontiguousarray(IMAGENET_MEAN, np.float32)
_STD = np.ascontiguousarray(IMAGENET_STD, np.float32)
_RAW01_MEAN = np.zeros(3, np.float32)
_RAW01_STD = np.ones(3, np.float32)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _output(shape, normalize: bool, dtype) -> Tuple[np.ndarray, bool]:
    """The output buffer and whether it is uint8."""
    u8 = np.dtype(dtype) == np.uint8
    if u8 and normalize:
        raise ValueError("uint8 output is the raw pixels: pass normalize=False")
    if not u8 and np.dtype(dtype) != np.float32:
        raise ValueError(f"dtype must be float32 or uint8, not {np.dtype(dtype)}")
    return np.empty(shape, np.uint8 if u8 else np.float32), u8


def _mean_std(normalize: bool):
    mean, std = (_MEAN, _STD) if normalize else (_RAW01_MEAN, _RAW01_STD)
    return _ptr(mean, ctypes.c_float), _ptr(std, ctypes.c_float)


def load_image(
    path, out_w: int, out_h: int, hflip: bool = False, vflip: bool = False,
    normalize: bool = True, exact: bool = True, dtype=np.float32,
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """Decode and resize one image file -> ((out_h, out_w, 3), original
    (w, h)). `normalize` applies ImageNet mean/std to [0, 1] float32;
    without it the output is raw [0, 1] (the feed of the device
    augmentation). `dtype=np.uint8` gives the resized pixels as they are
    (the uint8 feed; needs normalize=False). `exact`: see the module."""
    lib = _lib()
    out, u8 = _output((out_h, out_w, 3), normalize, dtype)
    ow, oh = ctypes.c_int(0), ctypes.c_int(0)
    if u8:
        ok = lib.sdnet_load_image_u8(
            os.fsencode(path), out_w, out_h, int(hflip), int(vflip),
            _ptr(out, ctypes.c_uint8), ctypes.byref(ow), ctypes.byref(oh), int(exact))
    else:
        ok = lib.sdnet_load_image(
            os.fsencode(path), out_w, out_h, int(hflip), int(vflip),
            *_mean_std(normalize), _ptr(out, ctypes.c_float),
            ctypes.byref(ow), ctypes.byref(oh), int(exact))
    if not ok:
        raise IOError(f"native decode failed for {path}")
    return out, (ow.value, oh.value)


def decode_bytes(
    data: bytes, out_w: int, out_h: int,
    normalize: bool = True, exact: bool = True, dtype=np.float32,
) -> Tuple[np.ndarray, Tuple[int, int]]:
    """In-memory decode and resize of a JPEG or PNG payload (the serving
    request path) -> ((out_h, out_w, 3), original (w, h)); the format is
    sniffed from the magic bytes. Same `normalize`/`exact`/`dtype` as
    `load_image`. A truncated or garbage payload raises IOError."""
    lib = _lib()
    out, u8 = _output((out_h, out_w, 3), normalize, dtype)
    buf = np.frombuffer(data, np.uint8)
    ow, oh = ctypes.c_int(0), ctypes.c_int(0)
    if u8:
        ok = lib.sdnet_decode_mem_u8(
            _ptr(buf, ctypes.c_uint8), len(data), out_w, out_h,
            _ptr(out, ctypes.c_uint8), ctypes.byref(ow), ctypes.byref(oh), int(exact))
    else:
        ok = lib.sdnet_decode_mem(
            _ptr(buf, ctypes.c_uint8), len(data), out_w, out_h,
            *_mean_std(normalize), _ptr(out, ctypes.c_float),
            ctypes.byref(ow), ctypes.byref(oh), int(exact))
    if not ok:
        raise IOError(f"native decode failed for an in-memory payload of {len(data)} bytes")
    return out, (ow.value, oh.value)


def load_batch(
    paths: Sequence, out_w: int, out_h: int,
    flips: Optional[np.ndarray] = None, n_threads: int = 4,
    normalize: bool = True, exact: bool = True, dtype=np.float32,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode a batch on `n_threads` C++ threads -> ((N, out_h, out_w, 3),
    original sizes (N, 2) int32 as (w, h), ok flags (N,) bool). `flips`
    is (N, 2) (hflip, vflip) or None. Same `normalize`/`exact`/`dtype`
    as `load_image`; a file that fails to decode has ok False."""
    lib = _lib()
    n = len(paths)
    out, u8 = _output((n, out_h, out_w, 3), normalize, dtype)
    orig = np.zeros((n, 2), np.int32)
    ok = np.zeros((n,), np.int32)
    flips_arr = (np.zeros((n, 2), np.int32) if flips is None
                 else np.ascontiguousarray(flips, np.int32))
    if flips_arr.shape != (n, 2):
        raise ValueError(f"flips must be ({n}, 2), not {flips_arr.shape}")
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    common = (c_paths, n, out_w, out_h, _ptr(flips_arr, ctypes.c_int))
    tail = (_ptr(orig, ctypes.c_int), _ptr(ok, ctypes.c_int), n_threads, int(exact))
    if u8:
        lib.sdnet_load_batch_u8(*common, _ptr(out, ctypes.c_uint8), *tail)
    else:
        lib.sdnet_load_batch(*common, *_mean_std(normalize), _ptr(out, ctypes.c_float),
                             *tail)
    return out, orig, ok.astype(bool)
