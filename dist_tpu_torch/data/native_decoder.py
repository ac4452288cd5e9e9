"""ctypes binding of the repository's C++ video decoder
(``native/videodec.cpp``; port of ``dist_tpu/data/native_decoder.py``).

Clip-seek frame decode through libavformat/libavcodec into preallocated
numpy buffers, with an optional fused resize, and a batch call that
decodes many clips on a C++ thread pool without the interpreter lock.

The library is built at first use with the flags and libraries of
``native/Makefile`` into ``dist_tpu_torch/_build/`` (the port never writes
into ``native/``). The JAX package falls back to OpenCV where it does not
build; the port has no such fallback (the card's machine has no OpenCV):
:func:`get_lib` raises and says why, and :func:`status` reports it.
"""

import ctypes
import functools
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(os.path.dirname(_PKG), "native", "videodec.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
# native/Makefile: CXXFLAGS, REQUIRED_FLAGS and LIBS
CXX_FLAGS = ("-O3", "-Wall", "-fPIC", "-shared", "-std=c++17")
LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale", "-lpthread")
BUILD_TIMEOUT_S = 120

_lock = threading.Lock()
_lib = None
_error = None


def _target(src=SRC):
    h = hashlib.sha1()
    with open(src, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:12]}.so")


def build_shared(src=SRC):
    """Compile the C++ source ``src`` against FFmpeg's libraries (the
    decoder's flags) into ``_build/`` if it is not built yet; returns the
    library's path. Raises RuntimeError, saying why, where it does not
    build."""
    if not os.path.exists(src):
        raise RuntimeError(f"{src} not found")
    so = _target(src)
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cxx = os.environ.get("CXX", "g++")
    try:
        out = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, src, *LIBS],
                             capture_output=True, text=True,
                             timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"{cxx} could not build {src}: {e}") from e
    if out.returncode != 0:
        log = (out.stderr or out.stdout).strip()
        first = next((ln for ln in log.splitlines() if "error" in ln),
                     log[-600:])
        raise RuntimeError(f"{cxx} failed on {src}: {first.strip()}")
    os.replace(tmp, so)
    return so


def _bind(path):
    lib = ctypes.CDLL(path)
    lib.dist_video_probe.restype = ctypes.c_int
    lib.dist_video_probe.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.dist_video_decode.restype = ctypes.c_int
    lib.dist_video_decode.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int]
    lib.dist_video_decode_batch.restype = ctypes.c_int
    lib.dist_video_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    return lib


def get_lib():
    """The bound library, built on the first call. Raises RuntimeError
    with the reason when it does not build or load (and again on every
    later call, without retrying the build)."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                _lib = _bind(build_shared())
            except (RuntimeError, OSError) as e:
                _error = str(e)
        if _lib is None:
            raise RuntimeError(f"native video decoder unavailable: {_error}")
        return _lib


def available():
    return status() == "native"


def status():
    """``"native"``, or ``"unavailable: <reason>"``."""
    try:
        get_lib()
    except RuntimeError:
        return f"unavailable: {_error}"
    return "native"


@functools.lru_cache(maxsize=65536)
def probe(path):
    """(num_frames, fps, w, h) via libavformat. Cached per path: dataset
    videos are immutable, and the sampler and a native-resolution
    decode() would otherwise open the container twice per sample."""
    lib = get_lib()
    n = ctypes.c_int64()
    fps = ctypes.c_double()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.dist_video_probe(path.encode(), ctypes.byref(n),
                              ctypes.byref(fps), ctypes.byref(w),
                              ctypes.byref(h))
    if rc != 0:
        raise IOError(f"native probe failed ({rc}) for {path}")
    return int(n.value), float(fps.value), int(w.value), int(h.value)


def decode(path, indices, out_h=0, out_w=0):
    """Decode frame ``indices`` -> (T, H, W, 3) uint8 RGB. out_h/out_w of 0
    keep the native resolution; otherwise the resize fuses into the decode."""
    lib = get_lib()
    indices = np.ascontiguousarray(indices, np.int64)
    if out_h <= 0 or out_w <= 0:
        _, _, w, h = probe(path)
        out_h, out_w = h, w
    out = np.empty((len(indices), out_h, out_w, 3), np.uint8)
    rc = lib.dist_video_decode(
        path.encode(), indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(indices), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out_h, out_w)
    if rc != 0:
        raise IOError(f"native decode failed ({rc}) for {path}")
    return out


def decode_batch(paths, indices_list, out_h, out_w, num_threads=8):
    """Decode many clips concurrently in C++ (no GIL). Returns a list of
    (T_i, out_h, out_w, 3) uint8 arrays."""
    lib = get_lib()
    n = len(paths)
    offsets = np.zeros(n + 1, np.int64)
    for i, idx in enumerate(indices_list):
        offsets[i + 1] = offsets[i] + len(idx)
    flat = np.ascontiguousarray(np.concatenate(indices_list), np.int64)
    out = np.empty((int(offsets[-1]), out_h, out_w, 3), np.uint8)
    statuses = np.zeros(n, np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.dist_video_decode_batch(
        c_paths, flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out_h, out_w,
        num_threads, statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    if rc != 0:
        bad = [paths[i] for i in range(n) if statuses[i] != 0]
        raise IOError(f"native batch decode failed for {bad[:3]}")
    return [out[offsets[i]:offsets[i + 1]] for i in range(n)]
