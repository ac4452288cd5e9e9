"""Build the hand-written CUDA kernels with ``nvcc`` and load them.

Each source ``csrc/<name>.cu`` is compiled for Hopper (``sm_90a``) into
its own shared library with a plain C interface, loaded with ``ctypes``;
the headers of ``csrc/`` (``*.cuh``) are on its include path. The
library's file name carries a hash of its source, the headers and the
flags, so an edited source or header is rebuilt and a stale library is
never loaded. Builds go
to ``dist_tpu_torch/_build/`` (listed in ``.gitignore``); nothing is
built at import time, only when a kernel is first launched or when
:func:`build` is called.
"""

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "dist_tpu_torch/csrc at first use and need the CUDA "
                       "toolkit")


def nvcc_command(src, out):
    """nvcc's argument list that compiles ``src`` into the library
    ``out``, with ``csrc/`` on the include path."""
    return [_nvcc(), *NVCC_FLAGS, "-I", SRC_DIR, "-o", out, src]


def _target(name):
    src = os.path.join(SRC_DIR, f"{name}.cu")
    h = hashlib.sha1()
    for path in [src] + sorted(glob.glob(os.path.join(SRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:12]}.so")


def build(names):
    """Compile the named sources that are not built yet, one ``nvcc``
    process each, all started together; nvcc's output goes to
    ``_build/<name>.log``. Raises with the log's end if one fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        src, so = _target(name)
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as log:
            procs[name] = (subprocess.Popen(
                nvcc_command(src, tmp),
                stdout=log, stderr=subprocess.STDOUT), tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        if proc.wait() == 0:
            os.replace(tmp, so)
        else:
            failed.append(f"--- {name}.cu ---\n{build_log(name)[-4000:]}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build_log(name):
    """nvcc's output for the last build of ``name`` (register and shared
    memory use from ``-Xptxas=-v``), or '' if it was not built here."""
    path = os.path.join(BUILD_DIR, f"{name}.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def ptxas_usage(name):
    """{entry function (mangled): {"registers", "spill_stores",
    "spill_loads"}} from ``-Xptxas=-v`` in the last build's log of
    ``name``; {} if it was not built here."""
    return parse_ptxas(build_log(name))


def parse_ptxas(log):
    """:func:`ptxas_usage` of the text of an nvcc log."""
    usage, cur = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = usage.setdefault(m.group(1), {})
            continue
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            cur = usage.get(m.group(1))     # None for a device function
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m[1]), int(m[2])
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m[1])
    return usage


def load(name, signatures):
    """The ctypes library for ``csrc/<name>.cu``, built if needed.

    ``signatures``: {symbol: [argtypes]}; a symbol ending in
    ``_error_string`` returns a C string, every other one a C int (a
    ``cudaError_t``)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_target(name)[1])
            for sym, argtypes in signatures.items():
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = (ctypes.c_char_p if sym.endswith("_error_string")
                              else ctypes.c_int)
            _libs[name] = lib
        return lib


def check(lib, error_string, err, what):
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        msg = getattr(lib, error_string)(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
