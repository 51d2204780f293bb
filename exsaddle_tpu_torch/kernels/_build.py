"""Build and load the port's CUDA kernels.

Every `*.cu` file under exsaddle_tpu_torch/csrc/ is compiled by nvcc into ONE
shared library with a plain C interface (no PyTorch headers, so a build takes
seconds), loaded with ctypes: one nvcc per source, all started together,
then one link. The library is built at first use into
exsaddle_tpu_torch/_build/ (listed in .gitignore) under a name that carries
the hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is reused. Nothing here runs at import time: the CPU tests
import every module of the port on machines without nvcc.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# sm_90a keeps wgmma/setmaxnreg available to later kernels; -Xptxas -v
# records registers, shared memory and spills of every kernel in build.log
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None


def _nvcc():
    path = shutil.which("nvcc")
    if path is None:
        cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc")
        if os.path.exists(cand):
            path = cand
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "exsaddle_tpu_torch need the CUDA toolkit")
    return path


def _sources():
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    hdrs = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs, hdrs


def library_path():
    """Path of the library the current sources and flags build to."""
    srcs, hdrs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in srcs + hdrs:
        h.update(os.path.basename(f).encode())
        with open(f, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR,
                        f"libexsaddle_kernels-{h.hexdigest()[:16]}.so")


def build():
    """Compile the kernels if the library for the current sources is
    missing. Returns (path, built_now, log)."""
    out = library_path()
    log_path = out[:-3] + ".log"
    if os.path.exists(out):
        log = open(log_path).read() if os.path.exists(log_path) else ""
        return out, False, log
    os.makedirs(BUILD_DIR, exist_ok=True)
    srcs, _ = _sources()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        jobs = []
        for src in srcs:
            obj = os.path.join(tmpdir, os.path.basename(src) + ".o")
            cmd = [nvcc] + NVCC_FLAGS + ["-c", "-o", obj, src]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = "", []
        for cmd, _, proc in jobs:
            log += " ".join(cmd) + "\n" + proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(proc.returncode)
        if failed:
            raise RuntimeError(f"nvcc failed ({failed}):\n{log}")
        tmp = os.path.join(tmpdir, "lib.so")
        cmd = [nvcc, "-shared", "-o", tmp] + [obj for _, obj, _ in jobs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log += " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{log}")
        with open(log_path, "w") as fh:
            fh.write(log)
        os.replace(tmp, out)
    return out, True, log


def load():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            path, _, _ = build()
            _lib = ctypes.CDLL(path)
        return _lib


class Launches:
    """Device launches (`n`) that a wrapper sent to its kernel; calls of
    the plain version are not counted. Inside a CUDA graph capture the
    wrapper records a launch that the graph repeats: graphs.Captured and
    graphs.ControlGraph take the capture's launches back out and add them
    per replay or per counted execution."""

    def __init__(self):
        self.n = 0

    def reset(self):
        self.n = 0


def error_string(lib, err):
    """The CUDA error name of a wrapper's nonzero return code."""
    lib.a00_error_string.argtypes = [ctypes.c_int]
    lib.a00_error_string.restype = ctypes.c_char_p
    return f"{lib.a00_error_string(err).decode()} ({err})"
