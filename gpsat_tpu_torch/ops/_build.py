"""Build and load the CUDA kernels of gpsat_tpu_torch/csrc at first use.

Each ``csrc/*.cu`` compiles with ``nvcc`` for ``sm_90a`` into an object of
its own, all compilers started together, and the objects link into
``build/gpsat_tpu_torch/libgpkernels.so`` under the repository root. The
library has a plain C interface and is loaded with ``ctypes``; nothing here
includes PyTorch's headers. A SHA-256 of the sources and flags, kept beside
the library, decides whether an existing build is reused.

Nothing is built or loaded when this module is imported.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

from gpsat_tpu_torch import get_parent_path, get_path

__all__ = ["build", "load_library", "check", "BUILD_DIR"]

BUILD_DIR = get_parent_path("build", "gpsat_tpu_torch")
_CSRC = get_path("csrc")
_LIB = "libgpkernels.so"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # xt, yt, p, out, ws, B, Np, D, kernel_id, stream
    "gp_vg_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # xt, yt, p, xs, mean, var, ws, B, Np, Pp, D, kernel_id, stream
    "gp_predict_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _P],
}


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.isfile(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def _sources():
    names = sorted(os.listdir(_CSRC))
    return ([os.path.join(_CSRC, n) for n in names if n.endswith(".cu")],
            [os.path.join(_CSRC, n) for n in names if n.endswith(".cuh")])


def _digest(paths):
    h = hashlib.sha256(" ".join(_ARCH + _FLAGS).encode())
    for path in paths:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def build(force=False):
    """Compile csrc/*.cu into BUILD_DIR/libgpkernels.so unless an up-to-date
    build exists. Returns (path, seconds spent, compiler output)."""
    cu, cuh = _sources()
    digest = _digest(cu + cuh)
    lib = os.path.join(BUILD_DIR, _LIB)
    stamp = lib + ".sha256"
    if not force and os.path.isfile(lib) and os.path.isfile(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                return lib, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in cu:
        obj = os.path.join(BUILD_DIR, os.path.basename(src)[:-3] + ".o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *_ARCH, *_FLAGS, "-I", _CSRC, "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    log = []
    failed = []
    for src, proc in zip(cu, procs):
        text, _ = proc.communicate()
        log.append(f"== {os.path.basename(src)}\n{text}")
        if proc.returncode != 0:
            failed.append(os.path.basename(src))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = f"{lib}.{os.getpid()}.tmp"
    link = subprocess.run([nvcc, *_ARCH, "-shared", "-o", tmp, *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking {_LIB} failed:\n{link.stdout}")
    os.replace(tmp, lib)
    with open(stamp, "w") as f:
        f.write(digest)
    return lib, time.perf_counter() - t0, "\n".join(log)


@functools.lru_cache(maxsize=None)
def load_library():
    """Build if needed, load with ctypes and declare every entry point."""
    path, _, _ = build()
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.gp_error_string.argtypes = [ctypes.c_int]
    lib.gp_error_string.restype = ctypes.c_char_p
    return lib


def check(lib, code, what):
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.gp_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
