"""Native C++ host ops (OpenMP), loaded through ctypes (copy of
gpsat_tpu/native).

Replaces the reference's numba-JIT host kernels (prediction-location radius
culling, Gaussian field smoothing) with compiled equivalents. The library is
built with g++ at first use into ``build/gpsat_tpu_torch/libhostops.so``
under the repository root (or by ``python -m gpsat_tpu_torch.native.build``),
never into a package directory. Falls back to numpy implementations when it
cannot be built or loaded.
"""

import ctypes
import os
import subprocess
import tempfile
import warnings

import numpy as np

from gpsat_tpu_torch import get_parent_path, get_path

BUILD_DIR = get_parent_path("build", "gpsat_tpu_torch")
_SRC = get_path("native", "hostops.cpp")
_SO_PATH = os.path.join(BUILD_DIR, "libhostops.so")
_LIB = None
_TRIED = False


def build(verbose=False):
    """Compile the shared library with g++ -O3 -fopenmp. The library is
    written beside its final name and renamed over it, so processes that
    build at once never load a half-written file."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-fopenmp",
           _SRC, "-o", tmp]
    if verbose:
        print(" ".join(cmd))
    try:
        subprocess.check_call(cmd)
        os.replace(tmp, _SO_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return _SO_PATH


# importing the CLI module gpsat_tpu_torch.native.build rebinds the package
# attribute `build` to that module; the loader keeps the function
_compile = build


def _load():
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        if not os.path.exists(_SO_PATH) or (
                os.path.getmtime(_SO_PATH) < os.path.getmtime(_SRC)):
            _compile()
        lib = ctypes.CDLL(_SO_PATH)
        dp = ctypes.POINTER(ctypes.c_double)
        lib.max_dist_bool.argtypes = [dp, dp, ctypes.c_double,
                                      ctypes.c_int64, ctypes.c_int64,
                                      ctypes.POINTER(ctypes.c_uint8)]
        lib.gaussian_2d_weight.argtypes = [dp, dp, ctypes.c_int64, dp, dp,
                                           dp, ctypes.c_int64,
                                           ctypes.c_double, ctypes.c_double,
                                           dp]
        lib.weighted_merge_accumulate.argtypes = [
            ctypes.POINTER(ctypes.c_int64), dp, dp, ctypes.c_int64,
            ctypes.c_double, ctypes.c_int64, dp, dp]
        _LIB = lib
    except Exception as e:  # pragma: no cover - toolchain dependent
        warnings.warn(f"native hostops unavailable ({e}); using numpy fallback")
        _LIB = None
    return _LIB


def _cptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def max_dist_bool(locs, ref_loc, max_dist):
    """Rows of locs [n, d] within euclidean max_dist of ref_loc [d] -> bool[n]."""
    lib = _load()
    locs = np.ascontiguousarray(locs, dtype=np.float64)
    ref = np.ascontiguousarray(np.asarray(ref_loc, dtype=np.float64).reshape(-1))
    n, d = locs.shape
    if lib is None:
        from gpsat_tpu_torch.prediction_locations import \
            max_dist_bool as np_fallback
        return np_fallback(locs, ref, max_dist, use_native=False)
    out = np.empty(n, dtype=np.uint8)
    lib.max_dist_bool(_cptr(locs), _cptr(ref), float(max_dist), n, d,
                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.astype(bool)


def gaussian_2d_weight(x0, y0, x, y, l_x, l_y, vals):
    """Host-side Gaussian smoother (NaN-skipping); see postprocessing for the
    device-side variant."""
    lib = _load()
    x0 = np.ascontiguousarray(x0, dtype=np.float64)
    y0 = np.ascontiguousarray(y0, dtype=np.float64)
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    if lib is None:
        from gpsat_tpu_torch.postprocessing import gaussian_2d_smooth
        return gaussian_2d_smooth(x0, y0, x, y, l_x, l_y, vals, device="cpu")
    out = np.empty(len(x0), dtype=np.float64)
    lib.gaussian_2d_weight(_cptr(x0), _cptr(y0), len(x0), _cptr(x), _cptr(y),
                           _cptr(vals), len(x), float(l_x), float(l_y),
                           _cptr(out))
    return out


def weighted_merge_accumulate(group, d2, v, lengthscale, n_groups):
    """Per-group Gaussian-weight accumulators (sum_w, sum_wv)."""
    lib = _load()
    group = np.ascontiguousarray(group, dtype=np.int64)
    d2 = np.ascontiguousarray(d2, dtype=np.float64)
    v = np.ascontiguousarray(v, dtype=np.float64)
    if lib is None:
        w = np.exp(-d2 / (2 * lengthscale**2))
        sum_w = np.bincount(group, weights=w, minlength=n_groups)
        sum_wv = np.bincount(group, weights=w * v, minlength=n_groups)
        return sum_w, sum_wv
    sum_w = np.empty(n_groups, dtype=np.float64)
    sum_wv = np.empty(n_groups, dtype=np.float64)
    lib.weighted_merge_accumulate(
        group.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), _cptr(d2),
        _cptr(v), len(group), 1.0 / (2 * lengthscale**2), n_groups,
        _cptr(sum_w), _cptr(sum_wv))
    return sum_w, sum_wv
