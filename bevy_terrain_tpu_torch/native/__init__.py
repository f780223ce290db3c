"""ctypes bindings for the native terrain runtime (terrain_runtime.cpp).

The C++ library implements the residency state machine and the async tile
file loader — the parts the reference writes in Rust (tile_atlas.rs) — and
the host prologue's per-frame loops: the request scan and view anchors, the
Taylor chain, the single-tap bilinear sample, and the preprocess host
path's split, quantize and downsample. The Python implementations in
terrain_data/, math/ and ops/ remain as the fallback and as the oracles the
native backend is tested against.

The library is built from ``terrain_runtime.cpp`` at first use, with ``g++``
(or ``$CXX``) and :data:`CXXFLAGS`, into ``build/native/`` at the root of the
checkout, under a name keyed by a hash of the compiler and its version,
the flags and the source. A build or load that fails raises with the
compiler's message: no caller falls back to the Python paths unless asked, by
``BT_DISABLE_NATIVE=1`` (every optional native branch) or
``TileAtlasState(use_native=False)`` (the residency machine).

Every entry point counts its calls in ``.calls`` (:func:`counts`,
:func:`reset_counts`), so a run can show that the native code ran.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import platform
import shlex
import subprocess
import time
from pathlib import Path
import numpy as np

_DIR = Path(__file__).resolve().parent
_SOURCE = _DIR / "terrain_runtime.cpp"
_BUILD_DIR = _DIR.parents[1] / "build" / "native"
# -ffp-contract=off keeps the f64 chains bit-identical to the numpy oracles
# (no fused multiply-adds); x86-64-v3 is AVX2 (Haswell, 2013, and later)
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-ffp-contract=off"] + (
    ["-march=x86-64-v3"] if platform.machine() == "x86_64" else [])
_lib = None
# how the loaded library was obtained: its path, the sha256 of the compiler,
# flags and source, the compiler, its version line, the flags, and the
# seconds its load spent in build_library (compiling, or waiting for another
# process's build)
build_info: dict = {}

_COUNTED: dict = {}


def _counted(fn):
    """Count the calls of entry point ``fn`` in ``fn.calls``."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        wrapper.calls += 1
        return fn(*args, **kwargs)

    wrapper.calls = 0
    _COUNTED[fn.__qualname__] = wrapper
    return wrapper


def counts() -> dict:
    """Calls of every native entry point since the last :func:`reset_counts`."""
    return {name: w.calls for name, w in _COUNTED.items()}


def reset_counts() -> None:
    for w in _COUNTED.values():
        w.calls = 0


def _compiler() -> list:
    return shlex.split(os.environ.get("CXX") or "g++")


@functools.lru_cache(maxsize=None)
def _compiler_version(cxx: tuple) -> str:
    """The first line of ``<cxx> --version`` ('' when it prints none or
    cannot run: the build then raises with the compiler's message)."""
    try:
        out = subprocess.run([*cxx, "--version"], capture_output=True, text=True,
                             timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.splitlines()[0] if out else ""


def _digest(cxx: list) -> str:
    """sha256 of the compiler (its name and version), the flags and the source."""
    h = hashlib.sha256(" ".join(cxx + CXXFLAGS).encode())
    h.update(_compiler_version(tuple(cxx)).encode())
    h.update(_SOURCE.read_bytes())
    return h.hexdigest()


def build_library() -> Path:
    """Compile ``terrain_runtime.cpp`` into
    ``build/native/libterrain_runtime_<hash>.so`` unless a library built
    by the same compiler (and version), flags and source is already
    there. A file lock serialises concurrent first builds (test workers);
    the library is written under a temporary name and renamed into place. Raises
    RuntimeError with the compiler's output when the build fails."""
    cxx = _compiler()
    out = _BUILD_DIR / f"libterrain_runtime_{_digest(cxx)[:16]}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / f"{out.stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():  # built by another process while this one waited
            return out
        tmp = _BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp"
        try:
            proc = subprocess.run(
                [*cxx, *CXXFLAGS, "-shared", "-o", str(tmp), str(_SOURCE), "-lpthread"],
                capture_output=True, text=True, timeout=300)
        except OSError as e:
            raise RuntimeError(f"native runtime: cannot run {' '.join(cxx)}: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"native runtime: {' '.join(cxx)} failed ({proc.returncode}) on "
                f"{_SOURCE.name}:\n{proc.stderr}{proc.stdout}")
        os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    t0 = time.perf_counter()
    path = build_library()
    cxx = _compiler()
    build_info.update(path=str(path), hash=_digest(cxx), cxx=" ".join(cxx),
                      version=_compiler_version(tuple(cxx)), flags=" ".join(CXXFLAGS),
                      seconds=time.perf_counter() - t0)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"native runtime: cannot load {path}: {e}") from e

    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.tr_residency_create.restype = ctypes.c_void_p
    lib.tr_residency_create.argtypes = [ctypes.c_int32, ctypes.c_int32]
    lib.tr_residency_destroy.argtypes = [ctypes.c_void_p]
    lib.tr_add_existing.argtypes = [ctypes.c_void_p, i64p, ctypes.c_int64]
    lib.tr_clear_existing.argtypes = [ctypes.c_void_p]
    lib.tr_existing_count.restype = ctypes.c_int64
    lib.tr_existing_count.argtypes = [ctypes.c_void_p]
    lib.tr_request.restype = ctypes.c_int32
    lib.tr_request.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.tr_release.restype = ctypes.c_int32
    lib.tr_release.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.tr_release_underflows.restype = ctypes.c_int64
    lib.tr_release_underflows.argtypes = [ctypes.c_void_p]
    lib.tr_loaded.restype = ctypes.c_int32
    lib.tr_loaded.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.tr_get_or_allocate.restype = ctypes.c_int32
    lib.tr_get_or_allocate.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.tr_drain_loads.restype = ctypes.c_int64
    lib.tr_drain_loads.argtypes = [ctypes.c_void_p, i64p, i32p, i32p, ctypes.c_int64]
    lib.tr_best_tiles.argtypes = [
        ctypes.c_void_p, i32p, i32p, i32p, i32p, ctypes.c_int64, i32p, i32p,
    ]
    lib.tr_requests_of.restype = ctypes.c_int32
    lib.tr_requests_of.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.tr_index_of.restype = ctypes.c_int32
    lib.tr_index_of.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.tr_resident_count.restype = ctypes.c_int64
    lib.tr_resident_count.argtypes = [ctypes.c_void_p]
    lib.tr_io_create.restype = ctypes.c_void_p
    lib.tr_io_create.argtypes = [ctypes.c_int32]
    lib.tr_io_destroy.argtypes = [ctypes.c_void_p]
    lib.tr_io_submit.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ]
    lib.tr_io_poll.restype = ctypes.c_int64
    lib.tr_io_poll.argtypes = [ctypes.c_void_p, i64p, i64p, ctypes.c_int64]
    f64p = ctypes.POINTER(ctypes.c_double)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.tr_scan_requests.argtypes = [
        ctypes.c_int32, f64p, f64p, f64p, ctypes.c_double, ctypes.c_double,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, f64p, i64p, u8p, i64p, i64p, i32p, i32p,
    ]
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.tr_taylor_spherical.argtypes = [
        f64p, f64p, f64p, ctypes.c_double, i32p, f32p, f32p,
    ]
    lib.tr_taylor_from_world.argtypes = [
        f64p, f64p, f64p, ctypes.c_double, i32p, f32p, f32p,
    ]
    lib.tr_project_view_uv.argtypes = [f64p, f64p, f64p]
    lib.tr_view_anchors.argtypes = [
        f64p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, f32p,
    ]
    lib.tr_sample_bilinear.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, f64p,
    ]
    lib.tr_split_bilinear.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        f64p, ctypes.c_int64, f64p, ctypes.c_int64, f32p,
    ]
    lib.tr_quantize.argtypes = [
        f32p, ctypes.c_int64, ctypes.c_double, ctypes.c_int32,
        ctypes.c_void_p,
    ]
    lib.tr_downsample.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p,
    ]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the optional native branches run: False only when
    ``BT_DISABLE_NATIVE=1`` asks for the Python paths. Otherwise the
    library is built and loaded (raising if it cannot) and this is True."""
    if os.environ.get("BT_DISABLE_NATIVE") == "1":
        return False
    _load()
    return True


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _f64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _out_array(a: np.ndarray, dtypes, name: str) -> None:
    """Raise unless ``a``, which C++ writes in place, is C-contiguous and of
    one of ``dtypes``."""
    if a.dtype not in [np.dtype(d) for d in dtypes] or not a.flags.c_contiguous:
        raise ValueError(f"{name} must be a C-contiguous {'/'.join(map(str, dtypes))} "
                         f"array, got {a.dtype} (contiguous: {a.flags.c_contiguous})")


@_counted
def scan_requests(kind: int, m: np.ndarray, inv_m3: np.ndarray,
                  view: np.ndarray, approx_height: float, load_distance: float,
                  origins: np.ndarray, view_int: np.ndarray,
                  view_frac: np.ndarray, tile_xy: np.ndarray,
                  requested: np.ndarray):
    """Native per-frame request scan (terrain_runtime.cpp tr_scan_requests).

    Mutates ``tile_xy`` (S,L,T,T,2 i64, C-contiguous) and ``requested``
    (S,L,T,T bool or u8, C-contiguous) in place; returns (released_keys,
    requested_keys) packed int64 arrays. Semantics identical to the numpy
    scan — fuzz-tested in test_torch_native.py.
    """
    lib = _load()
    _out_array(tile_xy, (np.int64,), "tile_xy")
    _out_array(requested, (np.bool_, np.uint8), "requested")
    S, L, T = tile_xy.shape[0], tile_xy.shape[1], tile_xy.shape[2]
    cap = S * L * T * T
    released = np.empty(cap, np.int64)
    requested_keys = np.empty(cap, np.int64)
    n_rel = np.zeros(1, np.int32)
    n_req = np.zeros(1, np.int32)
    lib.tr_scan_requests(
        kind, _f64p(m), _f64p(inv_m3), _f64p(view),
        float(approx_height), float(load_distance),
        S, L, T,
        _i32p(origins), _i32p(view_int), _f64p(view_frac),
        _i64p(tile_xy), requested.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _i64p(released), _i64p(requested_keys), _i32p(n_rel), _i32p(n_req),
    )
    return released[: n_rel[0]], requested_keys[: n_req[0]]


class NativeResidency:
    """C++ residency state machine (see terrain_runtime.cpp)."""

    def __init__(self, atlas_size: int, attachment_count: int):
        lib = _load()
        self._lib = lib
        self._h = lib.tr_residency_create(atlas_size, attachment_count)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.tr_residency_destroy(self._h)
            self._h = None

    @_counted
    def add_existing(self, keys: np.ndarray) -> None:
        keys = np.ascontiguousarray(keys, np.int64)
        self._lib.tr_add_existing(self._h, _i64p(keys), len(keys))

    def clear_existing(self) -> None:
        self._lib.tr_clear_existing(self._h)

    @property
    def existing_count(self) -> int:
        return self._lib.tr_existing_count(self._h)

    @_counted
    def request(self, key: int) -> int:
        result = self._lib.tr_request(self._h, key)
        if result == -3:
            raise RuntimeError("Atlas out of indices")
        return result

    @_counted
    def release(self, key: int) -> None:
        result = self._lib.tr_release(self._h, key)
        if result == -1:
            raise RuntimeError("Tried releasing a tile, which is not present.")
        # -2 == over-release of a cached tile: guarded + counted in C++
        # (release_underflows), mirroring the Python backend

    @property
    def release_underflows(self) -> int:
        return self._lib.tr_release_underflows(self._h)

    @_counted
    def loaded(self, key: int) -> None:
        if self._lib.tr_loaded(self._h, key) != 0:
            raise RuntimeError(
                "Loaded more attachments than registered with the tile atlas."
            )

    @_counted
    def get_or_allocate(self, key: int) -> int:
        result = self._lib.tr_get_or_allocate(self._h, key)
        if result == -3:
            raise RuntimeError("Atlas out of indices")
        return result

    @_counted
    def drain_loads(self, cap: int = 4096):
        keys = np.empty(cap, np.int64)
        indices = np.empty(cap, np.int32)
        attachments = np.empty(cap, np.int32)
        n = self._lib.tr_drain_loads(
            self._h, _i64p(keys), _i32p(indices), _i32p(attachments), cap
        )
        return keys[:n], indices[:n], attachments[:n]

    @_counted
    def best_tiles(self, side, lod, x, y):
        side = np.ascontiguousarray(side, np.int32).ravel()
        lod = np.ascontiguousarray(lod, np.int32).ravel()
        x = np.ascontiguousarray(x, np.int32).ravel()
        y = np.ascontiguousarray(y, np.int32).ravel()
        out_index = np.empty(side.shape, np.int32)
        out_lod = np.empty(side.shape, np.int32)
        self._lib.tr_best_tiles(
            self._h, _i32p(side), _i32p(lod), _i32p(x), _i32p(y),
            len(side), _i32p(out_index), _i32p(out_lod),
        )
        return out_index, out_lod

    def requests_of(self, key: int) -> int:
        return self._lib.tr_requests_of(self._h, key)

    def index_of(self, key: int) -> int:
        return self._lib.tr_index_of(self._h, key)

    @property
    def resident_count(self) -> int:
        return self._lib.tr_resident_count(self._h)


class NativeIoPool:
    """C++ async file reader pool (see terrain_runtime.cpp IoPool)."""

    def __init__(self, threads: int = 8):
        lib = _load()
        self._lib = lib
        self._h = lib.tr_io_create(threads)
        self._buffers: dict[int, np.ndarray] = {}
        self._next = 0

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.tr_io_destroy(self._h)
            self._h = None

    @_counted
    def submit(self, path: str, capacity: int) -> int:
        job_id = self._next
        self._next += 1
        buf = np.empty(capacity, np.uint8)
        self._buffers[job_id] = buf  # held until poll hands it back
        self._lib.tr_io_submit(
            self._h, job_id, str(path).encode(),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), capacity,
        )
        return job_id

    @_counted
    def poll(self, cap: int = 256):
        """Returns list of (job_id, bytes_or_None_on_error, buffer)."""
        ids = np.empty(cap, np.int64)
        sizes = np.empty(cap, np.int64)
        n = self._lib.tr_io_poll(self._h, _i64p(ids), _i64p(sizes), cap)
        out = []
        for i in range(n):
            job_id = int(ids[i])
            buf = self._buffers.pop(job_id)
            size = int(sizes[i])
            out.append((job_id, None if size < 0 else size, buf))
        return out


_DTYPE_CODES = {np.dtype(np.uint8): 0, np.dtype(np.uint16): 1,
                np.dtype(np.float32): 2}


@_counted
def taylor_spherical(uv: np.ndarray, view: np.ndarray, m3x4: np.ndarray,
                     origin_count: float):
    """Native per-view Taylor chain (terrain_runtime.cpp tr_taylor_spherical).

    ``uv`` (6, 2) f64 view uv projected onto every side. Returns
    (origin_xy (6,2) i32, origin_uv (6,2) f32, coeffs (6, 6, 3) f32 ordered
    c, c_s, c_t, c_ss, c_st, c_tt). Twin of the numpy chain in
    math/approximation.py — fuzz-tested in test_torch_native.py.
    """
    lib = _load()
    uv = np.ascontiguousarray(uv, np.float64)
    view = np.ascontiguousarray(view, np.float64)
    m3x4 = np.ascontiguousarray(m3x4, np.float64)
    origin_xy = np.empty((6, 2), np.int32)
    origin_uv = np.empty((6, 2), np.float32)
    coeffs = np.empty((6, 6, 3), np.float32)
    lib.tr_taylor_spherical(
        _f64p(uv), _f64p(view), _f64p(m3x4), float(origin_count),
        _i32p(origin_xy), origin_uv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        coeffs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return origin_xy, origin_uv, coeffs


@_counted
def split_bilinear(source: np.ndarray, px: np.ndarray,
                   py: np.ndarray) -> np.ndarray:
    """Threaded separable clamp-to-edge bilinear resize of a (H, W, C)
    f32 source at f64 source positions px (P,) / py (B,) -> (B, P, C)
    f32 (terrain_runtime.cpp tr_split_bilinear). Bit-identical to the
    numpy two-pass path in ops/preprocess.split_mosaic."""
    lib = _load()
    source = np.ascontiguousarray(source, np.float32)
    px = np.ascontiguousarray(px, np.float64)
    py = np.ascontiguousarray(py, np.float64)
    H, W, C = source.shape
    out = np.empty((py.shape[0], px.shape[0], C), np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.tr_split_bilinear(
        source.ctypes.data_as(f32p), H, W, C,
        _f64p(px), px.shape[0], _f64p(py), py.shape[0],
        out.ctypes.data_as(f32p),
    )
    return out


@_counted
def quantize(src: np.ndarray, max_value: float, dtype) -> np.ndarray:
    """Quantize a f32 array to u8/u16 exactly like
    ``np.clip(np.rint(src * max_value), 0, max_value).astype(dtype)``
    (f32 multiply, round half-to-even — terrain_runtime.cpp tr_quantize)."""
    lib = _load()
    src = np.ascontiguousarray(src, np.float32)
    dtype = np.dtype(dtype)
    out = np.empty(src.shape, dtype)
    lib.tr_quantize(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), src.size,
        float(max_value), _DTYPE_CODES[dtype], out.ctypes.data,
    )
    return out


@_counted
def downsample(children, texture_size: int, border_size: int,
               dtype, channels: int) -> np.ndarray:
    """Native twin of ops/preprocess.downsample_tile (f64-accumulated
    nodata-masked 2x2 child average; terrain_runtime.cpp tr_downsample)."""
    lib = _load()
    dtype = np.dtype(dtype)
    kept = [
        np.ascontiguousarray(c, dtype) if c is not None else None
        for c in children
    ]
    out = np.empty((texture_size, texture_size, channels), dtype)
    lib.tr_downsample(
        *(c.ctypes.data if c is not None else None for c in kept),
        _DTYPE_CODES[dtype], texture_size, border_size, channels,
        out.ctypes.data,
    )
    return out


@_counted
def sample_bilinear(data: np.ndarray, uv, max_value: float) -> np.ndarray:
    """Native single-point bilinear tap (terrain_runtime.cpp
    tr_sample_bilinear); twin of attachment.sample_bilinear_host for one uv.
    ``data`` (size, size, C) C-contiguous u8/u16/f32. Returns (4,) f64."""
    lib = _load()
    _out_array(data, tuple(_DTYPE_CODES), "data")
    code = _DTYPE_CODES[data.dtype]
    out = np.empty(4, np.float64)
    lib.tr_sample_bilinear(
        data.ctypes.data, data.shape[0], data.shape[2], code,
        float(max_value), float(uv[0]), float(uv[1]), _f64p(out),
    )
    return out


@_counted
def taylor_from_world(view: np.ndarray, m3x4: np.ndarray, lm3x4: np.ndarray,
                      origin_count: float):
    """Full native Taylor entry for TRUE spheres (tr_taylor_from_world):
    world view position -> face pick + warp + 6-side projection + chain.
    ``lm3x4`` = local_from_world (3, 4) f64. Same returns as
    :func:`taylor_spherical`."""
    lib = _load()
    view = np.ascontiguousarray(view, np.float64)
    m3x4 = np.ascontiguousarray(m3x4, np.float64)
    lm3x4 = np.ascontiguousarray(lm3x4, np.float64)
    origin_xy = np.empty((6, 2), np.int32)
    origin_uv = np.empty((6, 2), np.float32)
    coeffs = np.empty((6, 6, 3), np.float32)
    lib.tr_taylor_from_world(
        _f64p(view), _f64p(m3x4), _f64p(lm3x4), float(origin_count),
        _i32p(origin_xy), origin_uv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        coeffs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return origin_xy, origin_uv, coeffs


@_counted
def project_view_uv(view: np.ndarray, lm3x4: np.ndarray) -> np.ndarray:
    """Native spherical view-uv projection onto all 6 faces
    (tr_project_view_uv). ``lm3x4`` = local_from_world (3, 4) f64.
    Returns (6, 2) f64."""
    lib = _load()
    view = np.ascontiguousarray(view, np.float64)
    lm3x4 = np.ascontiguousarray(lm3x4, np.float64)
    uv6 = np.empty((6, 2), np.float64)
    lib.tr_project_view_uv(_f64p(view), _f64p(lm3x4), _f64p(uv6))
    return uv6


@_counted
def view_anchors(side_uv: np.ndarray, L: int, T: int,
                 origins: np.ndarray, view_int: np.ndarray,
                 view_frac: np.ndarray) -> None:
    """Native per-(side, lod) tree anchors (tr_view_anchors); writes into
    the preallocated (S, L, 2) outputs in place. Twin of
    ops/tile_tree.py::compute_view_anchors' vector math."""
    lib = _load()
    _out_array(origins, (np.int32,), "origins")
    _out_array(view_int, (np.int32,), "view_int")
    _out_array(view_frac, (np.float32,), "view_frac")
    side_uv = np.ascontiguousarray(side_uv, np.float64)
    S = origins.shape[0]
    lib.tr_view_anchors(
        _f64p(side_uv), S, int(L), int(T),
        _i32p(origins), _i32p(view_int),
        view_frac.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
