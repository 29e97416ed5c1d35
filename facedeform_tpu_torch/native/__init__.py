"""ctypes loader for the fastgeo native library (with on-demand build).

A copy of facedeform_tpu/native/__init__.py (host code, no JAX), with one
change: the library is built under native/build/, named by a hash of its
source, and written to a temporary file that os.replace moves into place,
so several processes (test workers) building it at once never load a
half-written file.

Mirrors the reference's native substrate (HDK's GEO_PointTree / GQ_Detail,
capture.cpp:15-24) for the host-side irregular work.  The library is built
lazily with g++ on first use; every entry point has a pure-numpy/scipy
fallback, so the package works without a toolchain: the native path is a
host-performance optimization, not a correctness dependency.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "fastgeo.cpp")
_BUILD = os.path.join(_DIR, "build")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> str:
    """Where the library built from the current source lives."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD, f"libfastgeo_{digest}.so")


def _build(path: str) -> bool:
    """Compile into a temporary file beside `path`, then move it into
    place: the rename is atomic, so a concurrent reader sees either no
    library or a whole one."""
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".libfastgeo-", suffix=".so", dir=_BUILD)
    os.close(fd)
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
        return True
    except (subprocess.SubprocessError, OSError):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, building it if needed; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not os.path.exists(path) and not _build(path):
            return None
        _lib = _load_and_bind(path)
        return _lib


def _load_and_bind(path: str) -> Optional[ctypes.CDLL]:
    """CDLL + argtype bindings; None on load failure or a missing symbol,
    so callers fall back cleanly."""
    try:
        lib = ctypes.CDLL(path)
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.fd_bfs_rings.argtypes = [
            i64p, i32p, ctypes.c_int64, i64p, ctypes.c_int64,
            ctypes.c_int64, u8p,
        ]
        lib.fd_bfs_rings.restype = None
        lib.fd_nearest.argtypes = [
            f32p, ctypes.c_int64, f32p, ctypes.c_int64, i64p,
            ctypes.c_void_p,
        ]
        lib.fd_nearest.restype = None
        lib.fd_dijkstra.argtypes = [
            i64p, i32p, ctypes.c_int64, f32p, i64p, ctypes.c_void_p,
            ctypes.c_int64, f32p,
        ]
        lib.fd_dijkstra.restype = None
        lib.fd_build_adjacency.argtypes = [
            i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ]
        lib.fd_build_adjacency.restype = ctypes.c_int64
        lib.fd_obj_count.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.fd_obj_count.restype = ctypes.c_int32
        lib.fd_obj_parse.argtypes = [
            ctypes.c_char_p, f32p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64,
        ]
        lib.fd_obj_parse.restype = ctypes.c_int32
        lib.fd_obj_write.argtypes = [
            ctypes.c_char_p, f32p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, i32p, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.fd_obj_write.restype = ctypes.c_int32
        return lib
    except (OSError, AttributeError):
        return None


def available() -> bool:
    return get_lib() is not None


# ------------------------------------------------------------------ wrappers
def bfs_rings(
    indptr: np.ndarray, indices: np.ndarray, seeds: np.ndarray, max_edges: int
) -> Optional[np.ndarray]:
    """Native multi-source BFS; returns (V,) bool mask or None if no lib."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(indptr) - 1
    out = np.zeros(n, np.uint8)
    lib.fd_bfs_rings(
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int32),
        n,
        np.ascontiguousarray(seeds, np.int64),
        len(seeds),
        int(max_edges),
        out,
    )
    return out.astype(bool)


def dijkstra(
    indptr: np.ndarray,
    indices: np.ndarray,
    points: np.ndarray,
    sources: np.ndarray,
    source_dist: Optional[np.ndarray] = None,
) -> Optional[np.ndarray]:
    """Native multi-source Dijkstra (edge weights = euclidean edge length);
    (V,) f32 distances, 3.4e38 unreachable; None if no lib."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(indptr) - 1
    out = np.zeros(n, np.float32)
    if source_dist is not None:
        source_dist = np.ascontiguousarray(source_dist, np.float32)
        sd_ptr = source_dist.ctypes.data_as(ctypes.c_void_p)
    else:
        sd_ptr = None
    lib.fd_dijkstra(
        np.ascontiguousarray(indptr, np.int64),
        np.ascontiguousarray(indices, np.int32),
        n,
        np.ascontiguousarray(points, np.float32),
        np.ascontiguousarray(sources, np.int64),
        sd_ptr,
        len(sources),
        out,
    )
    return out


def nearest(points: np.ndarray, queries: np.ndarray) -> Optional[np.ndarray]:
    """Native KD-tree nearest-point indices; (M,) int64 or None if no lib."""
    lib = get_lib()
    if lib is None:
        return None
    points = np.ascontiguousarray(points, np.float32)
    queries = np.ascontiguousarray(np.atleast_2d(queries), np.float32)
    out = np.zeros(len(queries), np.int64)
    lib.fd_nearest(points, len(points), queries, len(queries), out, None)
    return out


def parse_obj(path: str):
    """Native OBJ parse: (verts (V,3) f32, normals (Nn,3) f32 | None,
    faces (F, max_arity) int32 with -1 padding | None), or None if no lib."""
    lib = get_lib()
    if lib is None:
        return None
    nv = ctypes.c_int64()
    nn = ctypes.c_int64()
    nf = ctypes.c_int64()
    ma = ctypes.c_int64()
    if not lib.fd_obj_count(
        path.encode(), ctypes.byref(nv), ctypes.byref(nn),
        ctypes.byref(nf), ctypes.byref(ma),
    ):
        return None
    verts = np.zeros((nv.value, 3), np.float32)
    normals = np.zeros((max(nn.value, 1), 3), np.float32)
    arity = max(ma.value, 1)
    faces = np.zeros((max(nf.value, 1), arity), np.int32)
    if not lib.fd_obj_parse(
        path.encode(), verts,
        normals.ctypes.data_as(ctypes.c_void_p),
        faces.ctypes.data_as(ctypes.c_void_p), arity,
    ):
        return None
    return (
        verts,
        normals[: nn.value] if nn.value else None,
        faces[: nf.value] if nf.value else None,
    )


def write_obj(path: str, verts, normals, faces) -> bool:
    """Native OBJ write; returns False if the lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    verts = np.ascontiguousarray(verts, np.float32)
    if normals is not None:
        normals = np.ascontiguousarray(normals, np.float32)
        n_ptr = normals.ctypes.data_as(ctypes.c_void_p)
        nn = len(normals)
    else:
        n_ptr, nn = None, 0
    if faces is not None and len(faces):
        faces = np.ascontiguousarray(faces, np.int32)
        nf, arity = faces.shape
    else:
        faces = np.zeros((1, 1), np.int32)
        nf, arity = 0, 1
    return bool(
        lib.fd_obj_write(path.encode(), verts, len(verts), n_ptr, nn,
                         faces, nf, arity)
    )


def build_adjacency(
    faces: np.ndarray, n_points: int
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Native CSR adjacency from faces; (indptr, indices) or None if no lib."""
    lib = get_lib()
    if lib is None:
        return None
    faces = np.ascontiguousarray(faces, np.int32)
    n_faces, arity = faces.shape
    total = lib.fd_build_adjacency(faces, n_faces, arity, n_points, None, None, 0)
    indptr = np.zeros(n_points + 1, np.int64)
    indices = np.zeros(max(int(total), 1), np.int32)
    lib.fd_build_adjacency(
        faces, n_faces, arity, n_points,
        indptr.ctypes.data_as(ctypes.c_void_p),
        indices.ctypes.data_as(ctypes.c_void_p),
        total,
    )
    return indptr, indices[:total]
