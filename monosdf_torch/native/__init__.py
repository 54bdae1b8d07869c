"""The native (C++) marching tetrahedra, built on first use and loaded with
ctypes: the port's own copy of monosdf_tpu/native (``marching_tets.cpp``
and its binding).

``marching_tets.cpp`` is compiled by ``$CXX`` (default ``g++``) with
``CXX_FLAGS`` into ``monosdf_torch/_build/`` (gitignored), under a name
made of a hash of the source, the compiler and the flags, so an edit
rebuilds it. Each process compiles to a temporary name of its own and moves
the library into place with ``os.replace``, so processes that build at once
(test workers) never write one file. A failed build raises, with the
compiler's output in the message: there is no quiet fallback to the numpy
marcher; a caller that wants it asks for it (``extract_mesh(native=False)``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "marching_tets.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_LOCK = threading.Lock()
_LIBS: dict = {}  # library path -> loaded ctypes.CDLL


def compiler() -> str:
    return os.environ.get("CXX", "g++")


def lib_path() -> Path:
    """The built library (named by a hash of its source, compiler and flags)."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join((compiler(), *CXX_FLAGS)).encode())
    return BUILD_DIR / f"marching_tets-{h.hexdigest()[:16]}.so"


def _build(out: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [compiler(), *CXX_FLAGS, "-o", str(tmp), str(SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"building {SRC.name} failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SRC.name} failed ({' '.join(cmd)}, exit "
                           f"{proc.returncode}):\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, out)


def get_native_lib() -> ctypes.CDLL:
    """The loaded native library, built if missing; raises if the build fails."""
    path = lib_path()
    lib = _LIBS.get(path)
    if lib is not None:
        return lib
    with _LOCK:
        if path not in _LIBS:
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            lib.mt_extract.restype = ctypes.c_int
            lib.mt_extract.argtypes = [
                ctypes.POINTER(ctypes.c_float),  # sdf
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float),  # origin
                ctypes.POINTER(ctypes.c_float),  # spacing
                ctypes.c_float,                  # level
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.mt_free.restype = None
            lib.mt_free.argtypes = [ctypes.POINTER(ctypes.c_float),
                                    ctypes.POINTER(ctypes.c_int64)]
            _LIBS[path] = lib
    return _LIBS[path]


def marching_tetrahedra_native(sdf: np.ndarray, origin, spacing, level: float = 0.0):
    """Native marching tetrahedra with welded (deduplicated) vertices.

    Same decomposition and case analysis as ``meshing.marching.
    marching_tetrahedra``; returns (verts (V,3) float32, faces (F,3) int64).
    """
    lib = get_native_lib()
    sdf = np.ascontiguousarray(sdf, np.float32)
    origin = np.ascontiguousarray(np.broadcast_to(np.asarray(origin, np.float32), (3,)))
    spacing = np.ascontiguousarray(np.broadcast_to(np.asarray(spacing, np.float32), (3,)))
    nx, ny, nz = sdf.shape

    verts_p = ctypes.POINTER(ctypes.c_float)()
    faces_p = ctypes.POINTER(ctypes.c_int64)()
    nv = ctypes.c_int64(0)
    nf = ctypes.c_int64(0)
    rc = lib.mt_extract(
        sdf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nx, ny, nz,
        origin.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        spacing.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_float(level),
        ctypes.byref(verts_p), ctypes.byref(faces_p), ctypes.byref(nv), ctypes.byref(nf),
    )
    if rc != 0:
        raise RuntimeError(f"mt_extract failed with code {rc}")
    try:
        if nv.value == 0:
            return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
        verts = np.ctypeslib.as_array(verts_p, (nv.value, 3)).astype(np.float32, copy=True)
        if nf.value == 0:
            faces = np.zeros((0, 3), np.int64)
        else:
            faces = np.ctypeslib.as_array(faces_p, (nf.value, 3)).astype(np.int64, copy=True)
    finally:
        lib.mt_free(verts_p, faces_p)
    return verts, faces
