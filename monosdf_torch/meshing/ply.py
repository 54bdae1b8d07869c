"""Minimal binary PLY writer/reader (replaces the reference's trimesh export,
plots.py:222-226): a copy of monosdf_tpu/meshing/ply.py, numpy only (the
port imports nothing of the JAX package)."""

from __future__ import annotations

import numpy as np


def write_ply(
    path: str,
    verts: np.ndarray,
    faces: np.ndarray | None = None,
    colors: np.ndarray | None = None,
):
    """colors: optional (N, 3) per-vertex RGB in [0, 1] or uint8."""
    verts = np.asarray(verts, np.float32)
    n_f = 0 if faces is None else len(faces)
    header = [
        "ply",
        "format binary_little_endian 1.0",
        f"element vertex {len(verts)}",
        "property float x",
        "property float y",
        "property float z",
    ]
    if colors is not None:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = (np.clip(colors, 0.0, 1.0) * 255).astype(np.uint8)
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header += [
        f"element face {n_f}",
        "property list uchar int vertex_indices",
        "end_header",
    ]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if colors is not None:
            rec = np.empty(
                len(verts), dtype=[("xyz", "<f4", (3,)), ("rgb", "u1", (3,))]
            )
            rec["xyz"] = verts
            rec["rgb"] = colors
            f.write(rec.tobytes())
        else:
            f.write(verts.astype("<f4").tobytes())
        if faces is not None and n_f:
            faces = np.asarray(faces, np.int32)
            rec = np.empty(
                n_f, dtype=[("n", "u1"), ("idx", "<i4", (3,))]
            )
            rec["n"] = 3
            rec["idx"] = faces
            f.write(rec.tobytes())


def read_ply(path: str):
    """Reads PLYs written by write_ply (binary LE, xyz float + tri faces)."""
    sizes = {"float": 4, "float32": 4, "double": 8, "uchar": 1, "uint8": 1,
             "int": 4, "int32": 4, "uint": 4, "short": 2, "ushort": 2}
    with open(path, "rb") as f:
        n_v = n_f = 0
        props = []  # (type, name) of vertex-element properties
        in_vertex = False
        while True:
            line = f.readline().decode().strip()
            if line.startswith("element vertex"):
                n_v = int(line.split()[-1])
                in_vertex = True
            elif line.startswith("element"):
                if line.startswith("element face"):
                    n_f = int(line.split()[-1])
                in_vertex = False
            elif line.startswith("property") and in_vertex:
                _, ptype, pname = line.split()
                props.append((ptype, pname))
            elif line == "end_header":
                break
        stride = sum(sizes[t] for t, _ in props) if props else 12
        raw = f.read(stride * n_v)
        # xyz floats are always the first three properties we write
        verts = np.frombuffer(raw, dtype=np.uint8).reshape(n_v, stride)[:, :12]
        verts = verts.copy().view("<f4").reshape(n_v, 3)
        faces = None
        if n_f:
            rec = np.frombuffer(
                f.read(n_f * (1 + 12)), dtype=[("n", "u1"), ("idx", "<i4", (3,))]
            )
            faces = rec["idx"].copy()
    return verts.copy(), faces
