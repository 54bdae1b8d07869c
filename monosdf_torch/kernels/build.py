"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface under ``monosdf_torch/_build/``
(named by a hash of its sources and flags, so an edit rebuilds it) and loaded
with ``ctypes``. ``build_all`` starts one ``nvcc`` per source at once.

Every C entry point launches on the stream it is given, allocates nothing
and returns ``cudaGetLastError()``; ``check`` raises on a non-zero code.

``launches[name]`` counts the launches of each kernel (``KERNELS``: one per
source, and K1-PE apart from K1): a wrapper adds one right after its kernel
was launched, and nowhere else; ``reference_launches`` those of K2f's order
reference.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("sdf_mlp", "sampler_machinery", "sdf_grad", "radiance_norm", "sdf_grad_bwd",
           "radiance_norm_bwd", "hash_encode", "hash_encode_bwd", "sdf_grad_grid",
           "sdf_grad_grid_bwd", "radiance_split", "radiance_split_bwd", "radiance_mlp",
           "radiance_mlp_bwd", "probe_gather", "probe_scatter_rows", "probe_row_copy",
           "probe_strided_permute", "probe_capacity")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the kernels counted: each source's, and K1-PE, K1's library on raw points
KERNELS = SOURCES + ("sdf_mlp_pe",)
SOURCE_OF = {**{name: name for name in SOURCES}, "sdf_mlp_pe": "sdf_mlp"}

launches = {name: 0 for name in KERNELS}
# launches of a kernel no model path runs: K2f's SIMT kernel at bf16, the
# order reference of the render chunk's kernel (sdf_grad.sdf_mlp_with_grad_simt)
reference_launches = {"sdf_grad_simt": 0}
build_logs: dict = {}
_libs: dict = {}


def reset_launch_counts():
    for counts in (launches, reference_launches):
        for name in counts:
            counts[name] = 0


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [str(Path(home) / "bin" / "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def lib_path(name: str) -> Path:
    """The built library of ``csrc/<name>.cu`` (named by a hash of its sources)."""
    h = hashlib.sha256()
    for src in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started):
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names=SOURCES):
    """Compile every missing library, one ``nvcc`` per source, all at once."""
    started = {n: _start(n) for n in names}
    for n, s in started.items():
        _finish(n, s)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if missing."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(lib_path(name)))
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, name: str, err: int):
    if err != 0:
        msg = lib.error_string(err).decode()
        raise RuntimeError(f"kernel {name} failed to launch: CUDA error {err} ({msg})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require(t: torch.Tensor, what: str, dtype, shape, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on ``device``."""
    if t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: not contiguous")


# -- packed MLP weights ------------------------------------------------------

MAX_LAYERS = 16  # csrc/common.cuh MK_MAX_LAYERS


def pack_mlp(ws, bs, skip_in=()):
    """Effective weights (d_in, d_out) and biases -> one float32 buffer and
    the int32 layer descriptor the kernels read (csrc/common.cuh MlpDesc):
    ``[L, kin[16], nout[16], woff[16], boff[16], skip[16]]``."""
    L = len(ws)
    if L > MAX_LAYERS:
        raise ValueError(f"{L} layers; the kernels take at most {MAX_LAYERS}")
    parts, woff, boff, off = [], [], [], 0
    for w in ws:
        woff.append(off)
        parts.append(w.float().reshape(-1))
        off += w.numel()
    for b in bs:
        boff.append(off)
        parts.append(b.float().reshape(-1))
        off += b.numel()
    if off >= 2**31:
        raise ValueError("packed weights exceed 2^31 floats")
    pad = [0] * (MAX_LAYERS - L)
    desc = (
        [L]
        + [w.shape[0] for w in ws] + pad
        + [w.shape[1] for w in ws] + pad
        + woff + pad
        + boff + pad
        + [int(l in skip_in) for l in range(L)] + pad
    )
    return torch.cat(parts).contiguous(), (ctypes.c_int * len(desc))(*desc)


def unpack_mlp(flat: torch.Tensor, ws, bs):
    """Split a buffer in ``pack_mlp``'s layout back into tensors shaped as
    ``ws`` and ``bs`` (views of ``flat``)."""
    out, off = [], 0
    for t in (*ws, *bs):
        out.append(flat[off:off + t.numel()].view(t.shape))
        off += t.numel()
    return out[:len(ws)], out[len(ws):]


def num_sms(device: torch.device) -> int:
    """Streaming multiprocessors of the card: the persistent grids of the
    backward kernels take one block per SM."""
    return torch.cuda.get_device_properties(device).multi_processor_count
