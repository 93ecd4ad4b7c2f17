"""Build and bind the hand-written Hopper kernels (csrc/*.cu).

All CUDA sources compile with nvcc, at first use, into ONE shared library
with a plain C interface that ctypes loads:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas=-v -o _build/libsks_kernels-<hash>.so csrc/*.cu

No PyTorch header is compiled, so a cold build takes seconds.  The library
name carries a hash of every source's content, so an edited source is
rebuilt; the build writes a temporary file and renames it into place, and
the compiler's output (registers, shared memory and spills per kernel, from
-Xptxas=-v) is kept beside the library as `<name>.log`.

Every C entry launches on the stream it is given, allocates nothing and
returns cudaGetLastError(); `check` raises on a non-zero value.  Each
wrapper counts its launches on a `Kernel` record (`KERNELS` lists them), so
a run can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading

import torch

from ...utils.native import BUILD_DIR

CSRC = pathlib.Path(__file__).resolve().parents[2] / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_lock = threading.Lock()
_lib = None


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel: where it lives, which TPU kernel it
    replaces, and how often its wrapper launched it."""
    name: str
    source: str        # repo-relative CUDA source
    replaces: str      # file:line of the Pallas kernel it ports
    launches: int = 0


KERNELS = {
    "K1": Kernel("extract_compact", "spaced_kmer_sketching_tpu_torch/csrc/"
                 "extract.cu", "spaced_kmer_sketching_tpu/ops/pallas/"
                 "extract.py:308"),
    "K2": Kernel("compact_rows", "spaced_kmer_sketching_tpu_torch/csrc/"
                 "compact.cu", "spaced_kmer_sketching_tpu/ops/pallas/"
                 "compact.py:71"),
    "K3": Kernel("compact_global", "spaced_kmer_sketching_tpu_torch/csrc/"
                 "compact.cu", "spaced_kmer_sketching_tpu/ops/pallas/"
                 "compact.py:108"),
    "K4": Kernel("bitonic_sort", "spaced_kmer_sketching_tpu_torch/csrc/"
                 "sort.cu", "spaced_kmer_sketching_tpu/ops/pallas/"
                 "sort.py:110"),
}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cus, cuhs = _sources()
    for p in cus + cuhs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libsks_kernels-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the kernels in " + str(CSRC))
    return str(pathlib.Path(CUDA_HOME) / "bin" / "nvcc")


def build() -> pathlib.Path:
    """Compile csrc/*.cu unless a library of the same sources exists."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cus, _ = _sources()
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
           *[str(p) for p in cus]]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        so.with_suffix(".log").write_text(res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


def _declare(lib) -> None:
    c = ctypes
    p, i, i64, u64 = c.c_void_p, c.c_int, c.c_int64, c.c_uint64
    lib.sks_extract_compact.restype = i
    lib.sks_extract_compact.argtypes = [
        p, i64, p, i64, i, i64, i, u64, u64, u64, i, i, i, i, p, p, p]
    lib.sks_compact_rows.restype = i
    lib.sks_compact_rows.argtypes = [p, i, i64, i, p, p, p]
    lib.sks_compact_global.restype = i
    lib.sks_compact_global.argtypes = [p, i, i, i64, p, p]
    lib.sks_sort_rows.restype = i
    lib.sks_sort_rows.argtypes = [p, p, i, i, i64, p]


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            _declare(handle)
            _lib = handle
    return _lib


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
            device: torch.device) -> None:
    """Validate a kernel operand before its pointer crosses into C."""
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{ndim} dimensions")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
