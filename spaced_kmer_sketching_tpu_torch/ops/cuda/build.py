"""Build and bind the hand-written Hopper kernels (csrc/*.cu).

All CUDA sources compile with nvcc, at first use, into ONE shared library
with a plain C interface that ctypes loads.  Each source compiles to an
object in its own nvcc process, all started together, and one more nvcc
links them:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas=-v -c csrc/<name>.cu -o <name>.o   (each)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o
         _build/libsks_kernels-<hash>.so *.o

No PyTorch header is compiled, so a cold build takes seconds.  The library
name carries a hash of every source's content, so an edited source is
rebuilt; the build writes a temporary file and renames it into place, and
the compiler's output (registers, shared memory and spills per kernel, from
-Xptxas=-v) is kept beside the library as `<name>.log`.

Every C entry launches on the stream it is given, allocates nothing and
returns cudaGetLastError(); the wrappers call it through `launch`, which
makes the tensors' device the current one for the call and raises on a
non-zero value.  Each wrapper counts its launches on a `Kernel` record
(`KERNELS` lists them), so a run can show that its main path went through
the kernels.
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
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas=-v"]

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
    "K4": Kernel("sort_rows", "spaced_kmer_sketching_tpu_torch/csrc/"
                 "sort.cu", "spaced_kmer_sketching_tpu/ops/pallas/"
                 "sort.py:110"),
    "K5": Kernel("merge_sorted_runs", "spaced_kmer_sketching_tpu_torch/csrc/"
                 "sort.cu", "spaced_kmer_sketching_tpu/ops/pallas/"
                 "sort.py:477"),
    "K6": Kernel("gram_tile_scan", "spaced_kmer_sketching_tpu_torch/csrc/"
                 "gram_tiles.cu", "spaced_kmer_sketching_tpu/ops/pallas/"
                 "gram_tiles.py:275"),
    "K7": Kernel("extract_compact_raw", "spaced_kmer_sketching_tpu_torch/"
                 "csrc/extract.cu", "spaced_kmer_sketching_tpu/ops/pallas/"
                 "extract.py:465"),
    "K8": Kernel("sort_runs", "spaced_kmer_sketching_tpu_torch/csrc/"
                 "sort.cu", "spaced_kmer_sketching_tpu/ops/pallas/"
                 "sort.py:189"),
    "K9": Kernel("sort_truncate", "spaced_kmer_sketching_tpu_torch/csrc/"
                 "sort.cu", "spaced_kmer_sketching_tpu/ops/pallas/"
                 "sort.py:249"),
    "K10": Kernel("merge_pair_streams", "spaced_kmer_sketching_tpu_torch/"
                  "csrc/sort.cu", "spaced_kmer_sketching_tpu/ops/pallas/"
                  "sort.py:432"),
    "K11": Kernel("extract_filter", "spaced_kmer_sketching_tpu_torch/"
                  "csrc/extract.cu", "spaced_kmer_sketching_tpu/ops/pallas/"
                  "extract.py:272"),
    # the port's own kernel: the XLA glue of the JAX blocked presort over a
    # bit-tight slab (unpack_keys_tight, then _pack_gid_planes), no Pallas
    "K12": Kernel("tight_gid_planes", "spaced_kmer_sketching_tpu_torch/"
                  "csrc/tight.cu", "spaced_kmer_sketching_tpu/ops/gram.py:570"
                  " and :210"),
}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path(defines=()) -> pathlib.Path:
    h = hashlib.sha256(" ".join([*NVCC_FLAGS, *defines]).encode())
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


def build(defines=()) -> pathlib.Path:
    """Compile csrc/*.cu unless a library of the same sources exists: one
    nvcc per source, all at once, then one link.  `defines` ("NAME=VALUE")
    set macros of the sources, such as csrc/sort.cu's SKS_RUN_E, for a
    library of their own."""
    so = library_path(defines)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cus, _ = _sources()
    log = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as objdir:
        objs = [os.path.join(objdir, p.stem + ".o") for p in cus]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-I",
             str(CSRC), "-c", str(p), "-o", o],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for p, o in zip(cus, objs)]
        failed = []
        for p, proc in zip(cus, procs):
            out, _ = proc.communicate()
            log.append(f"== {p.name}\n{out}")
            if proc.returncode != 0:
                failed.append(f"{p.name} ({proc.returncode})")
        if not failed:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                res = subprocess.run([nvcc, *ARCH, "-shared", "-o", tmp,
                                      *objs], capture_output=True, text=True)
                log.append(f"== link\n{res.stdout}{res.stderr}")
                if res.returncode != 0:
                    failed.append(f"link ({res.returncode})")
                else:
                    os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
    so.with_suffix(".log").write_text("".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n"
                           + "".join(log))
    return so


def _declare(lib) -> None:
    c = ctypes
    p, i, i64, u64 = c.c_void_p, c.c_int, c.c_int64, c.c_uint64
    lib.sks_extract_compact.restype = i
    lib.sks_extract_compact.argtypes = [
        p, i64, p, i64, i, i64, i, u64, u64, u64, p, i, u64, i, i, i, i, p, p,
        p]
    lib.sks_extract_compact_raw.restype = i
    lib.sks_extract_compact_raw.argtypes = [
        p, i64, p, i, p, p, i, i64, i, u64, u64, u64, p, i, u64, i, i, i, i, p,
        p, p]
    lib.sks_extract_filter.restype = i
    lib.sks_extract_filter.argtypes = [
        p, i64, p, i64, i, i64, i, u64, u64, u64, i, u64, i, i, p, p, p]
    lib.sks_compact_rows.restype = i
    lib.sks_compact_rows.argtypes = [p, i, i64, i, p, p, p]
    lib.sks_compact_global.restype = i
    lib.sks_compact_global.argtypes = [p, i, i, i64, p, p, p]
    lib.sks_compact_global_scratch.restype = i64
    lib.sks_compact_global_scratch.argtypes = [i, i64]
    lib.sks_sort_rows.restype = i
    lib.sks_sort_rows.argtypes = [p, p, p, i, i, i64, p]
    lib.sks_merge_runs.restype = i
    lib.sks_merge_runs.argtypes = [p, p, p, i, i64, i64, i64, p]
    lib.sks_merge_pair.restype = i
    lib.sks_merge_pair.argtypes = [p, p, p, i, i64, i, p]
    lib.sks_gram_tiles.restype = i
    lib.sks_gram_tiles.argtypes = [p, i, i64, i, i, i, i64, p, p, p]
    lib.sks_sort_runs_scratch.restype = i64
    lib.sks_sort_runs_scratch.argtypes = [i, i, i64, i64]
    lib.sks_sort_runs.restype = i
    lib.sks_sort_runs.argtypes = [p, p, p, i, i, i64, i64, p]
    lib.sks_sort_truncate_scratch.restype = i64
    lib.sks_sort_truncate_scratch.argtypes = [i, i, i64, i64]
    lib.sks_sort_truncate.restype = i
    lib.sks_sort_truncate.argtypes = [p, p, p, i, i, i64, i64, p]
    lib.sks_tight_gid_planes.restype = i
    lib.sks_tight_gid_planes.argtypes = [p, p, i64, i, i, i, i, i, p, p]


def load(defines=()):
    """A kernel library built with `defines` (see build), loaded."""
    handle = ctypes.CDLL(str(build(defines)))
    _declare(handle)
    return handle


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = load()
    return _lib


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def launch(entry: str, device: torch.device, *args) -> None:
    """Call the C entry `entry` with `args` and `device`'s current stream,
    with `device` made the calling thread's current CUDA device for the
    call, and raise on the CUDA error it returns.  A kernel launches on
    the current device: a stream of another device is an invalid handle
    there, so a wrapper called on a tensor of cuda:1 while cuda:0 is
    current would fail without the guard."""
    with torch.cuda.device(device):
        err = getattr(lib(), entry)(*args, stream_ptr(device))
    check(err, entry)


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
