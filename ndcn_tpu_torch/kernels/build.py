"""Build and load the port's CUDA kernels.

The sources in ``ndcn_tpu_torch/csrc/*.cu`` (with the headers beside them)
compile with ``nvcc``, one
process per source, all started together, and link into one shared library
with a plain C interface, which ``ctypes`` loads. The library
lands in ``build/kernels/`` at the repository root, named by a hash of the
sources and the compiler flags, so a changed source builds anew and an
unchanged one is reused. Nothing here runs at import: the first kernel launch
builds and loads the library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# sm_90a (Hopper with its architecture-specific instructions); -Xptxas -v
# records each kernel's registers and shared memory in the build log
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C entry points: (name, argtypes). Every pointer and the stream are c_void_p.
_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
_GATHER = (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P, _P)
ENTRY_POINTS = {
    # row_ptr, cols, vals, the row-major table (x, or K1-fm's packed
    # scratch), y (or yT), n_rows, d, bytes per lane load, split limit,
    # long_rows, chunk_ptr, chunk_bounds, n_long, n_chunks, partial, stream
    "ndcn_coo_spmv_f32": _GATHER,
    "ndcn_coo_spmv_bf16": _GATHER,
    "ndcn_coo_spmv_T_f32": _GATHER,
    "ndcn_coo_spmv_T_bf16": _GATHER,
    # side (0 forward, 1 row side, 2 column side), row_ptr, rows, cols,
    # vals, x, g, y, n_rows, d, bytes per lane load, the coefficients d, e,
    # h, accumulate, split limit, long_rows, chunk_ptr, chunk_bounds, n_long,
    # n_chunks, partial, stream
    "ndcn_coo_mutual_f32": (_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                            _F, _F, _I, _I, _P, _P, _P, _I, _I, _P, _P),
    # xT, table, n, d_sub, stream
    "ndcn_pack_rows_f32": (_P, _P, _I, _I, _P),
    "ndcn_pack_rows_bf16": (_P, _P, _I, _I, _P),
    # row_ptr, cols, vals, the row-major table, yT, n, d_sub, stream
    "ndcn_coo_spmv_T_wide_f32": (_P, _P, _P, _P, _P, _I, _I, _P),
    "ndcn_coo_spmv_T_wide_bf16": (_P, _P, _P, _P, _P, _I, _I, _P),
    # tile_ptr, local_rows, vals, contrib, out, n_tiles, d_sub, E, R,
    # n_slots, stream
    "ndcn_sliced_tile_reduce_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _L,
                                    _P),
    # x, idx, out, rows, k, stream
    "ndcn_row_gather_f32": (_P, _P, _P, _I, _I, _P),
    # a, h, w, b, out, n, k, w row stride, w column stride, the plan (rows,
    # nt, wn, bk, smem bytes), stream
    "ndcn_fused_rhs_f32": (_P, _P, _P, _P, _P, _I, _I, _L, _L, _I, _I, _I,
                           _I, _L, _P),
    # row_ptr, block_cols, blocks, x, y, n_row_blocks, block, n_rows,
    # n_cols, d, stream
    "ndcn_bsr_spmm_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # row_ptr, block_cols, blocks, x, w, b, out, n_row_blocks, block, n_rows,
    # n_cols, d, w row stride, w column stride, the plan (rows, nt, wn, bk,
    # smem bytes), stream
    "ndcn_bsr_fused_rhs_f32": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _L, _L, _I, _I, _I, _I, _L, _P),
}


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in sorted([*sources(), *CSRC.glob("*.cuh")]):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libndcn_kernels_{digest.hexdigest()[:16]}.so"


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and on "
                           "PATH): the CUDA kernels cannot be built")
    return found


def build() -> Path:
    """Compile the library unless it exists already; return its path. The
    compilers' output (with ptxas's register and shared-memory report) is kept
    beside it as ``<library>.log``."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    jobs = []
    for src in sources():
        obj = tmp.with_name(f"{tmp.name}.{src.stem}.o")
        cmd = [nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out, err = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{err}")
    if not failed:
        cmd = [nvcc(), "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n{proc.stderr}")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    path.with_name(path.name + ".log").write_text("".join(log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, path)
    return path


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare every entry."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in ENTRY_POINTS.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def is_built() -> bool:
    return library_path().exists()
