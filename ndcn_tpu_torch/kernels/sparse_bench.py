"""The sparse microbenchmarks' kernels (P1a, P1b / P2), each with its plain
PyTorch version.

- ``sliced_tile_reduce``: the sliced-tile reduce of
  ``tools/microbench_sparse.py`` (its Pallas ``seg_kernel``), over the
  packing that tool builds inline (``pack_sliced_tiles``: row tiles of R
  rows, slices of E edge slots). CUDA kernel in
  ``ndcn_tpu_torch/csrc/sparse_bench.cu``.
- ``row_gather``: out[e, :] = x[idx[e], :], the in-kernel row gather of
  ``tools/microbench_sparse.py`` [7] and ``tools/probe_inkernel_gather.py``.

CPU tensors take the plain versions; CUDA tensors launch the kernels (and
raise if they cannot). They serve ``ndcn_tpu_torch/tools/`` only: the
solver's SpMV reads CSR directly (``kernels/coo_spmv.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ndcn_tpu_torch.kernels import build
from ndcn_tpu_torch.kernels.platform import on_cuda

SLICED_LAUNCHES = 0
GATHER_LAUNCHES = 0

R_TILE = 128     # rows per output tile (tools/microbench_sparse.py:164)
E_SLICE = 2048   # edge slots per slice (:165)


class SlicedTiles(NamedTuple):
    """Row-sorted edges cut into slices of ``E`` slots within row tiles of
    ``R`` rows; a tile's slices are consecutive, ``tile_ptr[t]`` to
    ``tile_ptr[t + 1]``, and every tile has at least one slice. Pad slots
    carry local row 0, column 0 and value 0 and add exactly zero."""
    tile_ptr: torch.Tensor    # (T + 1,) int32
    local_rows: torch.Tensor  # (S·E,) int32, row - tile·R
    cols: torch.Tensor        # (S·E,) int32
    vals: torch.Tensor        # (S·E,) float32
    slot_rows: torch.Tensor   # (S·E,) int64, tile·R + local row (plain path)
    n: int
    n_pad: int
    R: int
    E: int


def pack_sliced_tiles(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                      n: int, R: int = R_TILE, E: int = E_SLICE,
                      device=None) -> SlicedTiles:
    """The packing of ``tools/microbench_sparse.py:164-195``, vectorised."""
    rows = np.asarray(rows)
    if rows.ndim != 1 or np.any(np.diff(rows) < 0):
        raise ValueError("pack_sliced_tiles takes row-sorted edges")
    if 256 % R != 0:
        raise ValueError(f"the tile height R must divide 256, got {R}")
    T = max(1, -(-n // R))
    nnz = rows.shape[0]
    starts = np.searchsorted(rows, np.arange(T) * R)
    counts = np.diff(np.append(starts, nnz))
    s_count = np.maximum(1, -(-counts // E))
    tile_ptr = np.concatenate([[0], np.cumsum(s_count)]).astype(np.int64)
    S = int(tile_ptr[-1])
    owner = np.repeat(np.arange(T), counts)
    pos = np.arange(nnz, dtype=np.int64) - starts[owner]
    flat = (tile_ptr[owner] + pos // E) * E + pos % E
    lr = np.zeros(S * E, np.int32)
    cc = np.zeros(S * E, np.int32)
    vv = np.zeros(S * E, np.float32)
    lr[flat] = rows - owner * R
    cc[flat] = cols
    vv[flat] = vals
    slot_tile = np.repeat(np.repeat(np.arange(T), s_count), E)
    as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return SlicedTiles(as_t(tile_ptr.astype(np.int32)), as_t(lr), as_t(cc),
                       as_t(vv), as_t(slot_tile * R + lr), n=int(n),
                       n_pad=T * R, R=R, E=E)


def sliced_tile_reduce_plain(tiles: SlicedTiles,
                             contrib: torch.Tensor) -> torch.Tensor:
    """out[f, tile·R + lr[e]] += contrib[f, e] · vals[e]: scale, then
    ``index_add_`` along the nodes."""
    return torch.zeros((contrib.shape[0], tiles.n_pad), dtype=torch.float32,
                       device=contrib.device).index_add_(
        1, tiles.slot_rows, contrib * tiles.vals)


def sliced_tile_reduce(tiles: SlicedTiles,
                       contrib: torch.Tensor) -> torch.Tensor:
    """Reduce pre-gathered feature-major contribs (d_sub, S·E) into the
    (d_sub, n_pad) output. On the card a warp owns one feature of one tile
    and sums each run of equal local row with a segmented warp reduction,
    in a fixed order: two calls agree bit for bit."""
    slots = tiles.local_rows.shape[0]
    if (contrib.dtype != torch.float32 or contrib.ndim != 2
            or contrib.shape[1] != slots):
        raise ValueError(f"sliced_tile_reduce takes float32 contribs of shape "
                         f"(d_sub, {slots}), got {contrib.dtype} "
                         f"{tuple(contrib.shape)}")
    d_sub = contrib.shape[0]
    if not on_cuda(contrib, tiles.tile_ptr, tiles.local_rows, tiles.vals):
        return sliced_tile_reduce_plain(tiles, contrib)
    global SLICED_LAUNCHES
    contrib = contrib.contiguous()
    n_tiles = tiles.tile_ptr.shape[0] - 1
    out = torch.empty((d_sub, tiles.n_pad), dtype=torch.float32,
                      device=contrib.device)
    with torch.cuda.device(contrib.device):
        rc = build.load().ndcn_sliced_tile_reduce_f32(
            tiles.tile_ptr.data_ptr(), tiles.local_rows.data_ptr(),
            tiles.vals.data_ptr(), contrib.data_ptr(), out.data_ptr(),
            n_tiles, d_sub, tiles.E, tiles.R, slots,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sliced_tile_reduce launch failed: CUDA error {rc}")
    SLICED_LAUNCHES += 1
    return out


def row_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[e, :] = x[idx[e], :] for a row-major float32 (m, k) table, k a
    multiple of 4 (16-byte rows), and int32 indices in [0, m)."""
    if (x.dtype != torch.float32 or x.ndim != 2 or x.shape[1] % 4 != 0
            or idx.dtype != torch.int32 or idx.ndim != 1):
        raise ValueError(f"row_gather takes a float32 (m, 4j) table and int32 "
                         f"indices, got {x.dtype} {tuple(x.shape)} and "
                         f"{idx.dtype} {tuple(idx.shape)}")
    if not on_cuda(x, idx):
        return x[idx.long()]
    global GATHER_LAUNCHES
    x = x.contiguous()
    out = torch.empty((idx.shape[0], x.shape[1]), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        rc = build.load().ndcn_row_gather_f32(
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
            x.shape[1], torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"row_gather launch failed: CUDA error {rc}")
    GATHER_LAUNCHES += 1
    return out
