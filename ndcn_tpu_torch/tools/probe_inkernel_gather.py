"""Probe: the row gather out[e, :] = x[idx[e], :] of 2048 rows from a
(4096, 128) float32 table on the card, as the JAX package's
``tools/probe_inkernel_gather.py`` (P2).

The JAX probe tried four Mosaic lowerings of an in-kernel gather from VMEM.
Here the hand-written CUDA row gather (``kernels/sparse_bench.row_gather``)
is checked and timed against the gathers PyTorch offers: ``x[idx]``,
``index_select`` and ``take_along_dim``. Each form must equal the numpy
gather; its time is the median CUDA-event time of one call over 100 calls,
printed as M rows/s.

Usage: python -m ndcn_tpu_torch.tools.probe_inkernel_gather
"""

from __future__ import annotations

import json
import statistics

import numpy as np
import torch

from ndcn_tpu_torch.kernels import sparse_bench
from ndcn_tpu_torch.tools import log, require_cuda

CALLS = 100


def main(argv=None) -> dict:
    dev = require_cuda()
    rng = np.random.RandomState(0)
    m, k, E = 4096, 128, 2048
    x_np = rng.rand(m, k).astype(np.float32)
    idx_np = rng.randint(0, m, E).astype(np.int32)
    ref = x_np[idx_np]
    x = torch.as_tensor(x_np, device=dev)
    idx = torch.as_tensor(idx_np, device=dev)
    idx64 = idx.long()
    forms = {
        "kernel": lambda: sparse_bench.row_gather(x, idx),
        "index": lambda: x[idx64],
        "index_select": lambda: torch.index_select(x, 0, idx64),
        "take_along_dim": lambda: torch.take_along_dim(
            x, idx64[:, None].expand(E, k), dim=0),
    }
    results = {"m": m, "k": k, "rows": E,
               "device": torch.cuda.get_device_name(dev)}
    for name, f in forms.items():
        ok = bool(np.array_equal(f().cpu().numpy(), ref))
        log(f"[{name}] correct={ok}")
        if not ok:
            results[name] = "wrong"
            continue
        for _ in range(3):
            f()
        torch.cuda.synchronize()
        times = []
        for _ in range(CALLS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            f()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        dt = statistics.median(times)
        log(f"[{name}] {dt*1e6:.1f} us / {E}-row gather "
            f"({E/dt/1e6:.0f}M rows/s)")
        results[name] = round(E / dt / 1e6, 1)
        results[f"{name}_us"] = dt * 1e6
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
