"""What the tensor core's fp32 accumulate does to a long sum.

K2 and K4 chain the three split-TF32 products of ONE staged chunk into a
fragment that starts at zero and add that fragment to the running sum with a
rounded fp32 add (``csrc/mma_split.cuh``). This probe shows why: it builds a
second copy of K2 in which the running sum itself is the ``mma``
accumulator for the whole depth, and holds both against a float64 product of
the same inputs, uniform on (0, 1), so that every term has one sign:

    python -m ndcn_tpu_torch.tools.probe_mma_accumulate

The variant is ``csrc/fused_rhs.cu`` compiled with ``-DNDCN_MMA_CHAINED``
into a library of its own; nothing of it is used by the port. One JSON line
on stdout: for each shape the largest and the mean signed error over max|y|
of the shipped kernel, of the chained variant and of the plain fp32 version.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import numpy as np
import torch

from ndcn_tpu_torch.kernels import build, fused_rhs
from ndcn_tpu_torch.kernels.platform import pin_fp32
from ndcn_tpu_torch.tools import log, require_cuda

ENTRY = "ndcn_fused_rhs_f32"


def chained_entry():
    """K2's C entry from a build in which the running sum is the ``mma``
    accumulator for the whole depth (no zeroed fragment, no rounded add)."""
    path = build.BUILD_DIR / "libndcn_fused_rhs_chained.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-DNDCN_MMA_CHAINED",
                    "-shared", "-o", str(path),
                    str(build.CSRC / "fused_rhs.cu")],
                   check=True, capture_output=True, text=True)
    fn = getattr(ctypes.CDLL(str(path)), ENTRY)
    fn.argtypes = list(build.ENTRY_POINTS[ENTRY])
    fn.restype = ctypes.c_int
    return fn


def chained_rhs(entry, a, h, w, b) -> torch.Tensor:
    n, k = h.shape
    plan = fused_rhs.fused_rhs_plan(n, k)
    out = torch.empty_like(h)
    rc = entry(a.data_ptr(), h.data_ptr(), w.data_ptr(), b.data_ptr(),
               out.data_ptr(), n, k, w.stride(0), w.stride(1), plan.rows,
               plan.nt, plan.wn, plan.bk, plan.smem_bytes,
               torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"the chained variant's launch failed: CUDA error "
                           f"{rc}")
    return out


def errors(y, ref) -> dict:
    scale = float(ref.abs().max())
    d = y.double() - ref
    return {"max": float(d.abs().max()) / scale,
            "mean_signed": float(d.mean()) / scale}


def main(argv=None) -> dict:
    dev = require_cuda()
    pin_fp32()
    shapes = ((400, 20), (4000, 64), (10000, 20), (10000, 128))
    cases = []
    for n, k in shapes:
        r = np.random.RandomState(7)
        a = torch.as_tensor(r.rand(n, n).astype(np.float32), device=dev)
        h = torch.as_tensor(r.rand(n, k).astype(np.float32), device=dev)
        cases.append((a, h, torch.eye(k, device=dev),
                      torch.zeros(k, device=dev), a.double() @ h.double()))
    results = {"device": torch.cuda.get_device_name(dev), "shapes": {}}
    shipped = [fused_rhs.fused_rhs(*c[:4]) for c in cases]
    entry = chained_entry()
    chained = [chained_rhs(entry, *c[:4]) for c in cases]
    torch.cuda.synchronize()
    for (n, k), c, y, yc in zip(shapes, cases, shipped, chained):
        rec = {"kernel": errors(y, c[4]), "chained": errors(yc, c[4]),
               "plain": errors(fused_rhs.fused_rhs_plain(*c[:4]), c[4])}
        results["shapes"][f"{n}x{k}"] = rec
        log(f"{n} x {k}: {rec}")
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
