"""K2 and K4 from two checkouts of the repository on the same inputs, bit
for bit.

    python -m ndcn_tpu_torch.tools.compare_builds <other checkout>

builds the other checkout's kernels with its own build module (into its own
``build/kernels/``), loads its library beside this checkout's, and runs K2
(``fused_rhs``) and K4 (``bsr_fused_rhs``) through this checkout's wrappers
once with each library, on the same inputs and plans: K2 at the shapes of
``chip_smoke.py`` [4], K4 on the 400-node grid and a 2000-node 5 % matrix at
the widths of [7] and [7b], W as ``nn.Linear`` hands it over (a transposed
view). Both libraries must export the two C entries with this checkout's
arguments. One JSON line on stdout: for each shape whether the two outputs
are equal (``torch.equal``), the largest difference where they are not, and
each build's device time (ms per call of ten queued behind a spin kernel,
``tune_fused_plan.device_ms``), taken in turns: this, other, other, this.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import torch

from ndcn_tpu_torch.graph import generators, operators
from ndcn_tpu_torch.graph.sparse import from_scipy_bsr_graph
from ndcn_tpu_torch.kernels import build, bsr_spmm, fused_rhs
from ndcn_tpu_torch.tools import log, require_cuda
from ndcn_tpu_torch.tools.tune_fused_plan import device_ms

ENTRIES = ("ndcn_fused_rhs_f32", "ndcn_bsr_fused_rhs_f32")


def load_other(root: Path) -> ctypes.CDLL:
    """Build the checkout at ``root`` with its own build module and load
    its library, K2's and K4's entries declared as this checkout's."""
    proc = subprocess.run(
        [sys.executable, "-c", "from ndcn_tpu_torch.kernels import build; "
         "print(build.build())"], cwd=root, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {root} failed:\n{proc.stderr}")
    lib = ctypes.CDLL(proc.stdout.strip().splitlines()[-1])
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = list(build.ENTRY_POINTS[name])
        fn.restype = ctypes.c_int
    return lib


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        raise SystemExit(__doc__)
    dev = require_cuda()
    other = load_other(Path(argv[0]).resolve())
    ours = build.load()
    original = build.load

    def both(call):
        outs, ms = [], {"this": [], "other": []}
        try:
            for lib in (ours, other):
                build.load = lambda lib=lib: lib
                outs.append(call())
            for which in ("this", "other", "other", "this"):
                lib = ours if which == "this" else other
                build.load = lambda lib=lib: lib
                ms[which].append(device_ms(call))
        finally:
            build.load = original
        torch.cuda.synchronize()
        equal = torch.equal(outs[0], outs[1])
        return {"equal": equal,
                "max_abs_diff": 0.0 if equal
                else float((outs[0] - outs[1]).abs().max()),
                "device_ms": ms}

    rng = np.random.RandomState(0)
    results = {"device": torch.cuda.get_device_name(dev), "k2": {}, "k4": {}}
    shapes = [(400, 20), (275, 13)] + [(n, k) for n in (400, 1000, 4000, 10000)
                                       for k in (20, 64, 128)]
    for n, k in shapes:
        a, h = (torch.as_tensor(rng.rand(*s).astype(np.float32), device=dev)
                for s in ((n, n), (n, k)))
        w, b = (torch.as_tensor(rng.randn(*s).astype(np.float32), device=dev)
                for s in ((k, k), (k,)))
        results["k2"][f"{n}x{k}"] = both(lambda: fused_rhs.fused_rhs(a, h, w,
                                                                     b))
    mats = {"grid400": sp.csr_matrix(operators.normalized_laplacian(
        generators.build_network("grid", 400))),
        "2000": sp.csr_matrix(rng.rand(2000, 2000)
                              * (rng.rand(2000, 2000) < 0.05))}
    for label, mat in mats.items():
        op = from_scipy_bsr_graph(mat.astype(np.float32), device=dev)
        for d in (20, 128, 256, 512):
            x = torch.as_tensor(rng.rand(mat.shape[0], d).astype(np.float32),
                                device=dev)
            weight = torch.as_tensor((rng.randn(d, d) / np.sqrt(d))
                                     .astype(np.float32), device=dev)
            b = torch.as_tensor((0.1 * rng.randn(d)).astype(np.float32),
                                device=dev)
            results["k4"][f"{label}_d{d}"] = both(
                lambda: bsr_spmm.bsr_fused_rhs(op.fwd, op.bwd, x, weight.t(),
                                               b))
    results["all_equal"] = all(r["equal"] for part in ("k2", "k4")
                               for r in results[part].values())
    log(f"K2 / K4 bit-equal to {argv[0]}: {results['all_equal']}")
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
