"""K1, K2, K3 and K4 from two checkouts of the repository on the same
inputs, bit for bit.

    python -m ndcn_tpu_torch.tools.compare_builds <other checkout>

builds the other checkout's kernels with its own build module (into its own
``build/kernels/``), loads its library beside this checkout's, and runs K2
(``fused_rhs``), K4 (``bsr_fused_rhs``), K1 (``coo_spmv``) and K3
(``bsr_spmm``) through this checkout's wrappers once with each library, on
the same inputs and plans: K2 at the shapes of ``chip_smoke.py`` [4], K4 on
the 400-node grid and a 2000-node 5 % matrix at the widths of [7] and [7b],
W as ``nn.Linear`` hands it over (a transposed view), K1 on the grid and on
a hub graph (its long rows through the chunk kernels) at d = 1, 7 and 20,
K3 on both BSR matrices at d = 20 and 256. Both libraries must export those
four one-replica C entries (and K1's bf16 one) with this checkout's
arguments. Then this
checkout's batched forms at one replica (``x[None]``) against the other's
one-replica launches at the same shapes (``batched_r1``): a replica grid of
one must be the launch it was before the replica axis.

K1 also at the widths where its wide form begins (``k1_wide``): the last
narrow and the first wide width of each load (fp32 d = 128 / 129 / 132,
bf16 256 / 257 / 264) on the hub graph, cora's and citeseer's operators at
their raw features' d = 1433 / 3703 (fp32 and bf16; forward and over the
transpose), and the narrow widths of the port's paths (the 200k operator
at d = 20 and 1, grid400 at 5, cora at 7 and 16): this checkout's wrapper
against the other's one-replica entry at the same width (the narrow form,
whatever the width). And K3's batched form at R = 25 on a 2,708-node
matrix that stores ~97 % of its blocks (cora's density) and on grid400
(``k3_batched``: d = 16 and 20, 5, 256) against the other's 25
one-replica launches, stacked.

One JSON line on stdout: for each shape whether the two outputs are equal
(``torch.equal``), the largest difference where they are not, and each
build's device time (ms per call of ten queued behind a spin kernel,
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

from ndcn_tpu_torch.data import load_planetoid
from ndcn_tpu_torch.graph import generators, operators
from ndcn_tpu_torch.graph.sparse import from_scipy_bsr_graph, from_scipy_coo
from ndcn_tpu_torch.kernels import build, bsr_spmm, coo_spmv, fused_rhs
from ndcn_tpu_torch.tools import log, require_cuda
from ndcn_tpu_torch.tools.tune_fused_plan import device_ms

ENTRIES = ("ndcn_fused_rhs_f32", "ndcn_bsr_fused_rhs_f32", "ndcn_coo_spmv_f32",
           "ndcn_coo_spmv_bf16", "ndcn_bsr_spmm_f32")


def load_other(root: Path) -> ctypes.CDLL:
    """Build the checkout at ``root`` with its own build module and load
    its library, the one-replica entries declared as this checkout's."""
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

    def both(call, this_call=None):
        """``call`` with each library; with ``this_call``, that one with
        this checkout's library instead."""
        this_call = this_call or call
        outs, ms = [], {"this": [], "other": []}
        try:
            for lib, fn in ((ours, this_call), (other, call)):
                build.load = lambda lib=lib: lib
                outs.append(fn())
            for which in ("this", "other", "other", "this"):
                lib = ours if which == "this" else other
                build.load = lambda lib=lib: lib
                ms[which].append(device_ms(this_call if which == "this"
                                           else call))
        finally:
            build.load = original
        torch.cuda.synchronize()
        equal = torch.equal(outs[0], outs[1])
        return {"equal": equal,
                "max_abs_diff": 0.0 if equal
                else float((outs[0] - outs[1]).abs().max()),
                "device_ms": ms}

    def batched_r1(call):
        """``call(lead)`` with a leading replica axis of one (this
        checkout's batched form) against ``call(None)`` (the other's
        one-replica launch)."""
        return both(lambda: call(False), lambda: call(True)[0])

    rng = np.random.RandomState(0)
    results = {"device": torch.cuda.get_device_name(dev), "k2": {}, "k4": {},
               "k1": {}, "k3": {}, "batched_r1": {}}

    def lead(t, one):
        return t[None] if one else t
    shapes = [(400, 20), (275, 13)] + [(n, k) for n in (400, 1000, 4000, 10000)
                                       for k in (20, 64, 128)]
    for n, k in shapes:
        a, h = (torch.as_tensor(rng.rand(*s).astype(np.float32), device=dev)
                for s in ((n, n), (n, k)))
        w, b = (torch.as_tensor(rng.randn(*s).astype(np.float32), device=dev)
                for s in ((k, k), (k,)))
        results["k2"][f"{n}x{k}"] = both(lambda: fused_rhs.fused_rhs(a, h, w,
                                                                     b))
        if (n, k) in ((400, 20), (275, 13), (4000, 64)):
            results["batched_r1"][f"k2_{n}x{k}"] = batched_r1(
                lambda one: fused_rhs.fused_rhs(a, lead(h, one), lead(w, one),
                                                lead(b, one)))
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
            if d in (20, 256):
                results["k3"][f"{label}_d{d}"] = both(
                    lambda: bsr_spmm.bsr_spmm(op.fwd, op.bwd, x))
                results["batched_r1"][f"k3_{label}_d{d}"] = batched_r1(
                    lambda one: bsr_spmm.bsr_spmm(op.fwd, op.bwd,
                                                  lead(x, one)))
                results["batched_r1"][f"k4_{label}_d{d}"] = batched_r1(
                    lambda one: bsr_spmm.bsr_fused_rhs(
                        op.fwd, op.bwd, lead(x, one), lead(weight.t(), one),
                        lead(b, one)))
    # K1: the grid, and a graph with a 2000-edge row (the chunk kernels)
    hub_rows = np.concatenate([rng.zipf(1.5, 40000) % 3001, np.full(2000, 7)])
    hub_cols = np.concatenate([rng.randint(0, 3001, 40000),
                               rng.choice(3001, 2000, replace=False)])
    coo = {"grid400": mats["grid400"],
           "hub3001": sp.csr_matrix((rng.randn(hub_rows.size)
                                     .astype(np.float32),
                                     (hub_rows, hub_cols)),
                                    shape=(3001, 3001))}
    for label, mat in coo.items():
        op = from_scipy_coo(mat.astype(np.float32), device=dev)
        for d in (1, 7, 20):
            x = torch.as_tensor(rng.randn(mat.shape[0], d).astype(np.float32),
                                device=dev)
            results["k1"][f"{label}_d{d}"] = both(
                lambda: coo_spmv.coo_spmv(op, x))
            results["batched_r1"][f"k1_{label}_d{d}"] = batched_r1(
                lambda one: coo_spmv.coo_spmv(op, lead(x, one)))
    # K1 where the wide form begins and at the citation graphs' widths:
    # this wrapper against the other's one-replica entry at the same width
    data = Path(__file__).resolve().parents[2] / "data"
    results["k1_wide"], results["k3_batched"] = {}, {}

    def k1_pair(label, op, d, bf16, seed):
        """This checkout's K1 against the other's one-replica entry (its
        narrow form, whatever the width)."""
        x = torch.as_tensor(np.random.RandomState(seed).randn(op.n_table, d)
                            .astype(np.float32), device=dev)
        with coo_spmv.gather_precision(bf16):
            results["k1_wide"][label] = both(
                lambda: coo_spmv.coo_spmv_narrow(op, x, bf16),
                lambda: coo_spmv.coo_spmv(op, x))
        plan = coo_spmv.gather_plan(
            d, coo_spmv._gather_width(x.to(torch.bfloat16) if bf16 else x),
            2 if bf16 else 4)
        results["k1_wide"][label]["wide"] = plan.wide

    hub = from_scipy_coo(coo["hub3001"].astype(np.float32), device=dev)
    for d, bf16 in ((128, False), (129, False), (132, False), (256, True),
                    (257, True), (264, True)):
        k1_pair(f"hub3001_d{d}{'_bf16' if bf16 else ''}", hub, d, bf16, d)
    cite = {name: load_planetoid(name, alpha=0.5, data_dir=str(data))
            for name in ("cora", "citeseer")}
    for name, d in (("cora", 1433), ("citeseer", 3703)):
        op = from_scipy_coo(cite[name].operator, device=dev)
        for bf16 in (False, True):
            for part, o in (("fwd", op), ("transpose", op.transpose())):
                k1_pair(f"{name}_d{d}_{part}{'_bf16' if bf16 else ''}", o, d,
                        bf16, d + bf16)
    big = from_scipy_coo(operators.normalized_laplacian_sparse(
        generators.build_sparse_graph(200_000, 10, seed=0)), device=dev)
    grid = from_scipy_coo(mats["grid400"].astype(np.float32), device=dev)
    cora = from_scipy_coo(cite["cora"].operator, device=dev)
    for label, op, d in (("200k_d20", big, 20), ("200k_d1", big, 1),
                         ("grid400_d5", grid, 5), ("cora_d7", cora, 7),
                         ("cora_d16", cora, 16)):
        k1_pair(label, op, d, False, d)
    del big
    # K3's batched form at 25 replicas against the other's 25 launches
    dense_blocks = (sp.random(2708, 2708, density=2.4e-4,
                              random_state=np.random.RandomState(16),
                              format="csr", dtype=np.float32)
                    + sp.eye(2708, dtype=np.float32, format="csr"))
    for label, mat, widths in (("dense_blocks", dense_blocks, (16, 256)),
                               ("grid400", mats["grid400"], (20, 5))):
        op = from_scipy_bsr_graph(mat.astype(np.float32), device=dev)
        for d in widths:
            x = torch.as_tensor(rng.rand(25, mat.shape[0], d)
                                .astype(np.float32), device=dev)
            for part, (a, at) in (("fwd", (op.fwd, op.bwd)),
                                  ("transpose", (op.bwd, op.fwd))):
                results["k3_batched"][f"{label}_d{d}_r25_{part}"] = both(
                    lambda: torch.stack([bsr_spmm.bsr_spmm(a, at, x[i])
                                         for i in range(25)]),
                    lambda: bsr_spmm.bsr_spmm(a, at, x))
            plan = bsr_spmm.bsr_batched_plan(op.fwd.n_row_blocks,
                                             op.fwd.block, d, 25)
            results["k3_batched"][f"{label}_d{d}_r25_fwd"]["group"] = \
                plan.group
    results["all_equal"] = all(r["equal"] for part in ("k2", "k4", "k1", "k3")
                               for r in results[part].values())
    results["wide_and_grouped_equal"] = all(
        r["equal"] for part in ("k1_wide", "k3_batched")
        for r in results[part].values())
    results["batched_r1_equal"] = all(
        r["equal"] for r in results["batched_r1"].values())
    log(f"K1 / K2 / K3 / K4 bit-equal to {argv[0]}: {results['all_equal']}; "
        f"batched at one replica: {results['batched_r1_equal']}; K1 at the "
        f"wide form's widths and K3 at 25 replicas: "
        f"{results['wide_and_grouped_equal']}")
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main()
