"""The multi-rank dryrun: the node-sharded NDCN path on N ranks, every check
against the same computation unsharded, as ``ndcn_tpu/parallel/dryrun.py``
checks its 8-device CPU mesh.

    python -m ndcn_tpu_torch.parallel.dryrun N

starts N rank processes: NCCL on N cards by default (``--device cuda``),
gloo on the CPU with ``--device cpu``; fewer than N visible cards, none
included, is an error that names ``--device cpu``, never a quiet switch to
the CPU. It lays them out as one model axis of N (checks 1-5) and as
``make_mesh``'s (data, model) factorization (check 6), and prints on rank
0:

1. the dense dopri5 train step, operator rows and state row-sharded: loss
   and updated parameters against the same step unsharded (rel-L1 <=
   1e-5);
2. the row-sharded COO SpMV (K1 on each rank's row block, the backward
   over Aᵀ's block) on a graph with a hub row longer than ``SPLIT_EDGES``
   and a node count the ranks do not divide: forward and gradient against
   the unsharded product (<= 1e-5);
3. the sparse train step: dopri5 over the row-sharded COO operator against
   the dense unsharded step (<= 1e-5);
4. feature-major x mesh: the rk4 loss and gradients of the (d_sub, n)
   solve over the row-sharded operator (``rs_spmv_T``: K1-fm's pack, the
   all-gathered table, the gather on the row block) against the unsharded
   feature-major solve (<= 1e-5), and against the dense (n, d) solve (the
   JAX dryrun's 1e-4 / 1e-3: the layouts differ);
5. every rank's NFE equal and its parameters after the steps bit-equal to
   rank 0's;
6. the replica sweep on the (data, model) mesh of ``make_mesh``'s default
   factorization (2 x 2 on 4 ranks): 2 · data replicas over the data
   ranks, each replica's nodes over the model ranks (K1's batched form on
   the row blocks): the replicas' losses and updated parameters against
   the same replicas unsharded (<= 1e-5), each replica's NFE equal; and
   the same sweep's step on the batched continuous adjoint;
7. the continuous adjoint on a model axis of N (COO, dopri5): the
   gradients against the unsharded adjoint's (<= 1e-4), the loss (<=
   1e-5), forward and backward NFE equal;
8. one lstm_gnn train step with dropout on the row-sharded Kipf operator
   (K1 on each row block at d = 5; the cell's input projection summed
   over the ranks): loss and gradients against the unsharded step (<=
   1e-5);
9. GCN, DeepGCN2 and DeepGCN3 on the row-sharded COO operator: one
   cross-entropy step with dropout, loss and gradients against the
   unsharded step (<= 1e-5), and deterministic logits and gradients
   saved for the tests;
10. every rank's parameters after the steps of 7-9 and 11 bit-equal to rank
    0's;
11. ``--scan_chunk`` on the model axis: a ``train.chunk.TrainChunk`` of
    two steps (the bounded solve, ``CapturableAdam``, dropout drawn
    whole) with dopri5, with adams and with the dopri5 continuous adjoint
    over the row-sharded COO operator, one host read, against the same
    chunk unsharded: the last loss (<= 1e-5), every step's NFE (and the
    adjoint's every backward interval's) equal, and every rank's
    parameters after the chunk bit-equal to rank 0's (with check 10).

Each rank is a process of its own (``python -m ndcn_tpu_torch.parallel.dryrun
--rank r ...``), imports only the port, and pins one intra-op thread; the
parent waits ``--timeout`` seconds and kills the ranks on expiry, so a
collective that hangs fails the run. With ``--out DIR`` each rank also
writes its arrays to DIR/rank<r>.npz (the tests hold them against the JAX
package: checks 7-9 at the weights of ``ndcn_model``, ``temporal_model``
and ``zoo_model``, rebuilt from their seeds).
"""

from __future__ import annotations

import argparse
import copy
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np

TOL = 1e-5          # sharded against unsharded, as the JAX dryrun
N_NODES = 500       # the train steps' graph (the model axis divides it)
N_HUB = 502         # the SpMV check's graph: a hub row, uneven blocks
HUB_EDGES = 400     # edges of the hub row (over SPLIT_EDGES)
D_SPMV = 5
HIDDEN = 8
T_TEMPORAL = 6      # the lstm_gnn step's observed steps
H_GNN, H_RNN = 5, 10
ZOO = ("GCN", "DeepGCN2", "DeepGCN3")
ZOO_FEATURES, ZOO_HIDDEN, ZOO_CLASSES, ZOO_NHL = 64, 16, 5, 2
DROPOUT = 0.3


def train_problem(n: int = N_NODES, seed: int = 0) -> Dict[str, np.ndarray]:
    """The train steps' problem, from numpy: the normalized Laplacian of a
    random sparse graph (dense and CSR), x0 and a target trajectory."""
    import scipy.sparse as sp

    from ndcn_tpu_torch.graph.generators import build_sparse_graph
    from ndcn_tpu_torch.graph.operators import normalized_laplacian_sparse

    lap = normalized_laplacian_sparse(build_sparse_graph(n, 6, seed))
    rs = np.random.RandomState(seed + 1)
    vt = np.linspace(0.0, 1.0, 5).astype(np.float32)
    return dict(lap=sp.csr_matrix(lap, dtype=np.float32),
                x0=rs.uniform(0.0, 5.0, (n, 1)).astype(np.float32),
                target=rs.uniform(0.0, 5.0, (len(vt), n, 1))
                .astype(np.float32), vt=vt)


def spmv_problem(n: int = N_HUB, d: int = D_SPMV, seed: int = 3):
    """A non-symmetric sparse matrix with a hub row (and hub column) of
    ``HUB_EDGES`` edges, and an (n, d) state."""
    import scipy.sparse as sp

    rs = np.random.RandomState(seed)
    m = 6 * n
    rows = np.concatenate([rs.randint(0, n, m), np.full(HUB_EDGES, 7),
                           rs.choice(n, HUB_EDGES, replace=False)])
    cols = np.concatenate([rs.randint(0, n, m),
                           rs.choice(n, HUB_EDGES, replace=False),
                           np.full(HUB_EDGES, 11)])
    mat = sp.coo_matrix((rs.randn(rows.size).astype(np.float32) / 6,
                         (rows, cols)), shape=(n, n)).tocsr()
    mat.sum_duplicates()
    return mat, rs.randn(n, d).astype(np.float32)


def kipf_problem(n: int = N_NODES, seed: int = 0) -> Dict[str, np.ndarray]:
    """The lstm_gnn and zoo steps' problem: the Kipf operator of the train
    steps' graph (CSR), a node series (n, T_TEMPORAL + 1), features (n,
    ZOO_FEATURES), labels and a train split."""
    import scipy.sparse as sp

    from ndcn_tpu_torch.graph.generators import build_sparse_graph
    from ndcn_tpu_torch.graph.operators import zipf_smoothing

    adj = build_sparse_graph(n, 6, seed).toarray()
    np.fill_diagonal(adj, 0.0)
    rs = np.random.RandomState(seed + 2)
    return dict(kipf=sp.csr_matrix(zipf_smoothing(adj)),
                series=rs.uniform(0.0, 5.0, (n, T_TEMPORAL + 1))
                .astype(np.float32),
                features=rs.rand(n, ZOO_FEATURES).astype(np.float32),
                labels=rs.randint(0, ZOO_CLASSES, n).astype(np.int64),
                idx_train=np.sort(rs.choice(n, n // 4, replace=False)))


def ndcn_model(seed: int, device=None):
    from ndcn_tpu_torch.models import init_ndcn

    import torch

    return init_ndcn(torch.Generator().manual_seed(seed), 1, HIDDEN, 1,
                     device=device)


def temporal_model(n: int = N_NODES, device=None):
    """Check 8's lstm_gnn, the dynamics driver's widths."""
    import torch

    from ndcn_tpu_torch.models import init_temporal_gcn

    return init_temporal_gcn(torch.Generator().manual_seed(5), 1, H_GNN, n,
                             H_RNN, "lstm", device=device)


def zoo_model(name: str, n: int = N_NODES, device=None):
    """Check 9's zoo model ``name``."""
    import torch

    from ndcn_tpu_torch.models.gcn_zoo import build_zoo_model

    model = build_zoo_model(name, ZOO_FEATURES, ZOO_HIDDEN, ZOO_CLASSES, n,
                            ZOO_NHL, generator=torch.Generator().manual_seed(
                                7), dropout=DROPOUT)
    return model.to(device) if device is not None else model


def flat_tree(tree, prefix: str) -> Dict[str, np.ndarray]:
    """A nested dict / list of arrays (a JAX parameter tree) as flat npz
    keys ``prefix/key/...``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out: Dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(flat_tree(v, f"{prefix}/{k}"))
    return out


def rel_l1(a, b) -> float:
    a = np.concatenate([np.ravel(np.asarray(x, np.float64)) for x in a])
    b = np.concatenate([np.ravel(np.asarray(x, np.float64)) for x in b])
    return float(np.abs(a - b).sum() / (np.abs(b).sum() + 1e-30))


def _params(model) -> List[np.ndarray]:
    return [p.detach().cpu().numpy().copy() for p in model.parameters()]


def _grads(model) -> List[np.ndarray]:
    """Each parameter's gradient (zeros for one the forward does not use,
    as ``jax.grad`` gives it)."""
    return [np.zeros(tuple(p.shape), np.float32) if p.grad is None
            else p.grad.detach().cpu().numpy().copy()
            for p in model.parameters()]


def _tree(model, arrays: List[np.ndarray], prefix: str) -> dict:
    """The arrays (one per parameter, the model's order) as flat npz keys
    of the JAX package's parameter tree (``flat_tree``)."""
    from ndcn_tpu_torch.convert import model_to_jax

    return flat_tree(model_to_jax(_holder(model, arrays)), prefix)


def run_checks(rank: int, world: int, device, out: Optional[str] = None,
               log=print) -> Dict[str, float]:
    """The checks on one rank of a started process group; returns their
    rel-L1 values (and raises on a failed one)."""
    import torch
    import torch.distributed as dist

    from ndcn_tpu_torch.graph import sparse as graph_sparse
    from ndcn_tpu_torch.graph.sparse import (from_dense, from_scipy_coo,
                                             matvec)
    from ndcn_tpu_torch.kernels.coo_spmv import spmv_T, sublane_pad
    from ndcn_tpu_torch.kernels.platform import pin_fp32
    from ndcn_tpu_torch.models import init_ndcn, ndcn_forward
    from ndcn_tpu_torch.parallel.coo_shard import (gather_nodes, node_group,
                                                   rs_spmv_T, shard_coo_rows,
                                                   take_rows)
    from ndcn_tpu_torch.parallel.mesh import (all_reduce_grads,
                                              gather_replicas, make_mesh,
                                              replica_range)
    from ndcn_tpu_torch.parallel.sweep import (batched_init, gather_stacked,
                                               place_problem_on_mesh,
                                               replica_generators,
                                               replica_l1)
    from ndcn_tpu_torch.train.losses import l1_loss
    from ndcn_tpu_torch.train.optim import make_replica_sgd_step, torch_adam

    pin_fp32()
    mesh = make_mesh(device, data_divides=1)
    if rank == 0:
        log(f"mesh: {world} ranks = data={mesh.data} x model={mesh.model} "
            f"on {device.type} ({dist.get_backend()})")
    saved: Dict[str, np.ndarray] = {}
    checks: Dict[str, float] = {}
    nfes: List[int] = []

    def expect(name: str, value: float, tol: float = TOL) -> None:
        checks[name] = value
        if not value <= tol:
            raise AssertionError(f"dryrun check {name}: {value:.3e} > {tol}")

    pb = train_problem()
    t = lambda a: torch.as_tensor(a, device=device)   # noqa: E731
    x0, target = t(pb["x0"]), t(pb["target"])

    def train_step(op, x0_, target_, seed, tag):
        """One dopri5 Adam step from the seed's init on ``op``; returns
        (loss, the model after the step, the summed gradients)."""
        model = init_ndcn(torch.Generator().manual_seed(seed), 1, HIDDEN, 1,
                          device=device)
        init = _params(model)
        opt = torch_adam(model.parameters(), 0.01, 1e-3)
        group = node_group(op)
        out, stats = ndcn_forward(model, op, pb["vt"], x0_, method="dopri5",
                                  max_steps=64)
        loss = l1_loss(out, target_, group)
        loss.backward()
        all_reduce_grads(model.parameters(), group)
        grads = _grads(model)
        opt.step()
        nfes.append(stats.nfe)
        saved.update(_tree(model, init, f"{tag}/init"))
        saved.update(_tree(model, grads, f"{tag}/grad"))
        saved[f"{tag}/loss"] = np.float32(loss.item())
        saved[f"{tag}/nfe"] = np.int64(stats.nfe)
        return float(loss.detach()), model, grads

    # ---- 1. the dense step, rows sharded, against unsharded
    dense = from_dense(pb["lap"].toarray(), device=device)
    l_u, m_u, _ = train_step(dense, x0, target, 0, "dense_unsharded")
    op_s, x0_s, target_s, _ = place_problem_on_mesh(mesh, dense, x0, target,
                                                    pb["vt"])
    l_s, m_s, _ = train_step(op_s, x0_s, target_s, 0, "dense")
    d_loss, d_par = rel_l1([l_s], [l_u]), rel_l1(_params(m_s), _params(m_u))
    expect("dense_step_loss", d_loss)
    expect("dense_step_params", d_par)
    if rank == 0:
        log(f"sharded dense dopri5 train step vs unsharded: rel-L1 "
            f"loss={d_loss:.3e} params={d_par:.3e} (loss {l_s:.6f})")

    # ---- 2. the row-sharded COO SpMV, forward and gradient
    mat, x_np = spmv_problem()
    coo = from_scipy_coo(mat, device=device)
    rs = shard_coo_rows(coo, mesh)
    x_whole = t(x_np)
    x_loc = take_rows(x_whole, rs).clone().requires_grad_()
    y_loc = matvec(rs, x_loc)
    (y_loc * y_loc).sum().backward()
    xw = x_whole.clone().requires_grad_()
    y_ref = matvec(coo, xw)
    (y_ref * y_ref).sum().backward()
    y_all = gather_nodes(y_loc.detach(), rs)
    dx_all = gather_nodes(x_loc.grad, rs)
    d_fwd = rel_l1([y_all.cpu()], [y_ref.detach().cpu()])
    d_grad = rel_l1([dx_all.cpu()], [xw.grad.cpu()])
    expect("coo_spmv_fwd", d_fwd)
    expect("coo_spmv_grad", d_grad)
    saved.update(coo_y=y_loc.detach().cpu().numpy(),
                 coo_dx=x_loc.grad.cpu().numpy(),
                 coo_rows=np.array([rs.start, rs.stop]))
    if rank == 0:
        log(f"row-sharded COO SpMV (K1 on each row block, hub row of "
            f"{HUB_EDGES} edges, n={mat.shape[0]} over {world}): rel-L1 "
            f"fwd={d_fwd:.3e} grad={d_grad:.3e}")

    # ---- 3. the sparse step against the dense unsharded step
    coo_t = from_scipy_coo(pb["lap"], device=device)
    op_c, x0_c, target_c, _ = place_problem_on_mesh(mesh, coo_t, x0, target,
                                                    pb["vt"])
    l_c, m_c, _ = train_step(op_c, x0_c, target_c, 1, "coo")
    l_d, m_d, _ = train_step(dense, x0, target, 1, "coo_dense_unsharded")
    d_sl, d_sp = rel_l1([l_c], [l_d]), rel_l1(_params(m_c), _params(m_d))
    expect("sparse_step_loss", d_sl)
    expect("sparse_step_params", d_sp)
    if rank == 0:
        log(f"sparse train-step parity (row-sharded COO vs dense "
            f"unsharded): rel-L1 loss={d_sl:.3e} params={d_sp:.3e}")

    # ---- 4. feature-major x mesh (the layout needs the seam on the CPU)
    seam = graph_sparse.use_tiled_kernel
    graph_sparse.use_tiled_kernel = lambda op: True
    try:
        def fm(op, x0_, target_, layout):
            model = init_ndcn(torch.Generator().manual_seed(2), 1, 6, 1,
                              device=device)
            out, stats = ndcn_forward(model, op, pb["vt"], x0_,
                                      method="rk4", max_steps=8,
                                      layout=layout)
            loss = l1_loss(out, target_, node_group(op))
            loss.backward()
            all_reduce_grads(model.parameters(), node_group(op))
            return float(loss.detach()), _grads(model)

        l_fm, g_fm = fm(op_c, x0_c, target_c, "feature_major")
        l_fu, g_fu = fm(coo_t, x0, target, "feature_major")
        l_nd, g_nd = fm(dense, x0, target, "nd")
        # the table product itself, forward and over Aᵀ
        d_sub = sublane_pad(D_SPMV)
        xT = torch.zeros((d_sub, mat.shape[0]), device=device)
        xT[:D_SPMV] = x_whole.t()
        xT_loc = take_rows(xT, rs, axis=1).clone().requires_grad_()
        yT = rs_spmv_T(rs, xT_loc)
        (yT * yT).sum().backward()
        xTw = xT.clone().requires_grad_()
        yTw = spmv_T(coo, xTw)
        (yTw * yTw).sum().backward()
    finally:
        graph_sparse.use_tiled_kernel = seam
    d_fm = rel_l1([l_fm], [l_fu])
    d_fmg = rel_l1(g_fm, g_fu)
    d_fmt = rel_l1([gather_nodes(yT.detach(), rs, axis=1).cpu()],
                   [yTw.detach().cpu()])
    d_fmtg = rel_l1([gather_nodes(xT_loc.grad, rs, axis=1).cpu()],
                    [xTw.grad.cpu()])
    expect("feature_major_loss", d_fm)
    expect("feature_major_grads", d_fmg)
    expect("feature_major_spmv_fwd", d_fmt)
    expect("feature_major_spmv_grad", d_fmtg)
    expect("feature_major_vs_nd_loss", rel_l1([l_fm], [l_nd]), 1e-4)
    expect("feature_major_vs_nd_grads", rel_l1(g_fm, g_nd), 1e-3)
    saved.update(fm_y=yT.detach().cpu().numpy(),
                 fm_dx=xT_loc.grad.cpu().numpy())
    if rank == 0:
        log(f"feature-major x mesh parity (sharded (d_sub, n) rk4 vs "
            f"unsharded): rel loss={d_fm:.3e} grads={d_fmg:.3e}; rs_spmv_T "
            f"fwd={d_fmt:.3e} grad={d_fmtg:.3e}; vs dense (n, d): loss="
            f"{checks['feature_major_vs_nd_loss']:.3e} grads="
            f"{checks['feature_major_vs_nd_grads']:.3e}")

    # ---- 5. every rank the same steps and the same parameters
    all_nfe = [None] * world
    dist.all_gather_object(all_nfe, nfes)
    flat = torch.cat([p.detach().reshape(-1)
                      for m in (m_s, m_c) for p in m.parameters()])
    every = [torch.empty_like(flat) for _ in range(world)]
    dist.all_gather(every, flat)
    same_nfe = all(v == all_nfe[0] for v in all_nfe)
    same_params = all(torch.equal(v, every[0]) for v in every)
    checks["nfe_equal"] = float(same_nfe)
    checks["params_bit_equal"] = float(same_params)
    if not (same_nfe and same_params):
        raise AssertionError(f"the ranks parted: NFE {all_nfe}, parameters "
                             f"bit-equal {same_params}")
    if rank == 0:
        log(f"every rank: the NFE of its {len(nfes)} solves {all_nfe[0]} "
            f"(equal on {world} ranks), parameters after the steps "
            f"bit-equal")
    # ---- 6. the replica sweep on the (data, model) mesh: R replicas over
    # the data ranks, each replica's nodes over the model ranks (K1's
    # batched form on the row blocks), against the R replicas unsharded
    mesh2 = make_mesh(device)
    r_all = 2 * mesh2.data
    lo, hi = replica_range(mesh2, r_all)
    op_r, x0_r, target_r, _ = place_problem_on_mesh(mesh2, coo_t, x0, target,
                                                    pb["vt"])

    def replica_step(op, x0_, target_, which, adjoint=False):
        gens = replica_generators(3, r_all)[which]
        model = batched_init(lambda g: init_ndcn(g, 1, HIDDEN, 1),
                             gens, device=device)
        init = gather_stacked(model, mesh2.data_group if op is op_r
                              else None)
        opt = torch_adam(model.parameters(), 0.01, 1e-3)
        stats_box = []

        def losses_fn():
            out, stats = ndcn_forward(model, op, pb["vt"], x0_,
                                      method="dopri5", max_steps=64,
                                      adjoint=adjoint)
            stats_box.append(stats)
            losses = replica_l1(out.transpose(0, 1), target_, node_group(op))
            return losses, losses

        losses = make_replica_sgd_step(opt, losses_fn, node_group(op))()[0]
        return losses, model, init, stats_box[0]

    l_r, m_r, init_r, st_r = replica_step(op_r, x0_r, target_r,
                                          slice(lo, hi))
    l_ru, m_ru, _, st_ru = replica_step(coo_t, x0, target, slice(0, r_all))
    l_r = gather_replicas(l_r, mesh2.data_group)
    every_r = gather_stacked(m_r, mesh2.data_group)
    d_rl = rel_l1([l_r.cpu()], [l_ru.cpu()])
    d_rp = rel_l1(_params(every_r), _params(m_ru))
    expect("replica_step_losses", d_rl)
    expect("replica_step_params", d_rp)
    nfe_r = gather_replicas(torch.tensor(st_r.nfe, device=device),
                            mesh2.data_group).tolist()
    if nfe_r != list(st_ru.nfe):
        raise AssertionError(f"the replicas' NFE parted: {nfe_r} against "
                             f"{list(st_ru.nfe)} unsharded")
    if rank == 0:
        log(f"replica sweep on data={mesh2.data} x model={mesh2.model}: "
            f"{r_all} replicas, rel-L1 losses={d_rl:.3e} params="
            f"{d_rp:.3e} against the {r_all} replicas unsharded; NFE "
            f"{nfe_r} equal")
    # the same sweep's step on the batched continuous adjoint: the
    # replicas over the data ranks, each augmented solve's nodes over the
    # model ranks
    l_ra, m_ra, _, st_ra = replica_step(op_r, x0_r, target_r,
                                        slice(lo, hi), adjoint=True)
    l_rau, m_rau, _, st_rau = replica_step(coo_t, x0, target,
                                           slice(0, r_all), adjoint=True)
    d_ral = rel_l1([gather_replicas(l_ra, mesh2.data_group).cpu()],
                   [l_rau.cpu()])
    d_rap = rel_l1(_params(gather_stacked(m_ra, mesh2.data_group)),
                   _params(m_rau))
    expect("replica_adjoint_step_losses", d_ral)
    expect("replica_adjoint_step_params", d_rap)
    back_r = gather_replicas(torch.tensor(
        [sum(b.nfe[i] for b in st_ra.backward)
         for i in range(hi - lo)], device=device), mesh2.data_group).tolist()
    back_ru = [sum(b.nfe[i] for b in st_rau.backward) for i in range(r_all)]
    if back_r != back_ru:
        raise AssertionError(f"the replicas' backward NFE parted: {back_r} "
                             f"against {back_ru} unsharded")
    if rank == 0:
        log(f"replica sweep on the batched adjoint, data={mesh2.data} x "
            f"model={mesh2.model}: rel-L1 losses={d_ral:.3e} params="
            f"{d_rap:.3e}; backward NFE {back_r} equal")

    checks.update(run_model_axis_checks(rank, world, device, mesh, saved,
                                        expect, log))

    if out is not None:
        from ndcn_tpu_torch.convert import params_to_jax

        saved.update({f"replicas/init/{layer}/{k}": v
                      for layer, leaves in params_to_jax(init_r).items()
                      for k, v in leaves.items()})
        saved["replicas/loss"] = l_r.cpu().numpy()
        saved["replicas/params_after"] = torch.cat(
            [p.detach().reshape(-1) for p in every_r.parameters()]
        ).cpu().numpy()
        saved["params_after"] = flat.cpu().numpy()
        np.savez(os.path.join(out, f"rank{rank}.npz"), **saved)
    return checks


def run_model_axis_checks(rank: int, world: int, device, mesh, saved,
                          expect, log=print) -> Dict[str, float]:
    """Checks 7-11 on the mesh's model axis (every rank): the continuous
    adjoint, the lstm_gnn step, the GCN zoo and the chunked steps on
    row-sharded operators, each against the same step unsharded; fills
    ``saved`` for the tests."""
    import torch
    import torch.distributed as dist

    from ndcn_tpu_torch.convert import model_to_jax
    from ndcn_tpu_torch.graph.sparse import from_scipy_coo
    from ndcn_tpu_torch.models import ndcn_forward, temporal_gcn_forward
    from ndcn_tpu_torch.parallel.coo_shard import (gather_nodes, node_group,
                                                   take_index, take_rows)
    from ndcn_tpu_torch.parallel.mesh import all_reduce_grads
    from ndcn_tpu_torch.parallel.sweep import (place_problem_on_mesh,
                                               shard_operator)
    from ndcn_tpu_torch.train.losses import cross_entropy, l1_loss
    from ndcn_tpu_torch.train.optim import torch_adam

    checks: Dict[str, float] = {}
    stepped = []            # the models after their steps (check 10)
    t = lambda a: torch.as_tensor(a, device=device)   # noqa: E731

    def sgd(model, loss_fn, group):
        """One Adam step of ``loss_fn(model)``, the gradients summed over
        the model group (``train.optim.make_sgd_step``'s update); (loss,
        gradients)."""
        opt = torch_adam(model.parameters(), 0.01, 1e-3)
        loss = loss_fn(model)
        loss.backward()
        all_reduce_grads(model.parameters(), group)
        grads = _grads(model)
        opt.step()
        stepped.append(model)
        return float(loss.detach()), grads

    # ---- 7. the continuous adjoint on the model axis
    pb = train_problem()
    coo = from_scipy_coo(pb["lap"], device=device)
    x0, target = t(pb["x0"]), t(pb["target"])
    op_s, x0_s, target_s, _ = place_problem_on_mesh(mesh, coo, x0, target,
                                                    pb["vt"])

    def adjoint_step(op, x0_, target_, tag):
        model = ndcn_model(4, device)
        box = []

        def loss_fn(m):
            out, stats = ndcn_forward(m, op, pb["vt"], x0_, method="dopri5",
                                      max_steps=64, adjoint=True)
            box.append(stats)
            return l1_loss(out, target_, node_group(op))

        init = _params(model)
        loss, grads = sgd(model, loss_fn, node_group(op))
        stats = box[0]
        back = [b.nfe for b in stats.backward]
        saved.update(_tree(model, init, f"{tag}/init"))
        saved.update(_tree(model, grads, f"{tag}/grad"))
        saved[f"{tag}/loss"] = np.float32(loss)
        saved[f"{tag}/nfe"] = np.int64(stats.nfe)
        saved[f"{tag}/nfe_backward"] = np.array(back, np.int64)
        return loss, grads, stats.nfe, back

    l_a, g_a, nfe_a, back_a = adjoint_step(op_s, x0_s, target_s, "adjoint")
    l_u, g_u, nfe_u, back_u = adjoint_step(coo, x0, target,
                                           "adjoint_unsharded")
    d_l, d_g = rel_l1([l_a], [l_u]), rel_l1(g_a, g_u)
    expect("adjoint_loss", d_l)
    expect("adjoint_grads", d_g, 1e-4)
    if (nfe_a, back_a) != (nfe_u, back_u):
        raise AssertionError(f"the sharded adjoint's NFE {nfe_a} / "
                             f"{back_a} against {nfe_u} / {back_u}")
    if rank == 0:
        log(f"continuous adjoint on a model axis of {mesh.model} (COO, "
            f"dopri5) vs unsharded: rel-L1 loss={d_l:.3e} grads={d_g:.3e}; "
            f"NFE {nfe_a} forward, {sum(back_a)} backward, equal")

    # ---- 8. one lstm_gnn step with dropout
    kp = kipf_problem()
    kipf = from_scipy_coo(kp["kipf"], device=device)
    kipf_s = shard_operator(mesh, kipf)
    series = t(kp["series"])

    def temporal_step(op, tag):
        x_seq = take_rows(series, op)
        gen = torch.Generator().manual_seed(9)

        def loss_fn(m):
            pred = temporal_gcn_forward(m, op, x_seq[:, :-1], "lstm",
                                        dropout=DROPOUT, generator=gen,
                                        deterministic=False)
            return l1_loss(pred, x_seq[:, 1:], node_group(op))

        model = temporal_model(device=device)
        loss, grads = sgd(model, loss_fn, node_group(op))
        saved.update(_tree(model, grads, f"{tag}/grad"))
        saved[f"{tag}/loss"] = np.float32(loss)
        return loss, grads

    l_t, g_t = temporal_step(kipf_s, "temporal")
    l_tu, g_tu = temporal_step(kipf, "temporal_unsharded")
    d_tl, d_tg = rel_l1([l_t], [l_tu]), rel_l1(g_t, g_tu)
    expect("temporal_loss", d_tl)
    expect("temporal_grads", d_tg)
    if rank == 0:
        log(f"lstm_gnn step with dropout on the row-sharded Kipf operator "
            f"vs unsharded: rel-L1 loss={d_tl:.3e} grads={d_tg:.3e}")

    # ---- 9. the GCN zoo, with dropout and deterministic
    feats, labels = t(kp["features"]), t(kp["labels"])
    idx = t(kp["idx_train"])
    for name in ZOO:
        def zoo_step(op, gen):
            x, y, i = take_rows(feats, op), take_rows(labels, op), \
                take_index(idx, op)
            box = []

            def loss_fn(m):
                logits = m(op, x, gen, gen is None)
                box.append(logits.detach())
                return cross_entropy(logits[i], y[i], node_group(op))

            model = zoo_model(name, device=device)
            loss, grads = sgd(model, loss_fn, node_group(op))
            return loss, grads, box[0], model

        d = {}
        for drop in (True, False):
            runs = [zoo_step(op, torch.Generator().manual_seed(11) if drop
                             else None) for op in (kipf_s, kipf)]
            (l_z, g_z, lg_z, m_z), (l_zu, g_zu, lg_zu, _) = runs
            tag = "drop" if drop else "det"
            d[f"{tag}_loss"] = rel_l1([l_z], [l_zu])
            d[f"{tag}_grads"] = rel_l1(g_z, g_zu)
            d[f"{tag}_logits"] = rel_l1(
                [gather_nodes(lg_z, kipf_s).cpu()], [lg_zu.cpu()])
            for k in ("loss", "grads", "logits"):
                expect(f"zoo_{name}_{tag}_{k}", d[f"{tag}_{k}"])
        saved[f"zoo/{name}/logits"] = lg_z.cpu().numpy()
        saved[f"zoo/{name}/loss"] = np.float32(l_z)
        saved.update(flat_tree(model_to_jax(_holder(m_z, g_z)),
                               f"zoo/{name}/grad"))
        if rank == 0:
            log(f"{name} on the row-sharded COO operator vs unsharded: "
                + ", ".join(f"{k}={v:.3e}" for k, v in d.items()))

    # ---- 11. --scan_chunk on the model axis
    chunked = scan_chunk_check(rank, device, coo, op_s, x0, x0_s, target,
                               target_s, saved, expect, log)

    # ---- 10. every rank the same parameters after the steps
    stepped.extend(chunked)
    flat = torch.cat([p.detach().reshape(-1) for m in stepped
                      for p in m.parameters()])
    every = [torch.empty_like(flat) for _ in range(world)]
    dist.all_gather(every, flat)
    same = all(torch.equal(v, every[0]) for v in every)
    checks["model_axis_params_bit_equal"] = float(same)
    if not same:
        raise AssertionError("the ranks' parameters parted after the "
                             "adjoint, temporal and zoo steps")
    saved["model_axis_params_after"] = flat.cpu().numpy()
    if rank == 0:
        log(f"every rank: parameters after the adjoint, lstm_gnn, zoo and "
            f"chunked steps bit-equal on {world} ranks")
    return checks


def scan_chunk_check(rank: int, device, coo, op_s, x0, x0_s, target,
                     target_s, saved, expect, log=print):
    """Check 11: two chunked steps on the row-sharded operator against the
    same chunk unsharded, dopri5, adams and the dopri5 adjoint; returns the
    sharded models (check 10 holds their parameters equal on every
    rank)."""
    import torch

    from ndcn_tpu_torch.models import ndcn_forward
    from ndcn_tpu_torch.parallel.coo_shard import node_group
    from ndcn_tpu_torch.train.chunk import TrainChunk
    from ndcn_tpu_torch.train.losses import l1_loss
    from ndcn_tpu_torch.train.optim import make_sgd_step, torch_adam

    pb = train_problem()
    vt = torch.as_tensor(pb["vt"], device=device)
    models = []
    for label, method, adjoint in (("dopri5", "dopri5", False),
                                   ("adams", "adams", False),
                                   ("dopri5_adjoint", "dopri5", True)):
        runs = []
        for op, x0_, target_ in ((op_s, x0_s, target_s), (coo, x0, target)):
            model = ndcn_model(5, device)
            opt = torch_adam(model.parameters(), 0.01, 1e-3, capturable=True)
            # a CUDA graph draws its masks from a generator on the card
            gen = torch.Generator(device).manual_seed(12)
            group = node_group(op)
            nfe, solves = [], []

            def loss_fn(g, model=model, op=op, x0_=x0_, target_=target_,
                        group=group, nfe=nfe, solves=solves):
                out, stats = ndcn_forward(model, op, vt, x0_, method=method,
                                          max_steps=24, dropout=DROPOUT,
                                          rng=g, scan=True, adjoint=adjoint)
                nfe.append(stats.nfe)
                solves.append(stats)
                loss = l1_loss(out, target_, group)
                loss = torch.where(stats.success, loss,
                                   torch.full_like(loss, float("nan")))
                return loss, loss

            step = make_sgd_step(opt, loss_fn, group)
            chunk = TrainChunk(lambda step=step, gen=gen: step(gen),
                               model.parameters(), opt, gen)
            loss, _ = chunk(2)
            # the adjoint's NFE of every backward interval, step by step
            back = [[int(b.nfe) for b in st.backward] for st in solves
                    ] if adjoint else []
            runs.append((loss, [int(n) for n in nfe], back,
                         chunk.host_reads, model))
        (l_c, nfe_c, back_c, reads, m_c), (l_u, nfe_u, back_u, _, _) = runs
        d_l = rel_l1([l_c], [l_u])
        expect(f"scan_chunk_{label}_loss", d_l)
        if nfe_c != nfe_u or back_c != back_u or reads != 1:
            raise AssertionError(f"the sharded chunk ({label}) took NFE "
                                 f"{nfe_c} / {back_c} against {nfe_u} / "
                                 f"{back_u}, {reads} host reads")
        saved[f"scan_chunk/{label}/loss"] = np.float32(l_c)
        saved[f"scan_chunk/{label}/loss_unsharded"] = np.float32(l_u)
        saved[f"scan_chunk/{label}/nfe"] = np.array(nfe_c, np.int64)
        saved[f"scan_chunk/{label}/nfe_unsharded"] = np.array(nfe_u,
                                                              np.int64)
        if adjoint:
            saved[f"scan_chunk/{label}/backward_nfe"] = np.array(back_c,
                                                                 np.int64)
            saved[f"scan_chunk/{label}/backward_nfe_unsharded"] = np.array(
                back_u, np.int64)
        saved[f"scan_chunk/{label}/params"] = np.concatenate(
            [p.detach().cpu().numpy().ravel() for p in m_c.parameters()])
        models.append(m_c)
        if rank == 0:
            log(f"--scan_chunk ({label}, two steps, one host read) on the "
                f"row-sharded COO operator vs unsharded: rel-L1 loss="
                f"{d_l:.3e}; NFE {nfe_c}"
                + (f", backward NFE an interval {back_c}" if adjoint else "")
                + ", equal")
    return models


def _holder(model, arrays):
    """A CPU copy of ``model`` holding ``arrays`` as its parameters."""
    import torch

    holder = copy.deepcopy(model).cpu()
    with torch.no_grad():
        for p, a in zip(holder.parameters(), arrays):
            p.copy_(torch.as_tensor(a))
    return holder


def _worker(args) -> int:
    import torch
    import torch.distributed as dist

    from ndcn_tpu_torch.parallel.mesh import init_group

    torch.set_num_threads(1)
    if args.device == "cuda":
        device = torch.device("cuda", args.rank)
    else:
        device = torch.device("cpu")
    import datetime

    init_group(device, init_method=args.init, rank=args.rank,
               world_size=args.world,
               timeout=datetime.timedelta(seconds=args.timeout))
    try:
        if device.type == "cuda":
            from ndcn_tpu_torch.kernels import build

            if args.rank == 0:
                build.build()
            dist.barrier(device_ids=[args.rank])
            build.load()
        run_checks(args.rank, args.world, device, args.out)
        dist.barrier(**({"device_ids": [args.rank]}
                        if device.type == "cuda" else {}))
    finally:
        dist.destroy_process_group()
    return 0


def spawn(world: int, device: str = "cpu", out: Optional[str] = None,
          timeout: float = 240.0) -> int:
    """Start ``world`` rank processes of this module and wait for them;
    returns the first nonzero exit code (0 when every rank passed). Ranks
    still running after ``timeout`` seconds are killed (exit 124)."""
    store = tempfile.mkdtemp(prefix="ndcn_dryrun_")
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    cmd = [sys.executable, "-m", "ndcn_tpu_torch.parallel.dryrun",
           "--world", str(world), "--device", device,
           "--init", f"file://{os.path.join(store, 'store')}",
           "--timeout", str(int(timeout))]
    if out is not None:
        cmd += ["--out", out]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env)
             for r in range(world)]
    deadline = time.monotonic() + timeout
    codes = []
    try:
        for p in procs:
            try:
                codes.append(p.wait(max(0.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                codes.append(124)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return next((c for c in codes if c != 0), 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("dryrun")
    ap.add_argument("n", type=int, nargs="?", default=4,
                    help="ranks (processes) to start")
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None,
                    help="run as this rank of --world (the spawned worker)")
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cuda",
                    help="cuda: NCCL ranks, one card each; cpu: gloo ranks")
    ap.add_argument("--init", type=str, default=None)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--timeout", type=float, default=240.0)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return _worker(args)
    import torch

    device = args.device
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < args.n):
        print(f"dryrun: {args.n} NCCL ranks need {args.n} cards and "
              f"{torch.cuda.device_count()} are visible; pass --device cpu "
              f"to run the ranks on the CPU with gloo", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    rc = spawn(args.n, device, args.out, args.timeout)
    print(f"dryrun {'ok' if rc == 0 else f'FAILED (exit {rc})'}: {args.n} "
          f"ranks on {device} ({'nccl' if device == 'cuda' else 'gloo'}) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
