"""The program under test: the port's NDCN train step for one
configuration, built from the benchmark's inputs as the port's drivers
build it.

The operator comes from the adjacency through ``graph.operators`` and
``graph.sparse.as_operator``; the model is ``models.init_ndcn`` with the
benchmark's weights copied in; the step budget is
``train.budget.probe_step_budget`` over the inference solve; the loss is
the drivers' train objective (``experiments/dynamics.py``'s ``train_loss``
and ``experiments/large_graph.py``'s ``train_objective``, which are
closures or fix their solver settings): ``ndcn_forward`` at the
configuration's settings, the L1 loss, NaN when the solve ran out of its
budget, and the relative loss beside it. ``scan`` selects the bounded
solve that a CUDA graph records (``--scan_chunk``).

The step's ``SolveStats`` of the last call are kept in ``Program.stats``:
host ints after a host-loop solve, 0-dim device tensors after the bounded
one (a graph's outputs, which each replay rewrites).
"""

from __future__ import annotations

import torch

from benchmark.inputs import Inputs


class Program:
    def __init__(self, config: dict, inp: Inputs, device: torch.device,
                 scan: bool):
        from ndcn_tpu_torch.graph import operators
        from ndcn_tpu_torch.graph.sparse import as_operator
        from ndcn_tpu_torch.models import init_ndcn
        from ndcn_tpu_torch.models.ndcn import resolve_layout

        self.config, self.device, self.scan = config, device, scan
        if config["kernel_precision"] != "split2" or config["tf32"]:
            # the drivers set these for the whole run (coo_spmv.
            # gather_precision, kernels.platform.matmul_precision); no
            # configuration here asks for them yet
            raise ValueError("only kernel_precision 'split2' without TF32 "
                             "is built")
        graph, solver, model = (config["graph"], config["solver"],
                                config["model"])
        if graph["format"] == "dense":
            self.op = as_operator(operators.build_dynamics_operator(
                inp.adjacency, graph["operator"]), device=device)
        elif graph["operator"] == "norm_lap":
            self.op = as_operator(
                operators.normalized_laplacian_sparse(inp.adjacency),
                sparse=True, format=graph["format"], device=device)
        else:
            raise ValueError(f"no sparse builder for {graph['operator']!r}")
        self.model = init_ndcn(torch.Generator().manual_seed(0),
                               model["input_size"], model["hidden_size"],
                               model["output_size"], device=device)
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(inp.weights[name])
        self.x0, self.target = inp.x0, inp.target
        self.target_mean = inp.target.mean()
        self.t_train = inp.t_train
        self.t_probe = (inp.t_full if config["budget"]["probe_times"] == "all"
                        else inp.t_train)
        # the bounded solve reads its grid from the device
        self.t_arg = (torch.as_tensor(inp.t_train, device=device) if scan
                      else inp.t_train)
        bf16 = torch.bfloat16
        self.solve_kw = dict(
            rtol=solver["rtol"], atol=solver["atol"], method=solver["method"],
            fused="auto" if graph.get("fused") else False,
            layout=solver["layout"])
        self.levers = dict(
            emission_dtype=(bf16 if config["emission_precision"] == "bf16"
                            else None),
            residual_dtype=(bf16 if config["residual_precision"] == "bf16"
                            else None))
        h = torch.empty((inp.n, model["hidden_size"]), device="meta")
        self.solve_layout = resolve_layout(solver["layout"], self.op, h,
                                           fused=self.solve_kw["fused"])
        self.max_steps = 0
        self.stats = None

    def probe_budget(self) -> int:
        """The step budget from one inference solve, the drivers' way."""
        from ndcn_tpu_torch.models import ndcn_forward
        from ndcn_tpu_torch.train.budget import probe_step_budget

        b = self.config["budget"]
        self.max_steps = probe_step_budget(
            lambda: ndcn_forward(self.model, self.op, self.t_probe, self.x0,
                                 nondiff=True, max_steps=1 << 14,
                                 **self.solve_kw)[1],
            floor=b["floor"], headroom=b["headroom"], slack=b["slack"],
            quantum=b["quantum"])
        return self.max_steps

    def loss_fn(self):
        """The train objective: (L1 loss or NaN, relative L1)."""
        from ndcn_tpu_torch.experiments.dynamics import nan_unless_ok
        from ndcn_tpu_torch.models import ndcn_forward
        from ndcn_tpu_torch.train import losses

        out, stats = ndcn_forward(self.model, self.op, self.t_arg, self.x0,
                                  max_steps=self.max_steps, scan=self.scan,
                                  **self.solve_kw, **self.levers)
        self.stats = stats
        loss = nan_unless_ok(stats.success,
                             losses.l1_loss(out, self.target))
        return loss, loss / self.target_mean

    def parameters(self):
        return list(self.model.parameters())

    def named_parameters(self):
        return dict(self.model.named_parameters())

    def work(self) -> dict:
        """The shapes the work counts read (``benchmark.roofline``)."""
        from ndcn_tpu_torch.graph.sparse import CooGraph, DenseGraph

        op = self.op
        hidden = self.config["model"]["hidden_size"]
        d = -(-hidden // 8) * 8 if self.solve_layout == "feature_major" \
            else hidden
        if isinstance(op, DenseGraph):
            kind, nnz = "dense", op.mat.shape[0] * op.mat.shape[1]
        elif isinstance(op, CooGraph):
            kind, nnz = "csr", int(op.cols.shape[0])
        else:
            raise ValueError(f"no work count for {type(op).__name__}")
        return dict(n=int(self.x0.shape[0]), nnz=nnz, operator=kind,
                    hidden=hidden, state_width=d,
                    input_size=self.config["model"]["input_size"],
                    output_size=self.config["model"]["output_size"],
                    observations=int(len(self.t_train)),
                    params=int(sum(p.numel() for p in self.parameters())))


def stats_ints(stats) -> tuple:
    """(nfe, accepted, rejected, success) of a ``SolveStats`` as host
    values (a read of the device for the bounded solve's)."""
    vals = [stats.nfe, stats.n_accepted, stats.n_rejected, stats.success]
    if isinstance(vals[0], torch.Tensor):
        vals = torch.stack([torch.as_tensor(v).to(torch.int64)
                            for v in vals]).tolist()
    return int(vals[0]), int(vals[1]), int(vals[2]), bool(vals[3])
