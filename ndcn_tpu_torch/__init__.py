"""ndcn_tpu_torch: the PyTorch + CUDA (Hopper) port of ``ndcn_tpu``.

It mirrors the JAX package's module paths, so each piece has a counterpart:

- ``data``        the Planetoid citation networks (cora, citeseer).
- ``graph``       host-side generators and operators; the dense, ELL,
                  CSR-sorted COO and block-sparse operator containers
                  (``graph.sparse``).
- ``kernels``     hand-written CUDA kernels (``csrc/*.cu``), each beside its
                  plain PyTorch version in one ``autograd.Function``, and the
                  platform seam that picks between them by the tensors' device.
- ``ode``         dopri5, tsit5, VCABM, the fixed-grid and fixed-order methods
                  (``odeint_with_stats``), float64 time, the continuous adjoint.
- ``dynamics``    the heat, mutualistic and gene right-hand sides.
- ``models``      NDCN as an ``nn.Module`` with the JAX package's forward;
                  the GCN zoo (``models.gcn_zoo``); the temporal-GNN
                  baselines (``models.temporal_gcn``) on the recurrent cells
                  of ``models.nn``.
- ``train``       time sampling, losses and metrics, Adam, step budgets,
                  elastic rollback,
                  checkpoint / resume, the SpMV roofline.
- ``experiments`` the dynamics experiments (``python -m
                  ndcn_tpu_torch.experiments.heat``, ``.mutualistic``,
                  ``.gene``), the scale experiment
                  (``experiments.large_graph``), node classification
                  (``experiments.dgnn``, with the legacy fronts
                  ``train_gcn`` and ``train_resgcn``), the T × alpha sweep
                  (``experiments.sweep_t_alpha``), the Lotka-Volterra demo
                  (``experiments.lv``) and ``experiments.summarize``.
- ``report``      the results dumps both packages read, their aggregation,
                  the plots (matplotlib imported at the first plot).
- ``utils``       atomic writes, the ``torch.profiler`` trace of
                  ``--profile_dir`` and the spans at the layer boundaries
                  (``utils.timing.span``).
- ``tools``       the sparse microbenchmarks on the card.
- ``serve``       the serving entry point ``make_server``.
- ``convert``     weights across from the JAX package.

The port imports torch, numpy and scipy (and networkx for the four
networkx graph kinds and ``girvan_newman_labels`` only, matplotlib for the
plots only), never jax.
"""

__version__ = "0.1.0"
