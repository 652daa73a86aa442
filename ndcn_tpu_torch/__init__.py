"""ndcn_tpu_torch: the PyTorch + CUDA (Hopper) port of ``ndcn_tpu``.

It mirrors the JAX package's module paths, so each piece has a counterpart:

- ``graph``       host-side generators and operators; the dense, CSR-sorted
                  COO and block-sparse operator containers (``graph.sparse``).
- ``kernels``     hand-written CUDA kernels (``csrc/*.cu``), each beside its
                  plain PyTorch version in one ``autograd.Function``, and the
                  platform seam that picks between them by the tensors' device.
- ``ode``         dopri5, differentiable and inference (``odeint_with_stats``).
- ``dynamics``    the heat-diffusion right-hand side.
- ``models``      NDCN as an ``nn.Module`` with the JAX package's forward.
- ``train``       time sampling, losses, Adam, step budgets, elastic rollback,
                  the SpMV roofline.
- ``experiments`` the heat experiment (``python -m ndcn_tpu_torch.experiments.heat``)
                  and the scale experiment (``experiments.large_graph``).
- ``tools``       the sparse microbenchmarks on the card.
- ``serve``       the serving entry point ``make_server``.
- ``convert``     weights across from the JAX package.

The port imports torch, numpy and scipy, never jax.
"""

__version__ = "0.1.0"
