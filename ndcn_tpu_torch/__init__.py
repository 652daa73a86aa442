"""ndcn_tpu_torch: the PyTorch + CUDA (Hopper) port of ``ndcn_tpu``.

It mirrors the JAX package's module paths, so each piece has a counterpart:

- ``graph``     host-side generators and operators; the dense and CSR-sorted
                COO operator containers (``graph.sparse``).
- ``kernels``   hand-written CUDA kernels (``csrc/*.cu``), each beside its
                plain PyTorch version, and the platform seam that picks
                between them by the tensors' device.
- ``ode``       the dopri5 inference solve (``odeint_with_stats``).
- ``dynamics``  the heat-diffusion right-hand side.
- ``models``    NDCN as an ``nn.Module`` with the JAX package's forward.
- ``serve``     the serving entry point ``make_server``.
- ``convert``   weights across from the JAX package.

The port imports torch, numpy and scipy, never jax.
"""

__version__ = "0.1.0"
