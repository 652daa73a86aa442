"""Dataset loading: the Planetoid citation networks."""

from ndcn_tpu_torch.data.planetoid import (DATASETS, Planetoid,  # noqa: F401
                                           load_planetoid)
