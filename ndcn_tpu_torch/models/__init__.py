"""NDCN and its layers."""

from ndcn_tpu_torch.models.ndcn import NDCN, init_ndcn, ndcn_forward  # noqa: F401
