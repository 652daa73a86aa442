"""NDCN and its layers; the temporal-GNN baselines."""

from ndcn_tpu_torch.models.ndcn import NDCN, init_ndcn, ndcn_forward  # noqa: F401
from ndcn_tpu_torch.models.temporal_gcn import (  # noqa: F401
    TemporalGCN, init_temporal_gcn, temporal_gcn_forward)
