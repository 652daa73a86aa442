"""Results artifacts, aggregation and plots, as ``ndcn_tpu/report``."""

from ndcn_tpu_torch.report import results  # noqa: F401
