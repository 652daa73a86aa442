"""Shared helpers (``ndcn_tpu/utils``'s counterparts)."""
