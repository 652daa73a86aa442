"""Replica sweeps on one device (``sweep``), the counterpart of the
single-device form of ``ndcn_tpu/parallel``. Meshes are not ported yet
(ROADMAP §1 entry 11c)."""
