"""Replica sweeps and node sharding, the counterpart of ``ndcn_tpu/parallel``:
``sweep`` (replica sweeps on one device, and the placement of a problem on
a mesh), ``mesh`` (process meshes over ``torch.distributed`` ranks and
their collectives), ``coo_shard`` (row-block sharded operators: K1 and
K1-fm on each rank's row block) and ``dryrun`` (the multi-rank checks).
A mesh's data axis spreads a sweep's replicas over the ranks."""
