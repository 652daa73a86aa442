"""Legacy discrete-GCN entry point (reference: train.py), as
``ndcn_tpu/experiments/train_gcn.py``.

A thin front over the classification driver with the legacy surface: the
models restricted to the discrete zoo and ``--delta`` feeding the operator's
alpha (the reference passes args.delta as load_data's alpha).

Usage: python -m ndcn_tpu_torch.experiments.train_gcn --model GCN \\
           --epochs 200 [--platform cpu]
"""

from ndcn_tpu_torch.experiments import dgnn

LEGACY_MODELS = ("DeepGCN", "GCN", "DeepGCN2", "DeepGCN3", "DeepGCN4")


def main(argv=None):
    args, _ = dgnn.build_parser().parse_known_args(argv)
    if args.model not in LEGACY_MODELS:
        raise SystemExit(f"train_gcn supports {LEGACY_MODELS}; got {args.model}")
    args.alpha = args.delta  # legacy: delta doubles as the operator alpha
    return dgnn.run(args)


if __name__ == "__main__":
    main()
