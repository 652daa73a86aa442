"""Legacy residual / ODE-GCN entry point (reference: train_resGCN.py), as
``ndcn_tpu/experiments/train_resgcn.py``: train_gcn's surface plus resGCN
and odeGCN with ``--normalize`` / ``--Euler``.

Usage: python -m ndcn_tpu_torch.experiments.train_resgcn --model resGCN \\
           -nhl 2 --Euler [--platform cpu]
"""

from ndcn_tpu_torch.experiments import dgnn

LEGACY_MODELS = ("DeepGCN", "GCN", "DeepGCN2", "DeepGCN3", "DeepGCN4",
                 "resGCN", "odeGCN")


def main(argv=None):
    args, _ = dgnn.build_parser().parse_known_args(argv)
    if args.model not in LEGACY_MODELS:
        raise SystemExit(f"train_resgcn supports {LEGACY_MODELS}; got "
                         f"{args.model}")
    args.alpha = args.delta  # legacy: delta doubles as the operator alpha
    return dgnn.run(args)


if __name__ == "__main__":
    main()
