"""Aggregate dumped results, as ``ndcn_tpu/experiments/summarize.py`` (the
reference's summarize_result.py). Reads the dumps of either package.

Usage: python -m ndcn_tpu_torch.experiments.summarize --dir results/heat/grid --type ndcn
"""

import argparse

from ndcn_tpu_torch.report.results import print_summary, summarize_directory


def main(argv=None):
    p = argparse.ArgumentParser("summarize the results in N file.results")
    p.add_argument("--dir", type=str, required=True)
    p.add_argument("--type", type=str, required=True)
    args = p.parse_args(argv)
    summary = summarize_directory(args.dir, args.type)
    print(f"n_runs: {summary['n_runs']}")
    print_summary(summary)
    return summary


if __name__ == "__main__":
    main()
