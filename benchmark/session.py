"""One train step object and how the window drives it: k steps a host
read, a restore in place at each cycle's start, a regrown budget after an
exhausted solve.

A dispatch path (``benchmark/dispatch/<traffic dispatch>.py``) subclasses
``Session``: ``build`` makes the optimizer and the step, ``run(k)`` takes k
steps and reads the last one's loss once. The restore copies the cycle's
starting parameters back and zeroes Adam's state in place, which is the
state Adam's first step creates (its step count, both moments): the tensors
stay the same objects, so a captured CUDA graph keeps reading them
(``train/chunk.py``'s docstring).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark.program import Program, stats_ints


class Session:
    def __init__(self, program: Program):
        from ndcn_tpu_torch.train.elastic import ElasticBudget

        self.program = program
        self.params: List[torch.Tensor] = program.parameters()
        self.names = list(program.named_parameters())
        self.elastic = ElasticBudget(program.max_steps, enabled=True)
        self.capture_s = None
        self.build()

    def build(self) -> None:
        raise NotImplementedError

    def run(self, k: int) -> Tuple[float, float]:
        raise NotImplementedError

    def release(self) -> None:
        """Free what ``build`` made that holds device memory."""

    def snapshot(self) -> List[torch.Tensor]:
        return [p.detach().clone() for p in self.params]

    def restore(self, saved: List[torch.Tensor]) -> None:
        with torch.no_grad():
            for p, old in zip(self.params, saved):
                p.copy_(old)
            for p in self.params:
                for v in self.opt.state.get(p, {}).values():
                    if torch.is_tensor(v):
                        v.zero_()

    def regrow(self) -> None:
        """Double the step budget (``train.elastic.ElasticBudget``, as the
        drivers regrow it) and build the step again."""
        self.elastic.snapshot(0, None, None)
        self.elastic.rollback()
        self.program.max_steps = self.elastic.max_steps
        self.release()
        self.build()

    def first_moments(self) -> Dict[str, torch.Tensor]:
        """Adam's first moment of every leaf, by name (zero where Adam holds
        none: it took no step)."""
        out = {}
        for n, p in zip(self.names, self.params):
            m = self.opt.state.get(p, {}).get("exp_avg")
            out[n] = torch.zeros_like(p) if m is None else m.detach().clone()
        return out

    def last_stats(self) -> tuple:
        """(nfe, accepted, rejected, success) of the last step's solve."""
        return stats_ints(self.program.stats)
