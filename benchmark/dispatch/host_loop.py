"""The host-loop train step: ``make_sgd_step(torch_adam(...), objective)``
over the host loop's differentiable solve, as ``experiments/large_graph.py``
builds it; k eager steps, then one read of the last loss (the driver's
elastic check every ``check_freq`` steps)."""

from __future__ import annotations

import torch

from benchmark.session import Session


class HostLoopSession(Session):
    scan = False

    def build(self) -> None:
        from ndcn_tpu_torch.train.optim import make_sgd_step, torch_adam

        tr = self.program.config["train"]
        self.opt = torch_adam(self.params, tr["lr"], tr["weight_decay"])
        self.step = make_sgd_step(self.opt, self.program.loss_fn)

    def run(self, k: int):
        for _ in range(k):
            loss, rel = self.step()
        loss_f, rel_f = torch.stack([loss, rel]).tolist()
        return loss_f, rel_f


Session = HostLoopSession
