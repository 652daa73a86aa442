"""The graphed train step: ``make_sgd_step`` over the bounded solve with
``CapturableAdam``, wrapped in ``train.chunk.TrainChunk`` (one CUDA graph a
step on the card, eager on the CPU), as ``experiments/dynamics.py`` builds
it for ``--scan_chunk``, guarded by ``scan_train_bytes``."""

from __future__ import annotations

import time

import torch

from benchmark.session import Session


class GraphedSession(Session):
    scan = True

    def build(self) -> None:
        from ndcn_tpu_torch.train.budget import scan_train_bytes
        from ndcn_tpu_torch.train.chunk import TrainChunk
        from ndcn_tpu_torch.train.optim import make_sgd_step, torch_adam

        prog, tr = self.program, self.program.config["train"]
        self.opt = torch_adam(self.params, tr["lr"], tr["weight_decay"],
                              capturable=True)
        step = make_sgd_step(self.opt, prog.loss_fn)
        width = prog.config["model"]["hidden_size"]
        step_bytes = scan_train_bytes(
            prog.solve_kw["method"], prog.max_steps,
            torch.empty((prog.x0.shape[0], width), device="meta"),
            n_obs=len(prog.t_train))
        self.chunk = TrainChunk(step, self.params, self.opt, None,
                                step_bytes)
        if prog.device.type == "cuda":
            torch.cuda.synchronize(prog.device)
            t0 = time.perf_counter()
            self.chunk.capture()
            torch.cuda.synchronize(prog.device)
            self.capture_s = time.perf_counter() - t0

    def run(self, k: int):
        return self.chunk(k)

    def release(self) -> None:
        self.chunk.release()


Session = GraphedSession
