"""Train steps in chunks with no read of the device between them: the port
of the JAX driver's ``train_chunk`` (``jax.jit`` of a ``lax.scan`` over k
SGD steps, ``ndcn_tpu/experiments/dynamics.py``'s ``--scan_chunk``).

``TrainChunk(step, params, opt, rng)`` runs ``chunk(k)``: k calls of
``step()`` (zero_grad, forward, loss, backward, update: ``make_sgd_step``
with its arguments bound), then one read of the last step's loss and
relative loss, returned as Python floats. The step must read nothing on
the host: its solve is the bounded one (``ode.adaptive.solve_scan``, the
solve's ``scan`` option) and its optimizer ``optim.CapturableAdam``.

On a card the whole step is one CUDA graph, and a chunk is k replays of it.
The graph is captured at the first chunk (or by ``capture()``), after
``WARMUP`` eager steps on a side stream, which build the kernel library
and every launch plan and create Adam's state; the side stream is the one
the bounded solve's gated attempts capture their bodies on
(``ode.graph_gate.side_stream``), so the warm-up also makes the cuBLAS
workspaces those bodies use. The warm-up's updates are
then undone in place (the parameters, Adam's state and the dropout
generator as they were before it), so the graphed steps are the eager
steps, bit for bit. The graph reads and writes these tensors, which must
stay the same objects while the chunk lives: the parameters and their
gradients, Adam's state, the dropout generator (registered with the graph;
it must be a CUDA generator when the step draws from it), and whatever the
step closes over (the observation grid, the targets, the operator). A
restore copies into them in place (``nn.Module.load_state_dict`` does);
``torch.optim.Optimizer.load_state_dict`` replaces Adam's tensors, so a
caller that loads one builds a new chunk, which captures again (the
dynamics driver's elastic rollback does, at its doubled budget). A capture
or a replay that fails raises: nothing gives way to the eager step.

On the CPU the same step runs eagerly k times, with the same single read:
the route the caller asked for with ``--platform cpu``.

Before the capture ``budget.check_step_memory`` holds ``step_bytes`` (the
solve's ``scan_train_bytes``) and the model's own bytes against the card.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from ndcn_tpu_torch.ode import graph_gate
from ndcn_tpu_torch.train.budget import check_step_memory
from ndcn_tpu_torch.utils.timing import span

# eager steps before a capture: the first builds the library and creates
# Adam's state, the next ones run on what the capture will record
WARMUP = 2


class TrainChunk:
    """k train steps a call with one host read (see the module docstring).
    ``host_reads`` counts the reads, ``replays`` the graph's replays and
    ``gated_attempts`` the solve's attempts the capture put behind a
    conditional node (``ode.graph_gate``), forward and backward: a replay
    skips the kernels of each one that is frozen. The spans
    ``train.chunk.replay`` (each replay) and ``train.chunk.read`` (the
    read) name them in a profiler's trace."""

    def __init__(self, step: Callable[[], Tuple[torch.Tensor, torch.Tensor]],
                 params, opt: torch.optim.Optimizer,
                 rng: Optional[torch.Generator] = None,
                 step_bytes: int = 0):
        self.step = step
        self.params: List[torch.Tensor] = list(params)
        self.opt = opt
        self.rng = rng
        self.step_bytes = step_bytes
        self.device = self.params[0].device
        self.graph = None
        self._out = None
        self.host_reads = 0
        self.replays = 0
        self.gated_attempts = 0

    def __call__(self, k: int) -> Tuple[float, float]:
        if k < 1:
            raise ValueError(f"a chunk takes at least one step, got {k}")
        if self.device.type == "cuda":
            self.capture()
            for _ in range(k):
                with span("train.chunk.replay"):
                    self.graph.replay()
            self.replays += k
            loss, aux = self._out
        else:
            for _ in range(k):
                loss, aux = self.step()
        self.host_reads += 1
        with span("train.chunk.read"):
            loss_f, aux_f = torch.stack([loss.detach(),
                                         aux.detach()]).tolist()
        return loss_f, aux_f

    def capture(self) -> None:
        """Warm up and capture the step's graph, once."""
        if self.graph is not None:
            return
        check_step_memory(self.step_bytes, self.params, self.device)
        saved = self._save()
        side = graph_gate.side_stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                self.step()
        torch.cuda.current_stream(self.device).wait_stream(side)
        self._restore(saved)
        graph = torch.cuda.CUDAGraph()
        if self.rng is not None and self.rng.device.type == "cuda":
            graph.register_generator_state(self.rng)
        self.opt.zero_grad(set_to_none=True)
        gated = graph_gate.GATED
        with torch.cuda.graph(graph):
            self._out = self.step()
        self.gated_attempts = graph_gate.GATED - gated
        self.graph = graph

    def release(self) -> None:
        """Free the graph and its memory pool (the chunk is not used after)."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self._out = None

    def _save(self):
        """Copies of the parameters, Adam's state and the generator state."""
        state = {id(p): {k: v.clone() for k, v in self.opt.state[p].items()
                         if torch.is_tensor(v)}
                 for p in self.params if self.opt.state.get(p)}
        return ([p.detach().clone() for p in self.params], state,
                None if self.rng is None else self.rng.get_state())

    def _restore(self, saved) -> None:
        """The parameters, Adam's state and the generator as ``_save`` found
        them, in place; state that the warm-up created is zeroed, which is
        the state a first step creates."""
        params, state, rng_state = saved
        with torch.no_grad():
            for p, old in zip(self.params, params):
                p.copy_(old)
            for p in self.params:
                old = state.get(id(p))
                for k, v in self.opt.state.get(p, {}).items():
                    if not torch.is_tensor(v):
                        continue
                    if old is None:
                        v.zero_()
                    else:
                        v.copy_(old[k])
        if rng_state is not None:
            self.rng.set_state(rng_state)
