"""A gate for work recorded into a CUDA graph: a conditional IF node, so that
a replay runs the gated work only while a 0-dim bool tensor on the card
holds true. The bounded solve (``adaptive.solve_scan``) puts each step
attempt behind one, in its forward and in its backward, so that a replay
launches no kernel of a frozen attempt.

``if_node(pred, body)``, called while the current stream captures, adds the
node to the capture (``csrc/graph_gate.cu``: a one-thread kernel copies
``pred`` into the node's condition, then the node) and runs ``body()`` with
the current stream switched to ``side_stream(device)``, which captures the
node's body graph, and with the thread's allocations routed to a pool of
their own (``torch.cuda.use_mem_pool``): a tensor made inside the body is
freed inside it, and nothing outside the body reads one. Work captured
after the call waits for the node.

Autograd inside a body must not reach a tensor made outside it: the
engine hands a gradient to the node that consumes it on that node's
stream, and a node made outside the body (a parameter's gradient
accumulator, on the capturing stream) would make the capture wait on the
body's stream, a dependency across two graphs (seen to crash the capture's
end). So a body that differentiates with respect to the parameters an RHS
closes over takes them as fresh leaves (``fresh_leaves``): the RHS reads
them from a list, whose entries are swapped for the body's length.

The side stream is one per device, and ``train.chunk.TrainChunk`` runs its
eager warm-up steps on it: cuBLAS keeps a workspace per handle and stream,
so the warm-up makes the body's workspaces before the capture, which then
allocates none.

``GATED`` counts the gates opened since the process started (one an
attempt in a captured forward, one in its backward); a capture's count is
the difference across it (``TrainChunk.gated_attempts``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, List

import torch

GATED = 0
_OPEN = 0   # bodies being captured (the forward's, or one of the backward's)

# cudaStreamCaptureModeGlobal: the body captures as torch.cuda.graph's
# default capture does
_CAPTURE_MODE = 0

_STREAMS: dict = {}
_POOLS: dict = {}


def side_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream a gate's body captures on (one per device)."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _STREAMS:
        _STREAMS[index] = torch.cuda.Stream(index)
    return _STREAMS[index]


def _pool(index: int):
    if index not in _POOLS:
        _POOLS[index] = torch.cuda.MemPool()
    return _POOLS[index]


def if_node(pred: torch.Tensor, body: Callable[[], None]) -> None:
    """Capture ``body()`` behind a conditional IF node on ``pred`` (a 0-dim
    bool on the card) into the graph the current stream captures."""
    from ndcn_tpu_torch.kernels import build

    global GATED, _OPEN
    lib = build.load()
    index = pred.device.index
    child = side_stream(pred.device)
    parent = torch.cuda.current_stream(pred.device)
    rc = lib.ndcn_graph_if_begin(pred.data_ptr(), parent.cuda_stream,
                                 child.cuda_stream, _CAPTURE_MODE)
    if rc != 0:
        raise RuntimeError(f"opening a conditional graph node failed: CUDA "
                           f"error {rc}")
    GATED += 1
    _OPEN += 1
    try:
        with torch.cuda.stream(child), torch.cuda.use_mem_pool(_pool(index),
                                                               index):
            body()
    finally:
        _OPEN -= 1
        rc = lib.ndcn_graph_if_end(child.cuda_stream)
    if rc != 0:
        raise RuntimeError(f"closing a conditional graph node failed: CUDA "
                           f"error {rc}")


def in_body() -> bool:
    """Whether a gate's body is being captured."""
    return _OPEN > 0


@contextlib.contextmanager
def fresh_leaves(params: List[torch.Tensor]):
    """Swap each tensor of ``params``, the list an RHS reads its parameters
    from at each call, for a leaf of the same values (no copy) for the
    block, and yield the leaves: a gradient taken with respect to them
    reaches no node made outside the block."""
    if not isinstance(params, list):
        raise TypeError(f"params must be the list the RHS reads its "
                        f"parameters from; got {type(params).__name__}")
    saved = list(params)
    params[:] = [p.detach().requires_grad_(p.requires_grad) for p in saved]
    try:
        yield list(params)
    finally:
        params[:] = saved
