"""The port's one platform seam (the counterpart of ``ndcn_tpu/kernels/platform.py``
and ``ndcn_tpu/utils/platform.py``).

- ``device_report``: is there a CUDA card, which, at which compute
  capability, and is the kernel library built.
- ``on_cuda``: kernel or plain PyTorch twin, chosen by the tensors' device
  and nothing else. CPU tensors take the twin; CUDA tensors take the kernel
  (which raises if it cannot run); anything else raises.
- ``pin_fp32``: float32 matrix products in full fp32, TF32 off for matmuls
  and cuDNN alike. The counterpart of ``--precision highest``.
- ``matmul_precision``: the drivers' ``--precision`` for one run, and the
  settings as they were afterwards.
"""

from __future__ import annotations

import contextlib

import torch

from ndcn_tpu_torch.kernels import build

# the kernels compile for sm_90a only
REQUIRED_CAPABILITY = (9, 0)


def pin_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


@contextlib.contextmanager
def matmul_precision(precision: str):
    """The drivers' ``--precision`` for the body: ``pin_fp32``, and with
    "high" ``torch.set_float32_matmul_precision("high")``, TF32 for the
    float32 products that PyTorch runs (the encoder, the decoder, the
    unfused control layer, the backward's products, the scan path's
    readout): about three decimal digits where full fp32 keeps seven.
    The hand-written kernels (K1-K5; K2, K3 and K4 split-TF32 with fp32
    accuracy) do not read the setting. Every other value ("default",
    "float32", "highest") is full fp32. The settings the body found are
    restored after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    pin_fp32()
    if precision == "high":
        torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def device_report() -> dict:
    cuda = torch.cuda.is_available()
    capability = torch.cuda.get_device_capability(0) if cuda else None
    return {
        "cuda": cuda,
        "name": torch.cuda.get_device_name(0) if cuda else None,
        "capability": capability,
        "sm90": capability == REQUIRED_CAPABILITY,
        "count": torch.cuda.device_count() if cuda else 0,
        "kernels_built": build.is_built(),
    }


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on one CUDA device, False when every one
    lies on the CPU; a mix, or another device type, raises."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return False
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return True
    raise ValueError(f"tensors must lie together on the CPU or on one CUDA "
                     f"device; got {sorted(map(str, devices))}")
