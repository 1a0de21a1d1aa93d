"""Device selection: CUDA unless the caller asks for the CPU, never a silent fallback."""

import torch

from .logging import UserException


def resolve_device(device="cuda"):
    """The ``torch.device`` for a ``"cuda"``/``"cpu"`` request (or a device).

    A CUDA request on a machine without a usable GPU raises: a run that was
    meant for the card must not carry on quietly on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise UserException(
                "CUDA was requested but no GPU is available; pass --device cpu "
                "(or device='cpu') to run on the CPU"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise UserException("Unsupported device %r (use cuda or cpu)" % str(device))
    return device
