"""Where the port's entry points run: on the card unless told otherwise."""

import os

import torch


def resolve_device(device=None):
    """``None`` means the CUDA card: ``cuda:LOCAL_RANK`` inside a
    ``torch.distributed`` group, else the current one; with no card that
    is an error, never a silent move to the CPU. Pass ``device="cpu"`` to
    run on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        dist = torch.distributed
        if (dist.is_available() and dist.is_initialized()
                and "LOCAL_RANK" in os.environ):
            return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device
