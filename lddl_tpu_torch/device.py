"""The default-device rule shared by every entry point of the port.

Entry points run on the GPU unless the caller asks for the CPU. A missing
GPU is an error, never a silent switch to the CPU: a number measured on
the CPU must not pass for a device number.
"""

import torch


def resolve_device(device=None):
    """``torch.device`` for an entry point: ``cuda`` when ``device`` is None;
    raises when CUDA is requested (explicitly or by default) and no card is
    present. Pass ``device="cpu"`` to run on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    return dev
