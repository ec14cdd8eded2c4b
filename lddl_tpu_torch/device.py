"""The default-device rule shared by every entry point of the port.

Entry points run on the GPU unless the caller asks for the CPU. A missing
GPU is an error, never a silent switch to the CPU: a number measured on
the CPU must not pass for a device number.
"""

import os


def resolve_device(device=None):
    """``torch.device`` for an entry point: ``cuda`` when ``device`` is None
    (``cuda:LOCAL_RANK`` once a process group is up); raises when CUDA is
    requested (explicitly or by default) and no card is present. Pass
    ``device="cpu"`` to run on the CPU."""
    import torch
    if device is None:
        import torch.distributed as dist
        device = "cuda"
        local = os.environ.get("LOCAL_RANK")
        if local is not None and dist.is_available() and dist.is_initialized():
            device = "cuda:{}".format(int(local))
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    return dev
