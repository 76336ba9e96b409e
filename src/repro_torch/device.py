"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a
missing GPU raises instead of falling back.  On the card TF32 is turned
off for matmuls and convolutions, so fp32 products stay fp32 (the
kernels' plain versions and the reference compare in full fp32).
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def same_device(a, b) -> bool:
    """Whether two device specs name one device ("cuda" matches the
    current card's "cuda:0")."""
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)
