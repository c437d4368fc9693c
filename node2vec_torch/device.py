"""Device selection for the port's entry points.

``Node2Vec``, ``WalkEngine`` and ``Word2VecTorch`` default to ``"cuda"`` and
raise when CUDA is missing, rather than run on the CPU unasked.  The CPU
runs the plain PyTorch version of every kernel and is chosen only by
passing ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
