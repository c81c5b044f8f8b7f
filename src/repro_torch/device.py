"""Device resolution shared by every entry point of the port.

Entry points (``StripeStore``, ``BatchedCodecEngine``, ``StripeCodec``,
``repair_failed_nodes``) run on the card unless the caller asks for the
host: they take ``device="cuda"`` by default, and on a machine without
CUDA they raise instead of quietly running the plain PyTorch versions.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a concrete ``torch.device`` (a bare "cuda" gets the
    current card's index). Raises ``RuntimeError`` when CUDA is asked for
    and absent, naming the host opt-in."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                'CUDA is not available on this machine; pass device="cpu" '
                "to run the plain PyTorch versions on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev
