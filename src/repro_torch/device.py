"""Device resolution for the port's entry points.

Entry points take ``device="cuda"`` by default and run on the card.  The CPU
is used only when the caller asks for it (the tests do); with no card and no
explicit CPU request they raise instead of quietly running on the host.
``device="meta"`` (shapes and dtypes, nothing computed) is the dry run's
explicit request (``launch/dryrun.py``).
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Canonical ``torch.device`` for an entry point's ``device`` argument.

    Raises ``RuntimeError`` for a CUDA device when no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {device!r} (cuda, cpu or meta)")
    return dev
