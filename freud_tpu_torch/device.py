"""Device choice shared by the entry points: a config's, a flag's or a
caller's ``device`` → a ``torch.device``."""

from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device: Optional[str | torch.device], what: str = "collection",
                   hint: Optional[str] = None) -> torch.device:
    """``cpu`` / ``cuda[:N]`` as given; anything else (``tpu``, None) → cuda.
    A CUDA device must exist: the run never carries on on the CPU. ``hint``
    says how the caller asks for the CPU (a config's ``"device": "cpu"`` by
    default)."""
    name = str(device or "cuda").lower()
    if name != "cpu" and not name.startswith("cuda"):
        name = "cuda"
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        hint = hint or f'set "device": "cpu" to run the {what} on the CPU'
        raise RuntimeError(
            f"{what} device {device!r} needs CUDA, but "
            f"torch.cuda.is_available() is False; {hint}")
    return dev
