"""Device choice shared by the CLIs: a config's ``device`` string → a
``torch.device``."""

from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device: Optional[str], what: str = "collection") -> torch.device:
    """``cpu`` / ``cuda[:N]`` as given; anything else (``tpu``, None) → cuda.
    A CUDA device must exist: the run never carries on on the CPU."""
    name = (device or "cuda").lower()
    if name != "cpu" and not name.startswith("cuda"):
        name = "cuda"
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} device {device!r} needs CUDA, but "
            "torch.cuda.is_available() is False; set \"device\": \"cpu\" to "
            f"run the {what} on the CPU")
    return dev
