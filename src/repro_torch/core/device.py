"""Device resolution shared by every entry point of the port.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
With no card visible they raise: nothing quietly falls back to the host.
"""
from __future__ import annotations

import torch

__all__ = ["resolve", "resolve_on", "backend_name"]


def resolve(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device(device)``, refusing a CUDA device that is not there.

    A bare ``"cuda"`` becomes ``cuda:<current index>``, so it compares equal
    to the device of the tensors allocated on it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA device is visible; "
                "pass device='cpu' to run the plain torch versions on the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve_on(device: str | torch.device | None, mesh=None) -> torch.device:
    """The device an entry point serves on: ``device`` (``"cuda"`` when
    None), or with a ``mesh`` its first device, where results land.  A
    ``device`` that names another device than the mesh's first raises."""
    if mesh is None:
        return resolve("cuda" if device is None else device)
    first = resolve(mesh.devices[0])
    if device is not None and resolve(device) != first:
        raise ValueError(f"device {device!r} is not the mesh's first device {first}")
    return first


def backend_name(device: torch.device) -> str:
    """What a plan records as its measurement context: the torch device
    type plus, on a card, the card's name (a plan timed on one card model
    is a stale point measurement on another)."""
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return device.type
