"""The examples' shared command line."""

from __future__ import annotations

import argparse

import torch


def device_arg(doc: str, argv=None) -> torch.device:
    """Parse ``--device`` (``cuda``, the default, or ``cpu``); ``cuda``
    raises without a card."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    device = torch.device(ap.parse_args(argv).device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: torch.cuda.is_available() is false; "
                         "pass --device cpu.")
    return device
