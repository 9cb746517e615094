"""The examples' shared command line: ``--device`` (the card unless the
CPU is asked for; no fallback) and seeded generators on it."""

from __future__ import annotations

import argparse

import torch


def parse(doc: str, argv=None, extra=None):
    """The example's arguments: ``--device`` (default cuda), and whatever
    ``extra(parser)`` adds. Raises without a card unless --device cpu."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises without a "
                    "card, never falls back to the CPU)")
    if extra is not None:
        extra(ap)
    args = ap.parse_args(argv)
    args.device = torch.device(args.device)
    if args.device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the "
                         "example on the CPU")
    return args


def generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)
