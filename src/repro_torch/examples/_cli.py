"""The examples' command line: ``--device`` and nothing else."""
from __future__ import annotations

import argparse


def device_arg(doc: str, argv=None):
    """The ``--device`` an example was asked for (None: CUDA)."""
    p = argparse.ArgumentParser(description=doc)
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: CUDA, raising "
                        "without a card; 'cpu' runs the plain PyTorch "
                        "path)")
    return p.parse_args(argv).device
