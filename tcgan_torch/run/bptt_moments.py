"""Entry point under the reference's ``bptt_moments`` name: identical to
``tcgan_torch.run.moments`` with ``--solver bptt`` as the default.

Port of :mod:`tcgan_tpu.run.bptt_moments`.

Usage:
    python -m tcgan_torch.run.bptt_moments --datastore runs/bptt_mm \
        --device cuda --solver-backend cuda
"""

from __future__ import annotations

import sys

from tcgan_torch.run.moments import main as _main
from tcgan_torch.run.moments import make_parser  # noqa: F401


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--solver" not in argv:
        argv = ["--solver", "bptt"] + argv
    return _main(argv)


if __name__ == "__main__":
    sys.exit(main())
