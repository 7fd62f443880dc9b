"""C2: WGAN-GP fit with fixed-point (implicit-diff) gradients.

Port of :mod:`tcgan_tpu.run.gan`: the forward solve by the fixed-point
solver (the CUDA kernel with ``--solver-backend cuda``), the backward by
the implicit function theorem (``tcgan_torch.ops.ift``).

Usage:
    python -m tcgan_torch.run.gan --datastore runs/gan --n-steps 500 \
        --device cuda --solver-backend cuda
"""

from __future__ import annotations

import sys

from tcgan_torch.run import common
from tcgan_torch.run.gan_common import make_gan_parser, run_gan


def make_parser():
    return make_gan_parser(__doc__)


def main(argv=None):
    args = make_parser().parse_args(argv)
    rc = common.mesh_ranks(main, argv, args)
    if rc is not None:
        return rc
    return run_gan(args, solver="ift", conditional=False)


if __name__ == "__main__":
    sys.exit(main())
