"""C3: WGAN-GP fit with BPTT gradients through the unrolled Euler loop.

Port of :mod:`tcgan_tpu.run.bptt_wgan`: gradients flow through a
fixed-length trajectory of ``--seqlen`` Euler steps
(``tcgan_torch.ops.euler``), with ``--bptt-checkpoint-chunk`` to recompute
chunks of steps in the backward instead of keeping every step's state. The
fake truth is solved by the fixed-point solver (the CUDA kernel with
``--solver-backend cuda``).

Usage:
    python -m tcgan_torch.run.bptt_wgan --datastore runs/bptt --seqlen 4000 \
        --bptt-checkpoint-chunk 100 --device cuda --solver-backend cuda
"""

from __future__ import annotations

import sys

from tcgan_torch.run import common
from tcgan_torch.run.gan_common import make_gan_parser, run_gan


def make_parser():
    p = make_gan_parser(__doc__)
    p.add_argument("--bptt-checkpoint-chunk", type=int, default=0,
                   help="remat chunk size (0 = no checkpointing)")
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)
    rc = common.mesh_ranks(main, argv, args)
    if rc is not None:
        return rc
    return run_gan(args, solver="bptt", conditional=False)


if __name__ == "__main__":
    sys.exit(main())
