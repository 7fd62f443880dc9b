"""C4: conditional WGAN over stimulus conditions (contrast x bandwidth).

Port of :mod:`tcgan_tpu.run.bptt_cwgan`: the critic is conditioned on the
(bandwidth, contrast) tag of every sample (``tcgan_torch.models.cwgan``).
BPTT gradients by default, as in the reference; ``--solver ift`` takes
implicit gradients through the fixed-point solve (the CUDA kernel with
``--solver-backend cuda``).

Usage:
    python -m tcgan_torch.run.bptt_cwgan --datastore runs/cwgan --solver ift \
        --device cuda --solver-backend cuda
"""

from __future__ import annotations

import sys

from tcgan_torch.run import common
from tcgan_torch.run.gan_common import make_gan_parser, run_gan


def make_parser():
    p = make_gan_parser(__doc__)
    p.add_argument("--solver", choices=("bptt", "ift"), default="bptt")
    p.add_argument("--bptt-checkpoint-chunk", type=int, default=0,
                   help="remat chunk size (0 = no checkpointing); the "
                        "memory lever for long --seqlen BPTT runs")
    return p


def main(argv=None):
    args = make_parser().parse_args(argv)
    rc = common.mesh_ranks(main, argv, args)
    if rc is not None:
        return rc
    return run_gan(args, solver=args.solver, conditional=True)


if __name__ == "__main__":
    sys.exit(main())
