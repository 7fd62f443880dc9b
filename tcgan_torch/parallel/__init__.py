"""Sharded execution over ``torch.distributed`` ranks: the circuit batch
over a batch axis, optionally W's columns over a model axis, an ensemble's
members over the ranks.

Port of :mod:`tcgan_tpu.parallel` (an ICI mesh under GSPMD there): the
same names, with the collectives written out (:mod:`.mesh`) and the ranks
started by :mod:`.launch`.
"""

from tcgan_torch.parallel.mesh import (  # noqa: F401
    BATCH_AXIS,
    MODEL_AXIS,
    make_mesh,
    make_sharded_ensemble_step,
    make_sharded_gan_step,
    make_sharded_mm_step,
    set_mesh,
    with_mesh_axes,
)
