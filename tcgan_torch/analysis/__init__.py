"""Post-hoc analysis of the port's runs: run-directory loaders, parameter
recovery and tuning-curve distribution metrics, the per-condition W1 grid,
identifiability (the moment Jacobian) and per-run uncertainty.

The port's own copies of the :mod:`tcgan_tpu.analysis` modules its entry
points use: that package cannot be imported where JAX is absent.
matplotlib is imported only inside the plotting functions.
"""

from tcgan_torch.analysis.loaders import (  # noqa: F401
    EnsembleRecord,
    RunRecord,
    load_ensemble,
    load_run,
)
