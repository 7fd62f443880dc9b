"""Post-hoc analysis of the port's runs: run-directory loaders, parameter
recovery and tuning-curve distribution metrics, the per-condition W1 grid,
identifiability (the moment Jacobian), per-run uncertainty, learning
curves, the fit-quality page, multi-run comparison, the ensemble view,
the markdown report and the recovery gate.

The port's own copies of the :mod:`tcgan_tpu.analysis` modules its entry
points use: that package cannot be imported where JAX is absent.
matplotlib is imported only inside the plotting functions.
"""

from tcgan_torch.analysis.compare import load_runs  # noqa: F401
from tcgan_torch.analysis.loaders import (  # noqa: F401
    EnsembleRecord,
    RunRecord,
    load_ensemble,
    load_run,
)
