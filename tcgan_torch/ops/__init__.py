"""Numeric core: io functions, weight builder, stimulus battery, solvers."""
