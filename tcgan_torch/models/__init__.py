"""Model layer: the SSN tuning-curve generator."""
