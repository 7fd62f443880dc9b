"""Model layer: the SSN tuning-curve generator, the critic and the WGAN-GP
step."""
