"""Run plumbing: datastore, recorder streams, checkpoints, the GAN driver."""
