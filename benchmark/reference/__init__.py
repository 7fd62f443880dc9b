"""The benchmark's plain reference: plain PyTorch, float32 with TF32 off,
written from the model's equations. It imports nothing of the program
under test, and takes none of its outputs but those it judges."""
