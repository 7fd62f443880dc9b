"""CLI entry points: ``python -m tcgan_torch.run.<name>``.

Each module exposes ``make_parser()`` and ``main(argv=None)``; ported so far:

- ``forward`` — forward-only SSN solve + tuning-curve sweep (serving mode)
- ``gan`` — WGAN-GP fit with fixed-point (implicit-diff) gradients
"""
