"""Faults planted in the program under test, to show that ``correct`` comes
out false when the timed path is broken underneath (the benchmark's tests
and ``calibrate.py``; the benchmark's own runs plant nothing).

Each is a context manager, named in :data:`PLANTS`, that patches the
program while it is open:

- ``answer_altered``: every solve returns the first circuit's rates
  doubled;
- ``half_batch``: every solve solves the first half of its circuits only
  and returns them twice, so every mean is over that half;
- ``state_unchanged``: the GAN step returns the state it was given;
- ``gen_lr_doubled``: the generator's Adam steps at twice its learning
  rate (a wrong update that leaves the gradients and the losses as they
  were).
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def _solve_patch(alter):
    from tcgan_torch.ops import ift

    solve_any = ift.solve_any

    def patched(cfg, W, I_ext, model=None):
        return alter(solve_any, cfg, W, I_ext, model)

    return _patched(ift, "solve_any", patched)


def answer_altered():
    def alter(solve, cfg, W, I_ext, model):
        res = solve(cfg, W, I_ext, model)
        r = res.r.clone()
        r[..., 0, :, :] *= 2.0
        return res._replace(r=r)

    return _solve_patch(alter)


def half_batch():
    import torch

    def alter(solve, cfg, W, I_ext, model):
        half = W.shape[-3] // 2
        res = solve(cfg, W[..., :half, :, :], I_ext, model)
        return type(res)(*(torch.cat([t, t], dim=-3 if t.ndim == W.ndim
                                     else -2) for t in res))

    return _solve_patch(alter)


def state_unchanged():
    from tcgan_torch.models import wgan

    step = wgan.train_step

    def patched(cfg, n_critic, state, real_stack, **kw):
        return state, step(cfg, n_critic, state, real_stack, **kw)[1]

    return _patched(wgan, "train_step", patched)


def gen_lr_doubled():
    import dataclasses

    from tcgan_torch.models import wgan

    step = wgan.train_step

    def patched(cfg, n_critic, state, real_stack, **kw):
        cfg = dataclasses.replace(cfg, lr_gen=2.0 * cfg.lr_gen)
        return step(cfg, n_critic, state, real_stack, **kw)

    return _patched(wgan, "train_step", patched)


PLANTS = {f.__name__: f for f in (answer_altered, half_batch,
                                  state_unchanged, gen_lr_doubled)}
