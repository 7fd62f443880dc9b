"""The GAN training driver: the step loop with recording, checkpointing and
numerical-failure accounting.

Port of :class:`tcgan_tpu.train.driver.GANDriver`:

- per step: sample real minibatches, run the model's train step
  (``n_critic`` critic updates + 1 generator update), record the streams;
- ``n_critic0`` critic updates for the first ``n_critic0_steps`` steps of a
  fresh run, ``n_critic`` afterwards (a resumed run starts past them);
- ONE device->host copy per step for everything the step records
  (:func:`device_get`); the iterative adjoint's stop test is the only other
  device->host copy inside a step;
- pervasive divergence aborts with ``PervasiveDivergenceError``;
- periodic full-state checkpoints and ``disc_params.npz`` exports; a
  resumed run drops the streams' rows from the replayed window;
- the adaptive train-time solver budget (``max_iter`` in power-of-2
  buckets, with an escape valve and a sidecar that survives resume). The
  CUDA kernel takes ``max_iter`` at run time, so a new budget costs
  nothing.

Under a mesh (``--parallel mesh``) every rank runs the loop on replicated
metrics, so all take the same decisions (abort, budget, checkpoint) and
reach the same collectives; only rank 0 writes (the recorders, the
checkpoints, the exports and the sidecar).

:class:`MomentMatchingDriver` runs the moment-matching fit with the same
stream handling, one host copy per step, divergence accounting and graceful
stop.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import signal
from typing import Any, Callable, Optional

import numpy as np
import torch

from tcgan_torch.models import generator as gen_lib
from tcgan_torch.train.checkpoint import CheckpointManager
from tcgan_torch.train.datastore import DataStore, PervasiveDivergenceError
from tcgan_torch.train.recorders import (GEN_COLUMNS, CSVRecorder,
                                         JSONLRecorder, RecorderSet,
                                         flatten_gen_params)
from tcgan_torch.utils.stopwatch import StopWatch


def device_get(tree: Any) -> Any:
    """Copy every tensor of a nested dict/list/tuple to host NumPy in ONE
    device->host transfer (each leaf keeps its dtype; bfloat16 comes back
    as float32). Other leaves pass through."""
    leaves = []

    def collect(x):
        if torch.is_tensor(x):
            leaves.append(x.detach())
        elif isinstance(x, dict):
            for v in x.values():
                collect(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                collect(v)

    collect(tree)
    if not leaves:
        return tree
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in leaves])
    flat = flat.cpu().numpy()
    out, pos = [], 0
    for t in leaves:
        n = t.numel()
        dtype = (np.float32 if t.dtype == torch.bfloat16
                 else torch.empty((), dtype=t.dtype).numpy().dtype)
        out.append(flat[pos:pos + n].reshape(tuple(t.shape)).astype(dtype))
        pos += n
    it = iter(out)

    def rebuild(x):
        if torch.is_tensor(x):
            return next(it)
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(rebuild(v) for v in x))
        if isinstance(x, dict):
            return {k: rebuild(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(rebuild(v) for v in x)
        return x

    return rebuild(tree)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _divergence_streak(streak: int, frac: float, cfg: "DriverConfig",
                       step: int) -> int:
    """Pervasive-divergence accounting: returns the updated streak, raising
    PervasiveDivergenceError at patience."""
    streak = streak + 1 if frac > cfg.divergence_abort else 0
    if streak >= cfg.divergence_patience:
        raise PervasiveDivergenceError(
            f"step {step}: diverged fraction {frac:.2f} exceeded "
            f"{cfg.divergence_abort} for {streak} steps")
    return streak


def _step_generator(seed: int, start: int, device) -> torch.Generator:
    """The step loop's noise source: a resumed run draws fresh noise
    instead of replaying steps 0..start."""
    seed = int(np.random.SeedSequence([seed, start]).generate_state(1)[0])
    return torch.Generator(device).manual_seed(seed)


class _GracefulStop:
    """Preemption-safe stop: SIGTERM/SIGINT set a flag that the step loop
    checks at step boundaries; the loop then checkpoints the last completed
    step and finalizes the datastore as "interrupted". A second signal
    falls through to the previous handler. No-op off the main thread."""

    def __init__(self):
        self.requested = False
        self._old = {}

    def __enter__(self):
        def _request(signum, frame):
            if self.requested:  # second signal: escalate
                signal.signal(signum, self._old.get(signum, signal.SIG_DFL))
                raise KeyboardInterrupt
            self.requested = True

        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._old[sig] = signal.signal(sig, _request)
            except ValueError:  # non-main thread
                pass
        return self

    def __exit__(self, *exc):
        for sig, handler in self._old.items():
            signal.signal(sig, handler)
        return False


@dataclasses.dataclass(frozen=True)
class DriverConfig:
    n_steps: int = 1000
    n_critic0_steps: int = 1  # how many initial steps use n_critic0
    checkpoint_every: int = 100
    tc_mean_every: int = 50
    timing_every: int = 0  # measure SSsolve_time/gradient_time every k steps
    divergence_abort: float = 0.5  # abort if frac_diverged > this ...
    divergence_patience: int = 20  # ... for this many consecutive steps
    seed: int = 0
    # cap max_iter at adaptive_margin x the EMA of healthy steps' mean
    # iteration count, in power-of-2 buckets
    adaptive_max_iter: bool = False
    adaptive_margin: float = 4.0


class GANDriver:
    """Runs a WGAN fit. The model supplies ``train_step(cfg, n_critic,
    state, real_stack, generator=)``; ``real_sampler(generator, n_stacks,
    batch)`` draws the real minibatches."""

    _ADAPTIVE_SIDECAR = "adaptive_budget.json"

    def __init__(
        self,
        model_cfg: Any,
        driver_cfg: DriverConfig,
        store: DataStore,
        train_step: Callable,
        state: Any,
        real_sampler: Callable,
        checkpoints: Optional[CheckpointManager] = None,
        gen_loss_fn: Optional[Callable] = None,
    ):
        self.model_cfg = model_cfg
        self.cfg = driver_cfg
        self.store = store
        self.train_step = train_step
        self.state = state
        self.real_sampler = real_sampler
        # (cfg, gen_params, critic_params) -> (loss, aux): the model's
        # generator loss, timed by the gradient_time probe
        self.gen_loss_fn = gen_loss_fn
        self.checkpoints = checkpoints or CheckpointManager(
            store.subdir("ckpt"))
        self.device = next(iter(state.gen_params.values())).device
        self.recorders = RecorderSet(
            store, critic_param_names=list(state.critic_params.keys()))
        self.watch = StopWatch()
        self._div_streak = 0
        self._probes_warm = False
        self._iter_ema = None  # EMA of healthy-step mean iters
        self._capped_unhealthy = 0  # escape-valve streak
        self._orig_max_iter = int(model_cfg.gen.ssn.max_iter)
        if self.cfg.adaptive_max_iter:
            self._restore_adaptive_state()

    def run(self, n_steps: Optional[int] = None, on_step=None):
        n_steps = n_steps if n_steps is not None else self.cfg.n_steps
        start = int(self.state.step)
        if start > 0:
            # resume: drop the rows of the replayed window
            self.recorders.truncate_from(start)
        generator = _step_generator(self.cfg.seed, start, self.device)
        stop = _GracefulStop()
        stop.__enter__()
        try:
            for step in range(start, start + n_steps):
                n_critic = (self.model_cfg.n_critic0
                            if step < self.cfg.n_critic0_steps
                            else self.model_cfg.n_critic)
                real_stack = self.real_sampler(generator, n_critic,
                                               self.model_cfg.critic_batch)
                with self.watch.time("train"):
                    self.state, metrics = self.train_step(
                        self.model_cfg, n_critic, self.state, real_stack,
                        generator=generator)
                    _sync(self.device)
                metrics = self._record(step, metrics)
                self._check_divergence(step, metrics)
                if self.cfg.adaptive_max_iter:
                    self._adapt_solver_budget(step, metrics)
                if on_step is not None:
                    on_step(step, self.state, metrics)
                if (self.cfg.checkpoint_every
                        and (step + 1) % self.cfg.checkpoint_every == 0):
                    self._checkpoint(step + 1)
                if stop.requested:
                    break
            self._checkpoint(int(self.state.step))
            self.store.finalize("interrupted" if stop.requested
                                else "finished")
        except PervasiveDivergenceError as e:
            self.store.finalize("known_error", {"error": str(e)})
            raise
        except BaseException:
            self.store.finalize("crashed")
            raise
        finally:
            stop.__exit__()
            self.recorders.close()
        return self.state

    def _checkpoint(self, step: int):
        self.checkpoints.save(step, self.state)
        self._export_params(step)
        self._save_adaptive_state()

    def _export_params(self, step: int):
        """``disc_params.npz``: critic params and generator values (and
        their EMA), readable without torch."""
        if not self.store.writer:
            return
        host = device_get((self.state.gen_params, self.state.ema_params,
                           self.state.critic_params))
        gen, ema, critic = host
        values = gen_lib.param_values_np(self.model_cfg.gen, gen)
        extra = {}
        if ema is not None:
            extra = {f"{n}_ema": v for n, v in zip(
                ("J", "D", "S"), gen_lib.param_values_np(self.model_cfg.gen,
                                                         ema))}
        np.savez(self.store.file("disc_params.npz"), step=np.asarray(step),
                 J=values[0], D=values[1], S=values[2], **extra, **critic)

    # -- internals ---------------------------------------------------------

    def _record(self, step: int, metrics):
        probed = bool(self.cfg.timing_every
                      and step % self.cfg.timing_every == 0)
        if probed:
            self._measure_component_times()
        tc_mean = None
        if self.cfg.tc_mean_every and step % self.cfg.tc_mean_every == 0:
            with torch.no_grad():
                tc_mean = gen_lib.sample_tuning_curves(
                    self.model_cfg.gen, self.state.gen_params,
                    self.model_cfg.batch_size,
                    generator=torch.Generator(self.device).manual_seed(step),
                ).tc.mean(dim=0)
        # ONE device->host copy for everything this step records
        metrics, gen_params, critic_params, tc_mean = device_get(
            (metrics, self.state.gen_params, self.state.critic_params,
             tc_mean))
        row = {k: v for k, v in metrics._asdict().items()
               if not k.endswith("_iters") or k == "mean_iters"}
        row["step"] = step
        row["train_time"] = self.watch.last("train")
        # NaN on steps without a probe: a repeated lap would read as fresh
        row["SSsolve_time"] = self.watch.last("SSsolve") if probed else np.nan
        row["gradient_time"] = (self.watch.last("gradient") if probed
                                else np.nan)
        self.recorders.record_learning(row)
        iters_streams = tuple(
            getattr(metrics, n, None)
            for n in ("d_loss_iters", "wasserstein_iters", "gp_iters",
                      "acc_iters"))
        if all(s is not None for s in iters_streams):
            self.recorders.record_disc_learning(step, *iters_streams)
        self.recorders.record_generator(
            step, gen_lib.param_values_np(self.model_cfg.gen, gen_params))
        self.recorders.record_disc_stats(step, {
            f"{k}.{s}": v
            for k, p in critic_params.items()
            for s, v in (("nnorm", float(np.linalg.norm(p.ravel()))),
                         ("absmax", float(np.max(np.abs(p)))))
        })
        if tc_mean is not None:
            self.recorders.record_tc_mean(step, tc_mean)
        return metrics  # host copy, for divergence checks / callbacks

    def _measure_component_times(self):
        """The SSsolve_time / gradient_time columns: wall clock of a forward
        batch solve and of a generator loss gradient, out of band of the
        train step (the first probe is a warm-up, not timed)."""
        gen_cfg, batch = self.model_cfg.gen, self.model_cfg.batch_size
        gen = torch.Generator(self.device).manual_seed(int(self.state.step))

        def solve():
            with torch.no_grad():
                gen_lib.sample_tuning_curves(gen_cfg, self.state.gen_params,
                                             batch, generator=gen)
            _sync(self.device)

        def grad():
            leaves = {k: v.detach().requires_grad_(True)
                      for k, v in self.state.gen_params.items()}
            if self.gen_loss_fn is not None:
                loss = self.gen_loss_fn(self.model_cfg, leaves,
                                        self.state.critic_params,
                                        generator=gen)[0]
            else:
                loss = gen_lib.sample_tuning_curves(
                    gen_cfg, leaves, batch, generator=gen).tc.mean()
            torch.autograd.grad(loss, list(leaves.values()))
            _sync(self.device)

        if not self._probes_warm:
            solve()
            grad()
            self._probes_warm = True
        with self.watch.time("SSsolve"):
            solve()
        with self.watch.time("gradient"):
            grad()

    def _adapt_solver_budget(self, step: int, metrics):
        """Adaptive train-time max_iter: healthy steps (>= 90% converged)
        update an EMA of the mean iteration count and the budget is
        ``adaptive_margin x EMA`` rounded up to a power of two (floor 1024,
        ceiling the configured max_iter). Unhealthy steps do not update the
        EMA; 50 capped unhealthy steps in a row double it (escape valve)."""
        fconv = float(metrics.frac_converged)
        miters = float(metrics.mean_iters)
        capped = self.model_cfg.gen.ssn.max_iter < self._orig_max_iter
        if fconv >= 0.9 and math.isfinite(miters) and miters > 0:
            self._iter_ema = (miters if self._iter_ema is None
                              else 0.95 * self._iter_ema + 0.05 * miters)
            self._capped_unhealthy = 0
        elif capped:
            self._capped_unhealthy += 1
            if self._capped_unhealthy >= 50:
                self._iter_ema *= 2.0
                self._capped_unhealthy = 0
                print(f"[driver] step {step}: adaptive budget escape valve"
                      f" — <90% converged for 50 capped steps, EMA -> "
                      f"{self._iter_ema:.0f}")
        if self._iter_ema is None:
            return
        target = self.cfg.adaptive_margin * self._iter_ema
        bucket = 1 << max(10, math.ceil(math.log2(max(target, 1.0))))
        bucket = min(bucket, self._orig_max_iter)
        ssn = self.model_cfg.gen.ssn
        if bucket != ssn.max_iter:
            print(f"[driver] step {step}: adaptive solver budget "
                  f"max_iter {ssn.max_iter} -> {bucket} "
                  f"(healthy mean iters EMA {self._iter_ema:.0f})")
            self._set_max_iter(bucket)

    def _set_max_iter(self, max_iter: int):
        gen = dataclasses.replace(
            self.model_cfg.gen,
            ssn=dataclasses.replace(self.model_cfg.gen.ssn,
                                    max_iter=max_iter))
        self.model_cfg = dataclasses.replace(self.model_cfg, gen=gen)

    def _save_adaptive_state(self):
        if (not self.cfg.adaptive_max_iter or self._iter_ema is None
                or not self.store.writer):
            return
        path = self.store.file(self._ADAPTIVE_SIDECAR)
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps({
            "iter_ema": self._iter_ema,
            "max_iter": int(self.model_cfg.gen.ssn.max_iter)}))
        os.replace(tmp, path)

    def _restore_adaptive_state(self):
        path = self.store.file(self._ADAPTIVE_SIDECAR)
        try:
            saved = json.loads(path.read_text())
        except (OSError, ValueError):
            return
        self._iter_ema = float(saved["iter_ema"])
        bucket = min(int(saved["max_iter"]), self._orig_max_iter)
        if bucket < self._orig_max_iter:
            print(f"[driver] resume: restoring adaptive solver budget "
                  f"max_iter -> {bucket} (EMA {self._iter_ema:.0f})")
            self._set_max_iter(bucket)

    def _check_divergence(self, step: int, metrics):
        self._div_streak = _divergence_streak(
            self._div_streak, float(metrics.frac_diverged), self.cfg, step)


class MomentMatchingDriver:
    """Runs a moment-matching fit. The model supplies ``train_step(cfg,
    state, data_mean, data_second, generator=)``; ``learning.csv``,
    ``learning.jsonl`` and ``generator.csv`` get one row per step."""

    LEARNING_COLUMNS = ["step", "loss", "mean_err", "cov_err",
                        "rate_penalty", "frac_converged", "frac_diverged",
                        "train_time"]

    def __init__(self, model_cfg, driver_cfg: DriverConfig, store: DataStore,
                 train_step: Callable, state, data_moments,
                 checkpoints: Optional[CheckpointManager] = None):
        self.model_cfg = model_cfg
        self.cfg = driver_cfg
        self.store = store
        self.train_step = train_step
        self.state = state
        self.data_mean, self.data_second = data_moments
        self.checkpoints = checkpoints or CheckpointManager(
            store.subdir("ckpt"))
        self.device = next(iter(state.gen_params.values())).device
        self._learning = CSVRecorder(store.file("learning.csv"),
                                     self.LEARNING_COLUMNS)
        self._jsonl = JSONLRecorder(store.file("learning.jsonl"))
        self._gen = CSVRecorder(store.file("generator.csv"), GEN_COLUMNS)
        self.watch = StopWatch()
        self._div_streak = 0

    def run(self, n_steps: Optional[int] = None, on_step=None):
        n_steps = n_steps if n_steps is not None else self.cfg.n_steps
        start = int(self.state.step)
        streams = (self._learning, self._jsonl, self._gen)
        if start > 0:
            for rec in streams:  # resume: drop the replayed window's rows
                rec.truncate_from(start)
        generator = _step_generator(self.cfg.seed, start, self.device)
        stop = _GracefulStop()
        stop.__enter__()
        try:
            for step in range(start, start + n_steps):
                with self.watch.time("train"):
                    self.state, m = self.train_step(
                        self.model_cfg, self.state, self.data_mean,
                        self.data_second, generator=generator)
                    _sync(self.device)
                # ONE device->host copy for everything this step records
                m, gen_params = device_get((m, self.state.gen_params))
                row = dict(step=step, **m._asdict(),
                           train_time=self.watch.last("train"))
                self._learning.record(row)
                self._jsonl.record(row)
                g = {"step": step}
                g.update(flatten_gen_params(
                    gen_lib.param_values_np(self.model_cfg.gen, gen_params)))
                self._gen.record(g)
                self._div_streak = _divergence_streak(
                    self._div_streak, float(m.frac_diverged), self.cfg, step)
                if on_step is not None:
                    on_step(step, self.state, m)
                if (self.cfg.checkpoint_every
                        and (step + 1) % self.cfg.checkpoint_every == 0):
                    self.checkpoints.save(step + 1, self.state)
                if stop.requested:
                    break
            self.checkpoints.save(int(self.state.step), self.state)
            self.store.finalize("interrupted" if stop.requested
                                else "finished")
        except PervasiveDivergenceError as e:
            self.store.finalize("known_error", {"error": str(e)})
            raise
        except BaseException:
            self.store.finalize("crashed")
            raise
        finally:
            stop.__exit__()
            for rec in streams:
                rec.close()
        return self.state
