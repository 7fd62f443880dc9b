"""The program's record (``tcgan_torch.utils.profiling``): spans, blocking
host syncs and the solver's substeps by phase, recorded only while a
``torch.profiler`` session runs, one session at a time.

The CPU tests run a forward batch and a GAN step at tiny shapes on the
kernel backend, whose CPU path is the kernel's plain version. The tests
marked ``cuda`` skip where no CUDA device is visible; the file imports no
jax, so the machine with the card runs them as they are:

    python -m pytest tests/test_torch_profiling.py -m cuda -q --noconftest
"""

import warnings

import numpy as np
import pytest
import torch

from tcgan_torch.models import generator as gen_lib
from tcgan_torch.models import wgan
from tcgan_torch.ops import weights
from tcgan_torch.ops.cuda import ssn_solve
from tcgan_torch.ops.ssn import SSNConfig
from tcgan_torch.tools import ssn_solve_ab as ab
from tcgan_torch.utils import profiling

TRUE = (((0.045, 0.04), (0.05, 0.035)), ((0.1, 0.08), (0.1, 0.08)),
        ((0.25, 0.1), (0.25, 0.1)))
SSN = dict(N=8, k=0.01, n=2.2, dt=0.001, max_iter=2000, atol=1e-4,
           check_every=8, backend="cuda")
GEN = dict(bandwidths=(0.25, 1.0), contrasts=(5.0,))
SPANS = ("generator.weights", "generator.battery", "generator.solve",
         "generator.readout")
B = 4


def _gen_cfg(**ssn):
    return gen_lib.GeneratorConfig(ssn=SSNConfig(**{**SSN, **ssn}), **GEN)


def _forward(cfg, device="cpu", B=B, seed=0):
    """A forward batch of B circuits, its inputs made: call it to run."""
    params = gen_lib.init_params(cfg, *TRUE, device=device)
    z = weights.sample_z(torch.Generator(device).manual_seed(seed), (B,),
                         cfg.ssn.N, device=device)

    def run():
        with torch.no_grad():
            return gen_lib.sample_tuning_curves(cfg, params, B, z=z)
    return run


def _batch(cfg, device="cpu", B=B, seed=0):
    return _forward(cfg, device, B, seed)()


def _gan_step(device="cpu", host_eps=True):
    """One tiny GAN step (2 critic updates), its inputs made: call it to
    run. ``host_eps``: the GP eps come as host arrays."""
    cfg = wgan.WGANConfig(gen=_gen_cfg(N=6), critic_layers=(16, 16),
                          batch_size=4, n_critic=2, n_critic0=2,
                          clip_grad=1.0)
    state = wgan.init_state(cfg, device=device)
    rng = np.random.default_rng(1)
    real = torch.tensor(rng.normal(1.0, 0.1, (2, cfg.critic_batch,
                                              cfg.gen.tc_dim)),
                        dtype=torch.float32, device=device)
    noise = wgan.draw_step_noise(cfg, 2, real,
                                 torch.Generator(device).manual_seed(3))
    if host_eps:
        noise = noise._replace(gp_eps=[e.cpu().numpy()
                                       for e in noise.gp_eps])
    return lambda: wgan.train_step(cfg, 2, state, real, noise=noise)


def _step(device="cpu", host_eps=True):
    return _gan_step(device, host_eps)()


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return prof, profiling.counters()


def _syncs(counts):
    return sum(v for k, v in counts.items() if k.startswith("host_syncs."))


def test_nothing_recorded_without_a_profiler(monkeypatch):
    """No profiler: a forward batch and a GAN step enter no span and count
    nothing, and a profiler started afterwards finds no span of theirs."""
    entered = []
    real_rf = torch.profiler.record_function

    def counting(name, *a, **kw):
        entered.append(name)
        return real_rf(name, *a, **kw)

    profiling.reset()
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    _batch(_gen_cfg())
    _step()
    assert entered == []
    assert profiling.counters() == {}
    prof, counts = _profiled(lambda: None)
    names = {e.name for e in prof.events()}
    assert not {n for n in names if n.startswith(
        ("generator.", "ift.", "wgan.", "ssn_solve.", "host_sync."))}
    assert counts == {}


def test_generator_spans_in_order():
    """``generator.sample`` holds the weights, battery, solve and readout
    spans, in that order, and a ``host_sync.generator.battery`` inside the
    battery's."""
    prof, _ = _profiled(lambda: _batch(_gen_cfg()))
    ev = {e.name: e.time_range for e in prof.events()
          if e.name.startswith(("generator.", "host_sync."))}
    outer = ev["generator.sample"]
    inner = [ev[n] for n in SPANS]
    assert all(outer.start <= t.start <= t.end <= outer.end for t in inner)
    assert all(a.end <= b.start for a, b in zip(inner, inner[1:]))
    sync = ev["host_sync.generator.battery"]
    assert ev["generator.battery"].start <= sync.start <= sync.end \
        <= ev["generator.battery"].end


@pytest.mark.parametrize("batches", [1, 3])
def test_battery_syncs_twice_a_batch(batches):
    cfg = _gen_cfg()
    _, counts = _profiled(
        lambda: [_batch(cfg, seed=i) for i in range(batches)])
    assert counts["host_syncs.generator.battery"] == 2 * batches
    assert _syncs(counts) == 2 * batches
    assert counts["sync_wait_ns.generator.battery"] > 0
    assert counts["ssn_solve.rows"] == batches * B * 2


def test_gan_step_counts_every_sync_site():
    """A step of 2 critic updates: 3 solves' battery copies, the adjoint's
    stop tests, and the GP eps only where it comes from host memory."""
    _, counts = _profiled(_step)
    assert counts["host_syncs.generator.battery"] == 2 * 3
    assert counts["host_syncs.wgan.gp_eps"] == 2
    assert counts["host_syncs.ift.stop_test"] >= 1
    assert _syncs(counts) == 8 + counts["host_syncs.ift.stop_test"]
    _, counts = _profiled(lambda: _step(host_eps=False))
    assert "host_syncs.wgan.gp_eps" not in counts


@pytest.mark.parametrize("schedule", sorted(ab.SCHEDULES))
def test_substep_totals_are_the_plain_stats(schedule):
    """The solve's phase totals in the record are the sums of
    ``solve_fixed_point_plain(stats=)``; one phase counts as phase 2."""
    cfg = _gen_cfg(**ab.SCHEDULES[schedule])
    _, counts = _profiled(lambda: _batch(cfg))
    params = gen_lib.init_params(cfg, *TRUE)
    J, D, S = gen_lib.param_values(cfg, params)
    z = weights.sample_z(torch.Generator().manual_seed(0), (B,), cfg.ssn.N,
                         device="cpu")
    W = weights.build_weight(J, D, S, z, cfg.ssn.site_pos())
    stats = {}
    ssn_solve.solve_fixed_point_plain(cfg.ssn, W, cfg.stimulus_battery(),
                                      cfg.ssn.check_every, stats=stats)
    want = [int(stats[k].sum()) for k in ("phase1_substeps",
                                          "phase2_substeps")]
    got = [counts[k] for k in ssn_solve.SUBSTEPS]
    assert got == want and want[1] > 0
    assert (want[0] > 0) == (schedule != "one")


def test_reset_and_sessions_do_not_mix():
    """Each session's record holds its own batch alone (the counts equal;
    the wait times are each session's own clock readings)."""
    def counts(c):
        assert c["sync_wait_ns.generator.battery"] > 0
        return {k: v for k, v in c.items() if not k.startswith("sync_wait")}

    cfg = _gen_cfg()
    _, one = _profiled(lambda: _batch(cfg))
    assert _syncs(one) == 2
    # a second session, straight after the first was read
    _, again = _profiled(lambda: _batch(cfg))
    assert counts(again) == counts(one)
    # a session after an untraced batch
    _batch(cfg)
    _, third = _profiled(lambda: _batch(cfg))
    assert counts(third) == counts(one)
    profiling.reset()
    assert profiling.counters() == {}


# -- on the card ------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _sync_warnings(fn):
    """(syncs the record counted, where the sync debug mode warned of one)
    over ``fn`` under a profiler. The mode is set outside the warnings
    caught: setting it warns that it is a prototype."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    warned = [f"{w.filename}:{w.lineno}" for w in caught
              if "synchroniz" in str(w.message)]
    return _syncs(profiling.counters()), warned


@pytest.mark.cuda
def test_sync_count_equals_the_sync_warnings(cuda_device):
    """Every blocking sync of an N=51 forward batch (B=512, 8 bandwidths)
    and of a tiny GAN step (host GP eps) is counted at its site."""
    cfg = gen_lib.GeneratorConfig(
        ssn=SSNConfig(N=51, max_iter=8000, atol=1e-4, check_every=32,
                      backend="cuda"),
        bandwidths=(0.0, 0.0625, 0.125, 0.1875, 0.25, 0.5, 0.75, 1.0),
        contrasts=(10.0,))
    batch = _forward(cfg, cuda_device, B=512)
    batch()  # builds and loads the library
    counted, warned = _sync_warnings(batch)
    assert counted == len(warned) == 2, warned
    step = _gan_step(cuda_device)
    step()
    counted, warned = _sync_warnings(step)
    assert counted == len(warned) >= 2 * 3 + 2 + 1, (counted, warned)


# tests/test_torch_ssn_solve_cuda.py::TWO_PHASE_CASES, whose iters that
# file holds to the plain version (copied: the card's machine cannot import
# one test file from another): (N, B, contrasts, SSNConfig overrides,
# accel) on every path of the kernel
TWO_PHASE_CASES = {
    "register_S8": (51, 32, (10.0,), {}, False),
    "register_S16_atol1e-5": (51, 32, (5.0, 10.0),
                              dict(atol=1e-5, max_iter=10000), False),
    "register_anderson_S16": (51, 16, (5.0, 10.0),
                              dict(atol=1e-5, max_iter=10000), True),
    "one_block_2N224_S8": (112, 8, (10.0,), {}, False),
    "cluster_2N402_S8": (201, 8, (10.0,), {}, False),
    "chunks_2N402_S32_anderson": (201, 4, (2.5, 5.0, 7.5, 10.0), {}, True),
    "wglobal_2N600_S8": (300, 4, (10.0,), {}, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", sorted(ab.SCHEDULES))
@pytest.mark.parametrize("case", sorted(TWO_PHASE_CASES))
def test_kernel_phase_totals_equal_the_plain_replay(cuda_device, case,
                                                    schedule):
    """The kernel's device totals against the plain version's ``stats``,
    its fast pass in emulated TF32, replayed to the kernel's iters."""
    N, batch, contrasts, cfg_kw, accel = TWO_PHASE_CASES[case]
    cfg, W, I = ab.problem(batch, contrasts, {**cfg_kw,
                                              **ab.SCHEDULES[schedule]},
                           N=N, seed=1, two_phase=True)
    totals = torch.zeros(2, dtype=torch.int64, device=cuda_device)
    out, _, _ = ssn_solve.launch(ssn_solve._library(), cfg, W, I, 32, accel,
                                 substeps=totals)
    stats = {}
    fast = ssn_solve.drive_1xtf32 if cfg.pallas_two_phase else None
    ref = ssn_solve.solve_fixed_point_plain(cfg, W, I, 32, accel,
                                            fast_drive=fast,
                                            stop_at=out.iters, stats=stats)
    want = [int(stats[k].sum()) for k in ("phase1_substeps",
                                          "phase2_substeps")]
    assert totals.tolist() == want, (
        totals.tolist(), want, int((ref.iters != out.iters).sum()))
    assert (want[0] > 0) == cfg.pallas_two_phase
    # the same launch counting nothing gives the same solve
    plain, _, _ = ssn_solve.launch(ssn_solve._library(), cfg, W, I, 32,
                                   accel)
    for a, b in zip(out, plain):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_launch_counts_only_under_a_profiler(cuda_device):
    """The wrapper hands the kernel a buffer only while a profiler runs;
    rows and substeps come back in the record."""
    batch = _forward(_gen_cfg(), cuda_device)
    profiling.reset()
    batch()
    assert profiling.counters() == {}
    _, counts = _profiled(batch)
    assert counts["ssn_solve.rows"] == B * 2
    assert all(counts[k] > 0 for k in ssn_solve.SUBSTEPS)
