"""Port parity for the GAN slice's data and run plumbing:
``tcgan_torch.data.datasets``, ``tcgan_torch.train.{recorders,checkpoint,
driver}`` against their ``tcgan_tpu`` counterparts.

- fake truth with the reference's z replayed (key splits of
  ``generate_fake_truth``), f64 lockstep: survivor selection equal, tuning
  curves to rtol 1e-10;
- recorder streams byte-equal for the same rows;
- checkpoints: exact round trip, forward-compatible restore;
- the driver: divergence abort, the adaptive budget's bucket sequence
  equal to the reference driver's on the same metric sequence, resume
  truncation, one host copy per step.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tcgan_tpu.data import datasets as jdata
from tcgan_tpu.models import generator as jgen
from tcgan_tpu.models import wgan as jwgan
from tcgan_tpu.ops import ssn as jssn
from tcgan_tpu.ops import weights as jweights
from tcgan_tpu.train import datastore as jstore
from tcgan_tpu.train import driver as jdriver
from tcgan_tpu.train import recorders as jrec
from tcgan_torch.data import datasets as tdata
from tcgan_torch.models import generator as tgen
from tcgan_torch.models import wgan as twgan
from tcgan_torch.ops import ssn as tssn
from tcgan_torch.train import checkpoint as tckpt
from tcgan_torch.train import datastore as tstore
from tcgan_torch.train import driver as tdriver
from tcgan_torch.train import recorders as trec

SSN = dict(N=6, k=0.005, n=2.0, dt=0.001, max_iter=150, atol=1e-5,
           check_every=4)
GEN = dict(bandwidths=(0.25, 1.0), contrasts=(5.0,))
TRUE = (((0.08, 0.06), (0.09, 0.05)), ((0.2, 0.15), (0.2, 0.15)),
        ((0.25, 0.1), (0.25, 0.1)))


def _tcfg(**ssn_kw):
    return tgen.GeneratorConfig(ssn=tssn.SSNConfig(**{**SSN, **ssn_kw}),
                                dtype=torch.float64, **GEN)


def test_fake_truth_matches_jax_with_replayed_z():
    """150 iterations leave some circuits unconverged: the survivor
    selection and the kept tuning curves equal the reference's."""
    jcfg = jgen.GeneratorConfig(ssn=jssn.SSNConfig(**SSN),
                                dtype=jnp.float64, **GEN)
    kw = dict(num_samples=20, seed=3, batch=8)
    ref = jdata.generate_fake_truth(jcfg, *TRUE, **kw)
    key, zs = jax.random.PRNGKey(kw["seed"]), []
    for _ in range(8):
        key, sub = jax.random.split(key)
        zs.append(np.array(jweights.sample_z(sub, (kw["batch"],), SSN["N"],
                                             dtype=jnp.float64)))
    out = tdata.generate_fake_truth(_tcfg(), *TRUE, zs=zs, **kw)
    assert out.shape == ref.shape == (20, 2)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-10)
    # the yield really was partial: some batch lost circuits
    params = tgen.init_params(_tcfg(), *TRUE)
    with torch.no_grad():
        kept = [int(tgen.sample_tuning_curves(_tcfg(), params, 8, z=z)
                    .converged.all(-1).sum()) for z in zs[:4]]
    assert 0 < min(kept) < 8, kept


def test_fake_truth_unstable_params_raise_known_error():
    with pytest.raises(tstore.KnownError, match="fake-truth"):
        tdata.generate_fake_truth(_tcfg(max_iter=8), *TRUE, num_samples=4,
                                  batch=2)
    assert issubclass(tstore.PervasiveDivergenceError, tstore.KnownError)


def test_dataset_sampling_and_moments():
    arr = np.random.default_rng(0).normal(size=(10, 3))
    ds = tdata.TuningCurveDataset.from_array(arr)
    ref = jdata.TuningCurveDataset.from_array(arr)
    assert ds.num_samples == 10 and ds.tc_dim == 3 and ds.tc.dtype == \
        torch.float32
    stack = ds.sample_stack(torch.Generator().manual_seed(0), 4, 5)
    assert stack.shape == (4, 5, 3)
    for a, b in zip(ds.moments(), ref.moments()):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def _rows(step, rng):
    f = lambda: np.float32(rng.normal())  # noqa: E731
    return dict(
        step=step, d_loss=f(), g_loss=f(), wasserstein=f(), gp=f(),
        rate_penalty=np.float32(0.0), d_accuracy=np.float32(0.5),
        frac_converged=np.float32(1.0), frac_diverged=np.float32(0.0),
        mean_iters=np.float32(336.0), anchor_residual=None,
        circuit_yield=np.float32(1.0), drift_ratio=None,
        train_time=0.123456789, SSsolve_time=np.nan, gradient_time=np.nan)


def test_recorder_streams_byte_equal_to_jax(tmp_path):
    rng = np.random.default_rng(1)
    critic = {"w0": rng.normal(size=(2, 4)).astype(np.float32),
              "b0": np.zeros(4, np.float32)}
    sets = {}
    for name, rec, store in (("jax", jrec, jstore), ("port", trec, tstore)):
        sets[name] = rec.RecorderSet(store.DataStore(tmp_path / name),
                                     critic_param_names=list(critic))
    for step in range(4):
        row = _rows(step, rng)
        vals = [rng.normal(size=(2, 2)).astype(np.float32) for _ in range(3)]
        iters = [rng.normal(size=3).astype(np.float32) for _ in range(4)]
        stats = {f"{k}.nnorm": np.float32(np.linalg.norm(v))
                 for k, v in critic.items()}
        for rs in sets.values():
            rs.record_learning(row)
            rs.record_generator(step, vals)
            rs.record_disc_learning(step, *iters)
            rs.record_disc_stats(step, stats)
            rs.record_tc_mean(step, vals[0].ravel())
    for rs in sets.values():
        rs.truncate_from(2)
        rs.close()
    names = ("learning.csv", "learning.jsonl", "generator.csv",
             "disc_learning.csv", "disc_param_stats.csv", "tc_mean.jsonl")
    for name in names:
        a = (tmp_path / "jax" / name).read_bytes()
        b = (tmp_path / "port" / name).read_bytes()
        assert a == b, name
        assert a.count(b"\n") >= 2, name
    assert trec.LEARNING_COLUMNS == jrec.LEARNING_COLUMNS
    assert trec.GEN_COLUMNS == jrec.GEN_COLUMNS
    assert trec.flatten_gen_params(vals) == jrec.flatten_gen_params(vals)


def _wgan_cfg(**kw):
    return twgan.WGANConfig(gen=_tcfg(max_iter=2000), critic_layers=(8,),
                            batch_size=2, n_critic=2, n_critic0=3, **kw)


def _assert_same(a, b):
    if torch.is_tensor(a):
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, tuple):
        assert type(a) is type(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        assert a == b


def test_checkpoint_roundtrip_and_forward_compat(tmp_path, capsys):
    cfg = _wgan_cfg(moment_anchor=1e-3, ema_decay=0.9)
    dm = (np.ones(2), np.eye(2))
    state = twgan.init_state(cfg, data_moments=dm)
    state = state._replace(
        step=7, gen_opt=state.gen_opt._replace(
            count=torch.tensor(5, dtype=torch.int32)))
    mgr = tckpt.CheckpointManager(tmp_path / "ckpt", max_to_keep=2)
    for step in (3, 5, 7):
        mgr.save(step, state)
    assert mgr.latest_step() == 7
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == \
        ["5.pt", "7.pt"]
    template = twgan.init_state(cfg, generator=torch.Generator().manual_seed(
        9), data_moments=dm)
    restored = mgr.restore(template)
    _assert_same(restored, state)
    assert isinstance(restored.gen_opt, twgan.AdamState)

    # a checkpoint written before a field existed: the field keeps its
    # fresh-init value (here: the EMA params and the endgame latch)
    plain = tckpt._to_plain(state)
    del plain["ema_params"], plain["endgame"]
    torch.save(plain, tmp_path / "ckpt" / "9.pt")
    old = mgr.restore(template)
    assert "forward-compat restore of step 9" in capsys.readouterr().out
    _assert_same(old.ema_params, template.ema_params)
    _assert_same(old.gen_params, state.gen_params)
    assert old.step == 7
    # fields the current state lacks, or a changed subtree, raise
    torch.save({**tckpt._to_plain(state), "future": 1},
               tmp_path / "ckpt" / "11.pt")
    with pytest.raises(ValueError, match="future"):
        mgr.restore(template)
    with pytest.raises(ValueError, match="ema_params"):
        mgr.restore(template._replace(ema_params=None), step=7)
    with pytest.raises(FileNotFoundError):
        tckpt.CheckpointManager(tmp_path / "empty").restore(template)


def _stub_step(diverged_frac=0.0, seen=None):
    def step(cfg, n_critic, state, real_stack, generator=None):
        if seen is not None:
            seen.append((n_critic, tuple(real_stack.shape)))
        z = torch.zeros(())
        m = twgan.StepMetrics(z, z, z, z, z, z, torch.tensor(diverged_frac),
                              z, z, d_loss_iters=torch.zeros(n_critic),
                              wasserstein_iters=torch.zeros(n_critic),
                              gp_iters=torch.zeros(n_critic),
                              acc_iters=torch.zeros(n_critic))
        return state._replace(step=state.step + 1), m
    return step


def _mk_driver(tmp_path, step_fn, state=None, **driver_kw):
    cfg = _wgan_cfg()
    state = state if state is not None else twgan.init_state(cfg)
    store = tstore.DataStore(tmp_path / "run")
    store.write_info({"entry": "test"})
    dcfg = tdriver.DriverConfig(**{"n_steps": 5, "checkpoint_every": 100,
                                   "tc_mean_every": 0, **driver_kw})
    sampler = lambda g, n, b: torch.zeros((n, b, cfg.gen.tc_dim))  # noqa
    return tdriver.GANDriver(cfg, dcfg, store, step_fn, state, sampler), store


def test_driver_warmup_records_and_aborts_on_divergence(tmp_path):
    seen = []
    driver, store = _mk_driver(tmp_path, _stub_step(seen=seen))
    assert driver.run().step == 5
    assert seen[0] == (3, (3, 2, 2)) and seen[1] == (2, (2, 2, 2))
    info = json.loads((store.path / "info.json").read_text())
    assert info["status"] == "finished"
    assert len((store.path / "learning.csv").read_text().splitlines()) == 6
    assert len((store.path / "disc_learning.csv").read_text()
               .splitlines()) == 1 + 3 + 4 * 2
    assert driver.checkpoints.latest_step() == 5
    export = np.load(store.path / "disc_params.npz")
    assert int(export["step"]) == 5 and {"J", "D", "S", "w0", "b1"} <= \
        set(export.files)

    driver, store = _mk_driver(tmp_path / "div", _stub_step(0.9),
                               divergence_abort=0.5, divergence_patience=3)
    with pytest.raises(tstore.PervasiveDivergenceError):
        driver.run()
    info = json.loads((store.path / "info.json").read_text())
    assert info["status"] == "known_error"


def test_driver_resume_truncates_replayed_rows(tmp_path):
    driver, store = _mk_driver(tmp_path, _stub_step(), n_steps=4,
                               checkpoint_every=2)
    driver.run()  # checkpoints at 2 and 4, rows for steps 0-3
    state2 = driver.checkpoints.restore(driver.state, step=2)
    assert state2.step == 2
    driver2, _ = _mk_driver(tmp_path, _stub_step(), state=state2, n_steps=3)
    seen = []
    driver2.train_step = _stub_step(seen=seen)
    driver2.run()
    steps = [int(line.split(",")[0]) for line in
             (store.path / "learning.csv").read_text().splitlines()[1:]]
    assert steps == [0, 1, 2, 3, 4]
    assert [n for n, _ in seen] == [2, 2, 2]  # no warm-up after resume
    gen_steps = [int(line.split(",")[0]) for line in
                 (store.path / "generator.csv").read_text().splitlines()[1:]]
    assert gen_steps == steps


def test_driver_one_host_copy_per_step(tmp_path, monkeypatch):
    calls = []
    real = tdriver.device_get
    monkeypatch.setattr(tdriver, "device_get",
                        lambda tree: calls.append(1) or real(tree))
    driver, _ = _mk_driver(tmp_path, _stub_step(), n_steps=3,
                           tc_mean_every=2)
    driver.run()
    # one per step, plus one for the final parameter export
    assert len(calls) == 3 + 1
    host = real({"a": torch.arange(3, dtype=torch.int32),
                 "b": (torch.tensor(True), None, torch.ones(2, 2))})
    assert host["a"].dtype == np.int32 and host["b"][0].dtype == bool
    assert host["b"][1] is None and host["b"][2].shape == (2, 2)


class _M:
    def __init__(self, fconv, miters):
        self.frac_converged = fconv
        self.mean_iters = miters


def test_adaptive_budget_matches_jax_driver(tmp_path):
    """The same metric sequence through both drivers gives the same
    max_iter sequence: buckets, floor, frozen EMA on unhealthy steps, the
    escape valve; and the sidecar restores it in a fresh driver."""
    seq = ([(1.0, 400.0)] * 5 + [(0.3, 2048.0)] + [(0.85, 2048.0)] * 50
           + [(0.95, 500.0)] + [(1.0, 50.0)] * 40)
    jcfg = jwgan.WGANConfig(gen=jgen.GeneratorConfig(
        ssn=jssn.SSNConfig(N=6, max_iter=8192), **GEN), batch_size=4)
    tcfg = twgan.WGANConfig(gen=_tcfg(max_iter=8192), batch_size=4)
    dcfg = dict(adaptive_max_iter=True, adaptive_margin=4.0)
    jd = jdriver.GANDriver(jcfg, jdriver.DriverConfig(**dcfg),
                           jstore.DataStore(tmp_path / "j"), None,
                           jwgan.init_state(jcfg), None)
    td = tdriver.GANDriver(tcfg, tdriver.DriverConfig(**dcfg),
                           tstore.DataStore(tmp_path / "t"), None,
                           twgan.init_state(tcfg), None)
    budgets = []
    for step, m in enumerate(seq):
        jd._adapt_solver_budget(step, _M(*m))
        td._adapt_solver_budget(step, _M(*m))
        budgets.append(td.model_cfg.gen.ssn.max_iter)
        assert budgets[-1] == jd.model_cfg.gen.ssn.max_iter, step
        assert td._iter_ema == pytest.approx(jd._iter_ema, rel=1e-15)
    assert {2048, 4096, 1024} <= set(budgets)
    td._save_adaptive_state()
    fresh = tdriver.GANDriver(tcfg, tdriver.DriverConfig(**dcfg), td.store,
                              None, twgan.init_state(tcfg), None)
    assert fresh.model_cfg.gen.ssn.max_iter == budgets[-1]


def test_graceful_stop_on_sigterm(tmp_path):
    """SIGTERM mid-run: the driver finishes the step, checkpoints it,
    finalizes as "interrupted" and restores the handler; a resume goes on
    from the completed step."""
    import os
    import signal

    driver, store = _mk_driver(tmp_path, _stub_step(), n_steps=50)
    old = signal.getsignal(signal.SIGTERM)

    def send_sigterm(step, state, metrics):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    assert driver.run(on_step=send_sigterm).step == 3
    info = json.loads((store.path / "info.json").read_text())
    assert info["status"] == "interrupted"
    assert driver.checkpoints.latest_step() == 3
    assert signal.getsignal(signal.SIGTERM) == old
    state = driver.checkpoints.restore(twgan.init_state(_wgan_cfg()))
    driver2, _ = _mk_driver(tmp_path, _stub_step(), state=state, n_steps=2)
    assert driver2.run().step == 5
    assert json.loads((store.path / "info.json").read_text())["status"] \
        == "finished"
