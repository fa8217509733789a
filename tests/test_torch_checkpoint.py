"""The port's checkpoints, train state and mid-epoch resume.

* ``CheckpointManager``: the round trip (every tensor equal, metadata,
  ``latest_step``), ``FileNotFoundError`` on an empty directory,
  ``max_to_keep``, a failed save that leaves the previous step
  restorable and no partial step behind.
* Bit-exact mid-epoch resume on the CPU: ``fit`` of vit_micro with
  dropout and STEGO's own random draws (so the generator matters) for 2
  epochs of 4 steps, validating every 2, against a fresh ``Trainer``
  that restores the step-2 checkpoint and resumes: every parameter,
  optimizer moment, ``pq_state`` buffer and the step ``torch.equal``,
  every metric logged after step 2 equal.
* The port's resume against the JAX package's: each restores its own
  step-2 checkpoint (Orbax on the JAX side) and continues; the logs
  compared as ``tests/test_torch_valid.py::test_fit_matches_jax`` does.
* ``load_train_state`` raises when asked to continue training from
  another device type's generator, and restores for evaluation.
* ``convert.train_state_from_jax``: 2 JAX train steps, the state
  converted, then step 3 on both sides: losses rtol 1e-5, parameters
  within the bars of ``tests/test_torch_trainer.py``; the same with sgd
  (momentum, weight decay, a cosine schedule) in all three optimizers,
  whose optax trace becomes ``torch.optim.SGD``'s momentum buffer: the
  round trip through the trainer bit-equal, the buffers after step 3
  within 1e-5 of their scale of JAX's trace.
"""
import copy
import itertools
import json

import jax
import pytest
import torch

import numpy as np

from equss_tpu.core.checkpoint import CheckpointManager as JCheckpointManager
from equss_tpu.models.registry import build_model as jbuild_model
from equss_tpu.parallel.mesh import make_mesh
from equss_tpu.train.trainer import Trainer as JTrainer
from equss_tpu_torch.convert import _dense, params_from_jax, train_state_from_jax
from equss_tpu_torch.core.checkpoint import METADATA_FILE, CheckpointManager
from equss_tpu_torch.data.synthetic import synthetic_batches
from equss_tpu_torch.models.equss import EQUSS, EQUSSConfig
from equss_tpu_torch.train.trainer import Trainer
from test_torch_trainer import LR_MODEL, _batches, micro_cfg
from test_torch_trainer import _pair as _train_pair
from test_torch_valid import _Recorder, _cfg, _pair, _val_batches


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """These tensors are small: one intra-op thread runs them faster on
    the CPU than several, which contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _flat(tree, prefix=""):
    """Every tensor of a nested state by its dotted path."""
    if torch.is_tensor(tree):
        return {prefix: tree}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}.{k}" if prefix else str(k)))
        return out
    return {}


def _assert_states_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k
    assert a["step"] == b["step"]
    for name in ("model", "cluster", "linear"):
        assert a["opt"][name]["count"] == b["opt"][name]["count"], name


def _metadata(ckpt, step):
    with open(f"{ckpt.directory}/{step}/{METADATA_FILE}") as f:
        return json.load(f)


def _trained(steps=1):
    tr = Trainer(micro_cfg(bf16=False), device="cpu")
    for batch in _batches(steps):
        tr.train_step(batch)
    return tr


def test_checkpoint_round_trip(tmp_path):
    tr = _trained()
    state = tr.train_state()
    assert state["step"] == 1 and state["opt"]["model"]["count"] == 1
    assert set(state["opt"]["model"]["state"]) == {n for n, _ in tr.model_params}
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    with pytest.raises(FileNotFoundError):
        ckpt.restore()
    assert ckpt.latest_step() is None
    ckpt.save(1, state, metadata={"best": {"Cluster_mIoU": 12.5, "iter": 1}}, wait=True)
    assert ckpt.latest_step() == 1
    assert _metadata(ckpt, 1) == {"best": {"Cluster_mIoU": 12.5, "iter": 1}}
    restored = ckpt.restore(template=state)
    _assert_states_equal(restored, state)
    assert restored["generator_device"] == "cpu"
    with pytest.raises(ValueError, match="template"):
        ckpt.restore(template={"model": {}})
    ckpt.close()


def test_checkpoint_max_to_keep(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3, 4):
        ckpt.save(step, {"x": torch.full((3,), float(step)), "step": step})
    assert ckpt.all_steps() == [3, 4]
    assert torch.equal(ckpt.restore(3)["x"], torch.full((3,), 3.0))
    assert ckpt.restore()["step"] == 4


def test_failed_save_leaves_the_previous_step(tmp_path, monkeypatch):
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, {"x": torch.ones(2), "step": 1})

    def broken_save(obj, path):
        with open(path, "wb") as f:
            f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken_save)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save(2, {"x": torch.zeros(2), "step": 2})
    monkeypatch.undo()
    assert ckpt.all_steps() == [1] and ckpt.latest_step() == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == ["1"]
    assert torch.equal(ckpt.restore()["x"], torch.ones(2))


def _resume_cfg():
    cfg = micro_cfg(bf16=False)
    cfg["model"]["pretrained"]["dropout"] = True
    cfg["train"].update(max_epochs=2, iter_per_epoch=4, print_interval_iters=1,
                        valid_interval_iters=2)
    return cfg


def _epoch_batches(epoch):
    """4 batches of b = 2 at 64^2 without STEGO's override keys: its
    samples come from the trainer's generator."""
    return synthetic_batches(20 + epoch, 4, batch_size=2, res=64, num_classes=4)


@pytest.mark.parametrize("steps_before_fit", [0, 1])
def test_mid_epoch_resume_is_bit_exact(tmp_path, steps_before_fit):
    """With ``steps_before_fit`` train steps taken before a fresh ``fit``,
    its checkpoints still count steps from the fit's start, and the
    optimizers carry the earlier step."""
    cfg = _resume_cfg()
    val = _val_batches(1)
    full = Trainer(cfg, device="cpu")
    for batch in itertools.islice(_epoch_batches(99), steps_before_fit):
        full.train_step(batch)
    rec_full = _Recorder()
    ckpt = CheckpointManager(str(tmp_path / "full"), max_to_keep=10)
    full.fit(_epoch_batches, lambda: val, logger=rec_full, checkpointer=ckpt)
    assert 2 in ckpt.all_steps()
    assert _metadata(ckpt, 2)["best"]["iter"] == 2
    saved = ckpt.restore(2)
    assert saved["step"] == 2
    assert saved["opt"]["model"]["count"] == 2 + steps_before_fit

    resumed = Trainer(cfg, device="cpu", seed=123)
    rec_res = _Recorder()
    resumed.fit(_epoch_batches, lambda: val, logger=rec_res, state=saved)
    assert resumed.step == full.step == 8
    after = [(s, {k: v for k, v in m.items() if k != "iter_time"})
             for s, m in rec_full.records if s > 2]
    got = [(s, {k: v for k, v in m.items() if k != "iter_time"}) for s, m in rec_res.records]
    assert [s for s, _ in got] == [3, 4, 4, 4, 5, 6, 6, 7, 8, 8, 8]
    assert got == after
    _assert_states_equal(resumed.train_state(), full.train_state())


def test_resume_matches_jax_resume(tmp_path):
    cfg = _cfg()
    cfg["train"].update(iter_per_epoch=4)
    jtr, ts, tr = _pair(cfg)
    train, val = _batches(4), _val_batches(2)
    jckpt = JCheckpointManager(str(tmp_path / "jax"))
    ckpt = CheckpointManager(str(tmp_path / "port"))
    jtr.fit(lambda e: train, lambda: val, logger=_Recorder(), checkpointer=jckpt,
            img_hw=(64, 64))
    tr.fit(lambda e: train, lambda: val, logger=_Recorder(), checkpointer=ckpt)
    jckpt.close()

    jstate = JCheckpointManager(str(tmp_path / "jax")).restore(2, template=jax.device_get(ts))
    rec_j, rec_t = _Recorder(), _Recorder()
    jtr.fit(lambda e: train, lambda: val, logger=rec_j, img_hw=(64, 64), state=jstate)
    fresh = Trainer(cfg, device="cpu")
    fresh.fit(lambda e: train, lambda: val, logger=rec_t, state=ckpt.restore(2))
    assert [s for s, _ in rec_t.records] == [s for s, _ in rec_j.records] == [3, 4, 4, 4]
    for (_, m_t), (_, m_j) in zip(rec_t.records, rec_j.records):
        assert set(m_j) <= set(m_t)
        for k, v in m_j.items():
            if k == "iter_time":
                continue
            if k.endswith(("mIoU", "Accuracy")):
                assert m_t[k] == pytest.approx(v, abs=0.1), k
            else:
                assert m_t[k] == pytest.approx(v, rel=1e-5, abs=1e-7), k


def test_cross_device_generator_restore_raises():
    tr = _trained()
    state = dict(tr.train_state(), generator_device="cuda",
                 generator=torch.zeros(16, dtype=torch.uint8))
    other = Trainer(micro_cfg(bf16=False), device="cpu", seed=5)
    with pytest.raises(ValueError, match="on cpu .* cuda generator"):
        other.load_train_state(state)
    assert other.step == 0
    other.load_train_state(state, resume_training=False)
    assert other.step == 1
    for k, v in tr.model.state_dict().items():
        assert torch.equal(other.model.state_dict()[k], v), k


def test_train_state_from_jax_continues_the_jax_run():
    cfg, jtr, ts, tr = _train_pair(bf16=False)
    batches = _batches(3, seed=4)
    for batch in batches[:2]:
        ts, _ = jtr.train_step(ts, batch)
    state = train_state_from_jax(jax.device_get(ts), cfg)
    assert state["step"] == 2 and state["opt"]["model"]["count"] == 2
    tr.load_train_state(copy.deepcopy(state))
    assert tr.step == 2
    ts, m_j = jtr.train_step(ts, batches[2])
    m_t = tr.train_step(batches[2])
    for key in ("loss", "model-loss", "linear-loss", "cluster-loss", "stego-loss", "vq-loss",
                "grad-norm"):
        assert m_t[key] == pytest.approx(float(m_j[key]), rel=1e-5, abs=1e-7), key
    host = jax.device_get(ts)
    sd = params_from_jax(host["params"], host["model_state"], tr.model.cfg,
                         probe_params=host["probe_params"])
    mine = tr.state_dict()
    for k, v in sd.items():
        if k.startswith("backbone."):
            continue
        diff = (mine[k] - v).abs()
        lr = 3.0e-3 if k.startswith("probes.") else LR_MODEL
        assert diff.max() <= 2 * lr + 1e-6, k
        assert (diff > 1e-6).float().mean() <= 0.01, k
    assert tr.step == 3 and tr.tx_model.count == 3


def test_sgd_train_state_from_jax_round_trip_and_step():
    cfg = micro_cfg(bf16=False)
    sgd = {"name": "sgd", "lr": 1e-2, "momentum": 0.9, "weight_decay": 0.05}
    cfg["optimizer"] = {k: dict(sgd) for k in ("model", "cluster", "linear")}
    cfg["scheduler"]["model"] = {"name": "cos"}
    jtr = JTrainer(cfg, mesh=make_mesh(2), model=jbuild_model(cfg))
    ts = jtr.init_state(jax.random.PRNGKey(0), img_hw=(64, 64))
    mcfg = EQUSSConfig.from_config(cfg)
    tr = Trainer(cfg, device="cpu", model=EQUSS(mcfg, device="cpu"))
    batches = _batches(3, seed=4)
    for batch in batches[:2]:
        ts, _ = jtr.train_step(ts, batch)
    state = train_state_from_jax(jax.device_get(ts), cfg)
    assert state["step"] == 2
    for name in ("model", "cluster", "linear"):
        opt = state["opt"][name]
        assert opt["count"] == 2 and opt["state"]
        assert all(set(v) == {"momentum_buffer"} for v in opt["state"].values()), name
    linear = jax.device_get(ts)["opt"]["linear"]
    trace = next(n for n in jax.tree.leaves(linear, is_leaf=lambda x: hasattr(x, "trace"))
                 if hasattr(n, "trace")).trace
    want = _dense(trace["linear"], "linear")
    for k, v in want.items():
        assert torch.equal(state["opt"]["linear"]["state"][k]["momentum_buffer"], v), k
    tr.load_train_state(copy.deepcopy(state))
    back = tr.train_state()["opt"]
    for name in ("model", "cluster", "linear"):
        assert back[name]["count"] == 2
        for k, v in state["opt"][name]["state"].items():
            assert torch.equal(back[name]["state"][k]["momentum_buffer"],
                               v["momentum_buffer"]), (name, k)
    ts, m_j = jtr.train_step(ts, batches[2])
    m_t = tr.train_step(batches[2])
    for key in ("loss", "model-loss", "linear-loss", "cluster-loss", "grad-norm"):
        assert m_t[key] == pytest.approx(float(m_j[key]), rel=1e-5, abs=1e-7), key
    after = train_state_from_jax(jax.device_get(ts), cfg)["opt"]
    mine = tr.train_state()["opt"]
    for name in ("model", "cluster", "linear"):
        for k, v in after[name]["state"].items():
            got = mine[name]["state"][k]["momentum_buffer"].numpy()
            ref = v["momentum_buffer"].numpy()
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=1e-5 * max(np.abs(ref).max(), 1.0), err_msg=k)
    assert tr.tx_model.count == 3
