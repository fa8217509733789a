"""The port's data parallelism (``equss_tpu_torch/parallel/mesh.py``) on
the CPU: two ranks over gloo, each a subprocess running this file, held
against the port's one-process run and the JAX package's one-process
run on the global batch.

vit_micro at 64^2, a global batch of 4 (2 rows a rank).  The ranks
write what they computed to a file; the tests read it.

* The helpers on one process (identities) and in the group:
  ``broadcast_object`` of a 200 kB payload ending in zero bytes,
  ``replicate`` of weights that differ by rank, ``barrier``.
* pqgo, 3 steps with dropout and STEGO's own draws: both ranks hold the
  same train state bit for bit (weights, optimizer moments, quantizer
  state, generator) after every step; losses and metrics within rtol
  1e-5 of the one-process run, the weights after 3 steps within 1e-5 of
  their scale.
* pqgo from JAX's initial state, dropout off, STEGO's samples fed: the
  first step's summed gradients within 1e-4 of their scale of JAX's, the
  losses of 3 steps rtol 1e-5, the weights after them within the bars of
  ``tests/test_torch_trainer.py``; ``validate`` before training equal to
  JAX's (mIoU and Accuracy within 1e-6, losses rtol 1e-5) and
  ``validate_crf`` (at 32^2, two mean-field steps) equal to the
  one-process run's.
* vq (EMA): the counts equal to the one-process run's, the EMA state
  within rtol 1e-5, the JSD and entropy telemetry within 1e-5; stego,
  probe and sl: 2 steps and ``validate`` against the one-process run.
* vq (EMA) with ``use_restart`` and ``pq_dropout``: the ranks bit-equal
  after every step (the restart draws its rows from the gathered global
  batch, the dropout mask is the same on every rank), the counts equal to
  the one-process run's, the codebook and the rest of the EMA state
  within rtol 1e-5 of it.
* A non-finite step on one rank is skipped on both.
* The Sinkhorn targets, ``cluster_loss`` and ``BatchNorm`` (output,
  running averages, gradients) across the ranks against JAX's on the
  global batch, within 1e-5.
* ``cli.main`` with ``dist.coordinator / num_processes / process_id``:
  one run directory and one metrics file, each checkpoint written once,
  and a resume from the step-2 checkpoint bit-exact on both ranks.
* ``build_sharded_predict_fn`` over two CPU devices equal to
  ``build_predict_fn``; the PQ size gate of a rank equal to JAX's at the
  global n with the shards divisor; every registered family builds and
  takes a step on two ranks, and what used to raise works there: a 1 x 2
  (data, model) grid, ``shard_backbone`` on it, the Sinkhorn over its
  model axis (against one process on both ranks' rows) and the list of
  an export for two devices (``tests/test_torch_tensor_parallel.py`` holds
  tensor parallelism itself).
"""
import copy
import glob
import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from equss_tpu_torch import cli, serve
from equss_tpu_torch.data.synthetic import synthetic_batches
from equss_tpu_torch.losses import sinkhorn as tsink
from equss_tpu_torch.models.heads import BatchNorm
from equss_tpu_torch.models import registry
from equss_tpu_torch.parallel import mesh
from equss_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, N = 2, 4                 # ranks, global batch
ROWS = N // WORLD
NUM_CLASSES = 4
# the variants' registered names and the config of each
FAMILY_CONFIGS = {"pqgocls": "pqgo_cls_cocostuff27", "cluster": "cluster_margin_cocostuff27",
                  "res": "res_cocostuff27", "hihi": "unseg_cocostuff27",
                  "new": "new_vq_cocostuff27", "spq": "spq_cocostuff27",
                  "vae": "vae_cocostuff27", "info": "info_cocostuff27",
                  "contra": "contra_cocostuff27", "ema": "ema_cocostuff27"}
CLI_ARGS = ["--config", "configs/smoke_synthetic.yaml", "--debug", "device=cpu",
            "dataset.synthetic_batches=4", "train.print_interval_iters=1",
            "train.valid_interval_iters=2", "eval.final_crf=true",
            "eval.crf={max_iter: 2, block: 256}"]


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


def _rows(batch, rank):
    """A rank's rows of a global batch; STEGO's fed permutations index the
    global batch and go to every rank whole."""
    return {k: v if k == "stego_perms" else v[rank * ROWS:(rank + 1) * ROWS]
            for k, v in batch.items()}


def _snapshot(tr):
    return copy.deepcopy(_flat(tr.train_state()))


def _steps(tr, batches):
    """Train steps; their metrics and the train state after each."""
    metrics, states = [], []
    for b in batches:
        metrics.append(tr.train_step(b))
        states.append(_snapshot(tr))
    return {"metrics": metrics, "states": states}


# --------------------------------------------------------- the ranks

def _rank_cli(rank, port, save_dir):
    """The train job through ``cli.main``, whose ``dist.*`` flags bring the
    group up; then the same job resumed from its step-2 checkpoint."""
    dist = [f"save_dir={save_dir}", f"dist.coordinator=localhost:{port}",
            f"dist.num_processes={WORLD}", f"dist.process_id={rank}"]
    first = cli.main([*CLI_ARGS, *dist])
    assert mesh.world() == WORLD and mesh.rank() == rank
    (run_dir,) = glob.glob(os.path.join(save_dir, "*"))
    from_step2 = os.path.join(os.path.dirname(save_dir), "from_step2")
    if rank == 0:
        shutil.copytree(os.path.join(run_dir, "ckpt", "2"), os.path.join(from_step2, "2"))
    mesh.barrier()
    resumed = cli.main([*CLI_ARGS, *dist, f"resume.checkpoint={from_step2}",
                        "resume.mode=train"])
    return {"first": first["state"], "resumed": resumed["state"], "best": first["best"]}


def _rank_helpers(rank):
    payload = {"blob": b"x" * 200_000 + b"\x00\x00", "n": 42} if rank == 0 else None
    got = mesh.broadcast_object(payload, is_source=rank == 0)
    module = torch.nn.Linear(3, 2)
    with torch.no_grad():
        module.weight.fill_(float(rank + 1))
    mesh.replicate(module)
    mesh.barrier()
    return {"object": got, "weight": module.weight.detach().clone()}


def _rank_modules(rank, job):
    """Sinkhorn, cluster_loss and BatchNorm on this rank's rows inside a
    global program."""
    m = job["modules"]
    lo, hi = rank * len(m["scores"]) // WORLD, (rank + 1) * len(m["scores"]) // WORLD
    out = {}
    with mesh.global_program():
        scores = torch.from_numpy(m["scores"][lo:hi])
        out["q"] = tsink.distributed_sinkhorn(scores, epsilon=0.05)
        valid = torch.from_numpy(m["valid"][lo:hi])
        out["q_valid"] = tsink.distributed_sinkhorn(scores, epsilon=0.05, valid=valid)
        out["cluster_loss"] = tsink.cluster_loss(scores, temperature=0.1, epsilon=0.05,
                                                 axis_name="data")
        lo, hi = rank * len(m["x"]) // WORLD, (rank + 1) * len(m["x"]) // WORLD
        bn = BatchNorm(m["x"].shape[-1])
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(m["scale"]))
            bn.bias.copy_(torch.from_numpy(m["bias"]))
        x = torch.from_numpy(m["x"][lo:hi]).requires_grad_()
        updates = {}
        y = bn(x, True, updates)
        (y * torch.from_numpy(m["w"][lo:hi])).sum().backward()
    out.update(y=y.detach(), running=[t.clone() for t in updates[bn]], dx=x.grad,
               dscale=bn.weight.grad, dbias=bn.bias.grad)
    return out


def _rank_guards(job):
    """Every registered family's step on this rank's rows (whether it
    was skipped); then what used to raise on several processes: a 1 x 2
    grid (this rank's place), ``shard_backbone`` on it (the shapes), the
    Sinkhorn over its model axis on this rank's rows, and the devices of
    a two-device export."""
    batch = _rows({k: v[:, :32, :32] if k != "stego_perms" else v
                   for k, v in job["train"][0].items()}, mesh.rank())
    steps = {name: Trainer(cfg, device="cpu").train_step(batch)["skipped"]
             for name, cfg in job["families"].items()}
    grid = mesh.make_mesh_2d(1, 2)
    sd = {"blocks.0.mlp.fc1.weight": torch.zeros(8, 4), "blocks.0.mlp.fc1.bias": torch.zeros(8),
          "blocks.0.mlp.fc2.weight": torch.zeros(4, 8), "blocks.0.attn.qkv.weight": torch.zeros(12, 4)}
    scores = torch.from_numpy(job["modules"]["scores"])
    half = len(scores) // WORLD
    works = {"mesh_2d": (grid.data, grid.model, grid.data_index, grid.model_index),
             "shard_backbone": {k: tuple(v.shape) for k, v in mesh.shard_backbone(grid, sd).items()},
             "sinkhorn_model_axis": tsink.distributed_sinkhorn(
                 scores[mesh.rank() * half:(mesh.rank() + 1) * half], epsilon=0.05,
                 axis_name="model"),
             "export": serve.export_devices(["cuda", "cpu"])}
    return {"steps": steps, "works": works}


def _rank(rank, port, job_path, out_path):
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    out = {"cli": _rank_cli(rank, port, job["save_dir"]), "helpers": _rank_helpers(rank)}
    rows = lambda batches: [_rows(b, rank) for b in batches]  # noqa: E731

    tr = Trainer(job["cfgs"]["pqgo"], device="cpu")
    out["pqgo"] = _steps(tr, rows(job["train"]))

    tr = Trainer(job["cfgs"]["fed"], device="cpu")
    tr.load_state_dict(job["jax_init"])
    fed = {"validate": tr.validate(rows(job["val"])),
           "validate_crf": tr.validate_crf(rows(job["val_crf"]))}
    tr.forward_backward(rows(job["fed"])[0])
    fed["grads"] = {n: p.grad.clone() for n, p in
                    [*tr.model_params, *((f"probes.{n}", p) for n, p in tr.probe_params)]}
    fed.update(_steps(tr, rows(job["fed"])))
    out["fed"] = fed

    for name in ("vq", "stego", "probe", "sl"):
        tr = Trainer(job["cfgs"][name], device="cpu")
        out[name] = {"validate": tr.validate(rows(job["val"])),
                     **_steps(tr, rows(job["train"][:2]))}
    out["vq_options"] = _steps(Trainer(job["cfgs"]["vq_options"], device="cpu"),
                               rows(job["train"][:2]))

    tr = Trainer(job["cfgs"]["pqgo"], device="cpu")
    before = _snapshot(tr)
    bad = _rows(job["train"][0], rank)
    if rank == 1:
        bad["img"] = np.full_like(bad["img"], np.nan)
    skipped = tr.train_step(bad)["skipped"]
    after = _flat(tr.train_state())
    out["nonfinite"] = {"skipped": skipped,     # the generator has drawn the step's dropout
                        "unchanged": all(torch.equal(after[k], v) for k, v in before.items()
                                         if k.startswith(("model.", "probes.", "opt."))),
                        "before": before, "after": after}
    out["modules"] = _rank_modules(rank, job)
    out["guards"] = _rank_guards(job)
    torch.save(out, out_path)


if __name__ == "__main__":
    _rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    sys.exit(0)


# ------------------------------------------------------- the fixtures

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _global_batches(n, seed, fed=False):
    rng = np.random.RandomState(100 + seed)
    out = []
    for batch in synthetic_batches(seed, n, batch_size=N, res=64, num_classes=NUM_CLASSES):
        if fed:
            batch["stego_coords1"] = rng.uniform(-1, 1, (N, 5, 5, 2)).astype(np.float32)
            batch["stego_coords2"] = rng.uniform(-1, 1, (N, 5, 5, 2)).astype(np.float32)
            batch["stego_perms"] = np.stack([rng.permutation(N) for _ in range(2)]
                                            ).astype(np.int32)
        out.append(batch)
    return out


def _val_batches(n, seed=5, res=64):
    """Labels with 10% -1 and 5% num_classes, which the mask drops."""
    rng = np.random.RandomState(seed)
    out = []
    for batch in synthetic_batches(seed, n, batch_size=N, res=res, num_classes=NUM_CLASSES,
                                   with_pos=False):
        label = batch["label"]
        label[rng.rand(*label.shape) < 0.1] = -1
        label[rng.rand(*label.shape) < 0.05] = NUM_CLASSES
        out.append(batch)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Launch the two ranks, compute the one-process references (the port
    and JAX) while they run, and return both."""
    import jax

    from test_torch_baselines import micro
    from test_torch_trainer import _flat_jax_grads, _jax_grads, _pair, micro_cfg

    from test_torch_variants import micro as variant_micro

    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("parallel")
    cfg_fed, jtr, ts, tr_fed = _pair(bf16=False)
    cfg_fed["eval"]["crf"] = {"max_iter": 2, "block": 256}
    pqgo = micro_cfg(bf16=False)
    pqgo["model"]["pretrained"]["dropout"] = True
    vq_options = micro("vq")
    vq_options["model"]["vq"].update(use_restart=True, pq_dropout=0.2)
    rs = np.random.RandomState(0)
    job = {"save_dir": str(tmp / "runs"),
           "cfgs": {"pqgo": pqgo, "fed": cfg_fed, "vq_options": vq_options,
                    **{n: micro(n) for n in ("vq", "stego", "probe", "sl")}},
           "jax_init": tr_fed.state_dict(),
           # every registered family at vit_micro, by its config
           "families": {**{n: micro(n) for n in ("vq", "stego", "probe", "sl")}, "pqgo": pqgo,
                        **{n: variant_micro(c) for n, c in FAMILY_CONFIGS.items()}},
           "train": _global_batches(3, seed=0), "fed": _global_batches(3, seed=1, fed=True),
           "val": _val_batches(2), "val_crf": _val_batches(1, res=32),
           "modules": {"scores": rs.uniform(-1, 1, (24, 12)).astype(np.float32),
                       "valid": rs.rand(24) < 0.7,
                       "x": rs.randn(6, 5, 5, 8).astype(np.float32),
                       "w": rs.randn(6, 5, 5, 8).astype(np.float32),
                       "scale": rs.uniform(0.5, 1.5, 8).astype(np.float32),
                       "bias": rs.randn(8).astype(np.float32)}}
    torch.save(job, tmp / "job.pt")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(port),
                               str(tmp / "job.pt"), str(tmp / f"rank{r}.pt")],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:
        ref = {}
        tr = Trainer(pqgo, device="cpu")
        ref["pqgo"] = _steps(tr, job["train"])
        tr = Trainer(cfg_fed, device="cpu")
        tr.load_state_dict(job["jax_init"])
        ref["validate_crf"] = tr.validate_crf(job["val_crf"])
        for name in ("vq", "stego", "probe", "sl"):
            tr = Trainer(job["cfgs"][name], device="cpu")
            ref[name] = {"validate": tr.validate(job["val"]), **_steps(tr, job["train"][:2])}
        ref["vq_options"] = _steps(Trainer(vq_options, device="cpu"), job["train"][:2])
        jax_ref = {"validate": jtr.validate(ts, job["val"]),
                   "grads": _flat_jax_grads(_jax_grads(jtr, ts, job["fed"][0])[0])}
        metrics = []
        for batch in job["fed"]:
            ts, m = jtr.train_step(ts, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        jax_ref.update(metrics=metrics, state=jax.device_get(ts))
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{text[-4000:]}"
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"ranks": ranks, "ref": ref, "jax": jax_ref, "job": job, "tr_fed": tr_fed}


# ------------------------------------------------------------ tests

def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _metrics_close(got, want, rtol=1e-5):
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=rtol, abs=1e-7), k


def test_helpers_on_one_process_are_identities():
    import equss_tpu_torch.parallel.mesh as m

    batch = {"img": np.ones((2, 3), np.float32), "label": torch.zeros(2, dtype=torch.int64),
             "img_path": ["a.jpg", "b.jpg"], "name": np.array(["x", "y"])}
    placed = mesh.shard_batch(batch, "cpu")
    assert set(placed) == {"img", "label"} and placed["img"].dtype == torch.float32
    assert [b["img"].shape for b in m.device_prefetch([batch, batch], "cpu")] == [(2, 3)] * 2
    module = torch.nn.Linear(2, 2)
    assert mesh.replicate(module) is module
    assert mesh.broadcast_object({"n": 1}) == {"n": 1}
    mesh.barrier()
    assert mesh.world() == 1 and mesh.rank() == 0
    assert mesh.make_mesh(2, "cpu") == [torch.device("cpu")] * 2
    t = torch.arange(4.0)
    with mesh.global_program():
        assert mesh.program_world() == 1
        assert mesh.all_reduce_sum(t) is t and mesh.gather_rows(t) is t
        assert mesh.mean_over_ranks(t) is t
        assert torch.equal(mesh.global_rows(lambda n: torch.arange(n), 3), torch.arange(3))
    # one process is a 1 x 1 grid, on which the layouts change nothing
    with pytest.raises(ValueError, match="requested a 1x2 mesh but only 1"):
        mesh.make_mesh_2d(1, 2)
    grid = mesh.make_mesh_2d(1, 1)
    assert grid.shape == {"data": 1, "model": 1} and mesh.model_size() == 1
    params, state = {"pq": {"codebook": torch.ones(2, 4, 3)}}, {"pq": {"vq_count": torch.ones(2, 4)}}
    p, s = mesh.shard_quantizer(grid, params, state)
    assert p["pq"]["codebook"] is params["pq"]["codebook"] and s["pq"]["vq_count"].shape == (2, 4)
    sd = {"blocks.0.mlp.fc1.weight": torch.ones(8, 4)}
    assert mesh.shard_backbone(grid, sd)["blocks.0.mlp.fc1.weight"] is sd["blocks.0.mlp.fc1.weight"]
    with mesh.global_program():
        assert mesh.program_world() == 1


def test_group_broadcast_replicate_and_barrier(runs):
    for r, out in enumerate(runs["ranks"]):
        got = out["helpers"]["object"]
        assert got["n"] == 42 and got["blob"] == b"x" * 200_000 + b"\x00\x00", r
        assert torch.equal(out["helpers"]["weight"], torch.ones(2, 3)), r


@pytest.mark.parametrize("name", ["pqgo", "fed", "vq", "stego", "probe", "sl", "vq_options"])
def test_ranks_hold_the_same_state_after_every_step(runs, name):
    a, b = (out[name]["states"] for out in runs["ranks"])
    assert len(a) == len(b) >= 2
    for step, (sa, sb) in enumerate(zip(a, b)):
        assert set(sa) == set(sb)
        for k in sa:                        # weights, moments, quantizer state, generator
            assert torch.equal(sa[k], sb[k]), (step, k)


def test_pqgo_two_ranks_match_one_process_with_dropout(runs):
    ref = runs["ref"]["pqgo"]
    got = runs["ranks"][0]["pqgo"]
    for m_got, m_ref in zip(got["metrics"], ref["metrics"]):
        assert m_got["skipped"] == m_ref["skipped"] == 0.0
        _metrics_close(m_got, m_ref)
    final, want = got["states"][-1], ref["states"][-1]
    assert set(final) == set(want)
    for k, v in want.items():
        if v.is_floating_point():
            _close(final[k].numpy(), v.numpy(), 1e-5)
        else:
            assert torch.equal(final[k], v), k


def test_pqgo_two_ranks_match_jax_one_process(runs):
    from equss_tpu_torch.convert import params_from_jax
    from test_torch_trainer import LR_MODEL

    got, jax_ref = runs["ranks"][0]["fed"], runs["jax"]
    want = jax_ref["grads"]
    assert set(got["grads"]) == set(want)
    for k, v in got["grads"].items():
        w = want[k].numpy()
        np.testing.assert_allclose(v.numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=k)
    for m_got, m_j in zip(got["metrics"], jax_ref["metrics"]):
        for k in ("loss", "model-loss", "linear-loss", "cluster-loss", "stego-loss",
                  "vq-loss", "codebook-usage", "grad-norm"):
            assert m_got[k] == pytest.approx(m_j[k], rel=1e-5, abs=1e-7), k
    host = jax_ref["state"]
    tr = runs["tr_fed"]
    sd = params_from_jax(host["params"], host["model_state"], tr.model.cfg,
                         probe_params=host["probe_params"])
    final = got["states"][-1]
    for k, v in sd.items():
        if k.startswith("backbone."):
            continue
        mine = final[f"probes.{k[len('probes.'):]}" if k.startswith("probes.")
                     else f"model.{k}"]
        diff = (mine - v).abs()
        lr = 3.0e-3 if k.startswith("probes.") else LR_MODEL
        assert diff.max() <= 2 * lr + 1e-6, k
        assert (diff > 1e-6).float().mean() <= 0.01, k
    np.testing.assert_array_equal(final["model.pq_state.vq_count"].numpy(),
                                  sd["pq_state.vq_count"].numpy())


def test_validate_two_ranks_match_jax_and_the_crf_one_process(runs):
    for out in runs["ranks"]:
        got = out["fed"]["validate"]
        want = runs["jax"]["validate"]
        assert set(got) == set(want)
        for k, v in want.items():
            if k.endswith(("mIoU", "Accuracy")):
                assert got[k] == pytest.approx(float(v), abs=1e-6), k
            else:
                assert got[k] == pytest.approx(float(v), rel=1e-5, abs=1e-7), k
        crf, want = out["fed"]["validate_crf"], runs["ref"]["validate_crf"]
        assert set(crf) == set(want)
        for k, v in want.items():
            assert crf[k] == pytest.approx(v, abs=1e-6), k


def test_vq_two_ranks_ema_state_equals_one_process(runs):
    got, ref = runs["ranks"][0]["vq"], runs["ref"]["vq"]
    for m_got, m_ref in zip(got["metrics"], ref["metrics"]):
        for k in ("jsd", "entropy", "codebook-usage", "vq-loss", "stego-loss", "loss"):
            assert m_got[k] == pytest.approx(m_ref[k], rel=1e-5, abs=1e-7), k
    for step, (s_got, s_ref) in enumerate(zip(got["states"], ref["states"])):
        for name in ("vq_count", "ema_count"):
            k = f"model.pq_state.{name}"
            if name == "vq_count":              # integer sums in f32
                assert torch.equal(s_got[k], s_ref[k]), (step, k)
            else:
                _close(s_got[k].numpy(), s_ref[k].numpy(), 1e-5)
        for name in ("ema_weight", "ema_weight_avg"):
            k = f"model.pq_state.{name}"
            _close(s_got[k].numpy(), s_ref[k].numpy(), 1e-5)


def test_vq_restart_and_dropout_two_ranks_equal_one_process(runs):
    got, ref = runs["ranks"][0]["vq_options"], runs["ref"]["vq_options"]
    for m_got, m_ref in zip(got["metrics"], ref["metrics"]):
        assert m_got["skipped"] == m_ref["skipped"] == 0.0
        for k in ("codebook-usage", "vq-loss", "loss"):
            assert m_got[k] == pytest.approx(m_ref[k], rel=1e-5, abs=1e-7), k
    before = runs["job"]["cfgs"]["vq_options"]
    assert before["model"]["vq"]["use_restart"]
    for step, (s_got, s_ref) in enumerate(zip(got["states"], ref["states"])):
        for name in ("vq_count", "ema_count"):
            k = f"model.pq_state.{name}"
            assert torch.equal(s_got[k], s_ref[k]), (step, k)
        # a restart reset the counts: 256 pixels over 128 codewords
        assert float(s_ref["model.pq_state.ema_count"].abs().sum()) == 0.0
        for name in ("ema_weight", "ema_weight_avg"):
            k = f"model.pq_state.{name}"
            _close(s_got[k].numpy(), s_ref[k].numpy(), 1e-5)
        assert torch.equal(s_got["generator"], s_ref["generator"])


@pytest.mark.parametrize("name", ["stego", "probe", "sl"])
def test_baselines_two_ranks_match_one_process(runs, name):
    got, ref = runs["ranks"][0][name], runs["ref"][name]
    for k, v in ref["validate"].items():
        if k.endswith(("mIoU", "Accuracy")):
            assert got["validate"][k] == pytest.approx(v, abs=1e-6), k
        else:
            assert got["validate"][k] == pytest.approx(v, rel=1e-5, abs=1e-7), k
    for m_got, m_ref in zip(got["metrics"], ref["metrics"]):
        assert m_got["skipped"] == 0.0
        _metrics_close(m_got, m_ref)
    for k, v in ref["states"][-1].items():
        if v.is_floating_point():
            _close(got["states"][-1][k].numpy(), v.numpy(), 1e-5)


def test_nonfinite_step_on_one_rank_is_skipped_on_every_rank(runs):
    for out in runs["ranks"]:
        assert out["nonfinite"]["skipped"] == 1.0
        assert out["nonfinite"]["unchanged"]


def test_sinkhorn_and_batchnorm_across_ranks_match_jax(runs):
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    from equss_tpu.losses import sinkhorn as jsink

    m = runs["job"]["modules"]
    got = runs["ranks"]
    cat = lambda k: torch.cat([g["modules"][k] for g in got]).detach().numpy()  # noqa: E731
    _close(cat("q"), jsink.distributed_sinkhorn(jnp.asarray(m["scores"]), epsilon=0.05), 1e-5)
    _close(cat("q_valid"), jsink.distributed_sinkhorn(
        jnp.asarray(m["scores"]), epsilon=0.05, valid=jnp.asarray(m["valid"])), 1e-5)
    want = jsink.cluster_loss(jnp.asarray(m["scores"]), temperature=0.1, epsilon=0.05)
    mean = sum(float(g["modules"]["cluster_loss"]) for g in got) / WORLD
    assert mean == pytest.approx(float(want), rel=1e-5)

    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": jnp.asarray(m["scale"]), "bias": jnp.asarray(m["bias"])},
                 "batch_stats": {"mean": jnp.zeros(8), "var": jnp.ones(8)}}

    def loss(params, x):
        y, upd = bn.apply({**variables, "params": params}, x, mutable=["batch_stats"])
        return (y * m["w"]).sum(), (y, upd["batch_stats"])

    (_, (y, stats)), (g_params, g_x) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(m["x"]))
    _close(cat("y"), y, 1e-5)
    _close(cat("dx"), g_x, 1e-5)
    for r in got:                           # the running averages: the global batch's
        _close(r["modules"]["running"][0].numpy(), stats["mean"], 1e-5)
        _close(r["modules"]["running"][1].numpy(), stats["var"], 1e-5)
    _close(sum(g["modules"]["dscale"] for g in got).numpy(), g_params["scale"], 1e-5)
    _close(sum(g["modules"]["dbias"] for g in got).numpy(), g_params["bias"], 1e-5)


def test_cli_two_processes_share_one_run_and_resume_bit_exact(runs):
    save_dir = runs["job"]["save_dir"]
    run_dirs = sorted(glob.glob(os.path.join(save_dir, "*")))
    assert len(run_dirs) == 2                   # the first run and the resume, one each
    first, resumed_dir = run_dirs

    def records(d):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            return [{k: v for k, v in json.loads(line).items() if k != "iter_time"}
                    for line in f]

    rec = records(first)
    assert [r["step"] for r in rec if "loss" in r] == [1, 2, 3, 4]    # written once
    steps = os.listdir(os.path.join(first, "ckpt"))
    assert all(s.isdigit() for s in steps) and min(int(s) for s in steps) == 2
    later = [r for r in rec if r["step"] > 2 and not any(k.startswith("final") for k in r)]
    assert [r for r in records(resumed_dir)
            if not any(k.startswith("final") for k in r)] == later
    a, b = (out["cli"] for out in runs["ranks"])
    assert a["best"] == b["best"]
    for k, v in a["first"].items():
        assert torch.equal(v, b["first"][k]), k
        assert torch.equal(v, a["resumed"][k]), k
        assert torch.equal(v, b["resumed"][k]), k


def test_families_and_options_that_couple_rows_raise_on_two_ranks(runs):
    """No family raises on two ranks any more: each registered one builds
    and takes a finite step; and nothing of tensor parallelism raises
    either: the 1 x 2 grid places the ranks at (0, r), ``shard_backbone``
    halves fc1's rows and fc2's columns and keeps qkv, the Sinkhorn over
    the model axis on each rank's half of the scores equals one process's
    on all of them (within 1e-5), and an export lists two devices."""
    scores = torch.from_numpy(runs["job"]["modules"]["scores"])
    want = tsink.distributed_sinkhorn(scores, epsilon=0.05)
    half = len(scores) // WORLD
    for r, out in enumerate(runs["ranks"]):
        steps, works = out["guards"]["steps"], out["guards"]["works"]
        assert set(steps) == set(registry.available_models())
        assert all(v == 0.0 for v in steps.values()), steps
        assert works["mesh_2d"] == (1, 2, 0, r)
        assert works["shard_backbone"] == {
            "blocks.0.mlp.fc1.weight": (4, 4), "blocks.0.mlp.fc1.bias": (4,),
            "blocks.0.mlp.fc2.weight": (4, 4), "blocks.0.attn.qkv.weight": (12, 4)}
        np.testing.assert_allclose(works["sinkhorn_model_axis"].numpy(),
                                   want[r * half:(r + 1) * half].numpy(), rtol=1e-5, atol=1e-7)
        assert works["export"] == ["cuda", "cpu"]


def test_sharded_predictor_matches_build_predict_fn():
    from test_torch_trainer import micro_cfg

    tr = Trainer(micro_cfg(bf16=False), device="cpu")
    img = torch.rand((4, 32, 32, 3), generator=torch.Generator().manual_seed(0))
    sharded = serve.build_sharded_predict_fn(tr, mesh.make_mesh(2, "cpu"))
    got, want = sharded(img), serve.build_predict_fn(tr)(img)
    assert set(got) == set(want) == {"cluster_preds", "linear_preds"}
    for k in want:
        assert got[k].shape == (4, 32, 32) and torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="divide evenly"):
        sharded(img[:3])


@pytest.mark.parametrize("n_global", [1 << 16, 1 << 17])
def test_pq_gate_of_a_rank_is_jax_gate_at_the_global_n(n_global):
    """A rank's ``auto`` route decision at its own rows equals the JAX
    step's at the global rows with the data mesh's shards divisor (the
    CPU branch of JAX's ``pq_forward``, equss_tpu/ops/quantizer.py:514-516:
    ``n * M * K * elt / pallas_auto_shards > pallas_auto_bytes``)."""
    from equss_tpu_torch.ops import quantizer as tq

    cfg = tq.PQConfig(num_pq=64, num_codebook=256, embed_dim=1024, assign_precision="bf16",
                      pallas_auto_bytes=2.0e9)
    decisions = set()
    for world in (1, 2, 4):
        want = n_global * 64 * 256 * 2 / world > cfg.pallas_auto_bytes
        got = tq._kernel_eligible(cfg, n_global // world, torch.device("cpu"))
        assert got == want, world
        decisions.add(got)
    assert decisions == {True, False}
