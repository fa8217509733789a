"""The port's tensor parallelism (``equss_tpu_torch/parallel/mesh.py``:
``make_mesh_2d``, ``shard_quantizer``, ``shard_backbone``) on the CPU:
gloo ranks, each a subprocess running this file, laid out as a 1 x 2
and a 2 x 2 (data, model) grid, held against the JAX package's replicated
computation on the same numpy-seeded inputs and converted weights
(``tests/test_parallel.py`` pins JAX's tensor-parallel result to that
replicated computation) and against the port's one-process run.

* JAX's quantizer case (``num_pq=4, num_codebook=64, embed_dim=32``, l2,
  ``training=True``) with param and EMA codebooks and ``z_trainable``, on
  both grids: indices equal, ``vq-loss`` within rtol 1e-6, the new state's
  shards concatenated equal to one process's (counts exactly, the rest
  within rtol 1e-6); the EMA softmax's shards and its JSD and entropy
  against one process; the kernel route (``pq_assign_shard``'s plain
  version under ``AssignShardSTE``, fast and exact) and the restart
  (the options that gather the codebook) against the one-process port.
* The sharded codebook's gradient against one process within 1e-5 of its
  scale.
* JAX's backbone case (vit_micro, hidden 64, PQ 8 x 16, 16^2, f32) on the
  2 x 2 grid: fc1 and fc2 split, everything else whole; indices equal,
  z_q within 2e-5.
* 3 pqgo steps on vit_micro on the 1 x 2 grid with the quantizer and the
  backbone sharded: losses within rtol 1e-5, weights within 1e-5 of their
  scale, both ranks' whole state bit-equal, the gathered ``state_dict``
  and ``train_state`` of one process's names and shapes, loaded into one
  process.
* The Sinkhorn over each axis of the 2 x 2 grid against one process,
  within 1e-5.

On one process: ``pq_assign_shard_reference`` merged over K shards equals
``pq_assign_reference`` (K = 256, 512, 2048), and a two-device artifact's
CPU member predicts as the live predictor, while a device the artifact
does not list raises.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from equss_tpu_torch import serve
from equss_tpu_torch.losses import sinkhorn as tsink
from equss_tpu_torch.ops import quantizer as tq
from equss_tpu_torch.ops.pq_assign import (merge_key, normalize_vectors, packed_keys,
                                           pq_assign_reference, pq_assign_shard_reference)
from equss_tpu_torch.parallel import mesh
from equss_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRIDS = {"1x2": (1, 2), "2x2": (2, 2)}
Q_BASE = dict(num_pq=4, num_codebook=64, embed_dim=32, normalize="l2")
# name: (PQConfig fields, held against JAX)
Q_CASES = {
    "param": (dict(vq_type="param"), True),
    "ema": (dict(vq_type="ema"), True),
    "z_trainable": (dict(vq_type="param", normalize="z_trainable"), True),
    # K % 128 == 0: the kernel route on the CPU too (JAX's shape rule)
    "kernel_exact": (dict(vq_type="param", use_pallas=True, num_codebook=128), True),
    "kernel_fast": (dict(vq_type="param", use_pallas=True, num_codebook=128,
                         assign_precision="bf16"), False),
    "ema_restart": (dict(vq_type="ema", use_restart=True), False),
}
Q_IMAGES = 8
STEPS = 3


def _q_cfg(name):
    return tq.PQConfig(**{**Q_BASE, **Q_CASES[name][0]})


def _data_rows(t, grid):
    n = t.shape[0] // grid.data
    return t[grid.data_index * n:(grid.data_index + 1) * n]


# ---------------------------------------------------------------- the ranks

def _rank_quantizer(grid, job):
    calls = []
    plain = tq.pq_assign_shard

    def counted(*args, **kwargs):            # which cases take the shard op
        calls.append(1)
        return plain(*args, **kwargs)

    tq.pq_assign_shard = counted
    out = {}
    for name in Q_CASES:
        calls.clear()
        case = job["quantizer"][name]
        cfg = _q_cfg(name)
        p, s = mesh.shard_quantizer(grid, case["params"], case["state"])
        p = {k: v.clone().requires_grad_(k == "codebook") for k, v in p.items()}
        z = _data_rows(case["z"], grid)
        kw = {"cand_idx": case["cand_idx"]} if "cand_idx" in case else {}
        zq, idx, aux, new_state = tq.pq_forward(z, p, s, cfg, training=True, **kw)
        res = {"idx": idx, "z_q": zq.detach(), "vq-loss": aux["vq-loss"].item(),
               "usage": aux["codebook-usage"].item(), "state": new_state}
        if cfg.vq_type == "param":
            aux["vq-loss"].backward()
            res["grad"] = p["codebook"].grad
            with torch.no_grad():
                res["infer_idx"] = tq.pq_forward(z, p, s, cfg)[1]
        if "distance_prob" in aux:
            prob = aux["distance_prob"].detach()
            res["prob"] = prob
            flat = mesh.gather_rows(prob).reshape(-1, *prob.shape[-2:])
            half = flat.shape[0] // 2
            res["jsd"] = [v.item() for v in tq.ema_jsd_entropy(
                flat[:half], flat[half:], sharded=prob.shape[-1] != cfg.num_codebook)]
        res["shard_op_calls"] = len(calls)
        out[name] = res
    tq.pq_assign_shard = plain
    try:                                     # K = 63 does not split over 2 ranks
        mesh.shard_quantizer(grid, {"codebook": torch.zeros(2, 63, 4)}, {})
        out["uneven_k"] = None
    except ValueError as e:
        out["uneven_k"] = str(e)
    return out


def _rank_backbone(grid, job):
    from equss_tpu_torch.models.equss import EQUSS

    model = EQUSS(job["backbone"]["cfg"], device="cpu")
    model.load_state_dict(job["backbone"]["sd"])
    mesh.shard_backbone(grid, model)
    out = model(_data_rows(job["backbone"]["img"], grid))
    return {"indices": out["indices"], "z_q": out["z_q"],
            "shapes": {k: tuple(v.shape) for k, v in model.state_dict().items()},
            "layout": mesh.sharded_layout(model)}


def _rank_steps(grid, job):
    tr = Trainer(job["pqgo"]["cfg"], device="cpu", mesh=grid)
    mesh.shard_quantizer(grid, tr.model)
    mesh.shard_backbone(grid, tr.model)
    metrics = [tr.train_step(b) for b in job["pqgo"]["batches"]]
    local = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    ts = tr.train_state()
    moments = {k: v.clone() for k, v in tr.tx_model.state_dict()["state"]["pq.codebook"].items()}
    # whole tensors back into the shards: the state as it was
    tr.load_train_state(ts)
    reloaded = all(torch.equal(v, local[k]) for k, v in tr.model.state_dict().items()) and all(
        torch.equal(v, moments[k])
        for k, v in tr.tx_model.state_dict()["state"]["pq.codebook"].items())
    return {"metrics": metrics, "state_dict": tr.state_dict(), "local": local,
            "train_state": ts, "reloaded": reloaded}


def _rank_sinkhorn(grid, job):
    scores = job["scores"]
    n = scores.shape[0]
    out = {}
    for axis, index, size in (("data", grid.data_index, grid.data),
                              ("model", grid.model_index, grid.model)):
        rows = scores[index * n // size:(index + 1) * n // size]
        out[axis] = tsink.distributed_sinkhorn(rows, epsilon=0.05, axis_name=axis)
    return out


def _rank(rank, world, data, model, port, job_path, out_path):
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    mesh.init_distributed(f"localhost:{port}", world, rank, device="cpu")
    grid = mesh.make_mesh_2d(data, model)
    out = {"place": (grid.data_index, grid.model_index)}
    with mesh.global_program():
        out["quantizer"] = _rank_quantizer(grid, job)
        out["sinkhorn"] = _rank_sinkhorn(grid, job)
    if data == 2:
        out["backbone"] = _rank_backbone(grid, job)
    else:
        out["steps"] = _rank_steps(grid, job)
    mesh.barrier()
    torch.save(out, out_path)


if __name__ == "__main__":
    _rank(*map(int, sys.argv[1:6]), sys.argv[6], sys.argv[7])
    sys.exit(0)


# ------------------------------------------------------------- the fixtures

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _quantizer_job():
    rng = np.random.RandomState(0)
    job = {}
    for name in Q_CASES:
        cfg = _q_cfg(name)
        M, K, d = cfg.num_pq, cfg.num_codebook, cfg.sub_dim
        params, state = tq.pq_init(torch.Generator().manual_seed(3), cfg)
        if cfg.vq_type == "ema":
            w = torch.from_numpy(rng.uniform(-1, 1, (M, K, d)).astype(np.float32))
            state.update(ema_weight=w, ema_weight_avg=w.clone(),
                         ema_count=torch.from_numpy(rng.uniform(0, 2, (M, K)).astype(np.float32)))
        if "z_mean" in params:
            params["z_mean"] = torch.from_numpy(0.1 * rng.randn(M, d).astype(np.float32))
            params["z_log_var"] = torch.from_numpy(0.1 * rng.randn(M, d).astype(np.float32))
        case = {"params": params, "state": state,
                "z": torch.from_numpy(rng.randn(Q_IMAGES, 4, 4, cfg.embed_dim).astype(np.float32))}
        if cfg.use_restart:
            case["cand_idx"] = torch.from_numpy(rng.randint(0, Q_IMAGES * 16, (M, K)))
        job[name] = case
    return job


def _backbone_case():
    """JAX's EQUSS of ``tests/test_parallel.py``'s backbone case and the
    port's config and converted weights."""
    import jax

    from equss_tpu.models import equss as jeq
    from equss_tpu.ops.quantizer import PQConfig as JPQConfig
    from equss_tpu_torch.convert import params_from_jax
    from equss_tpu_torch.models.equss import EQUSSConfig

    pq = dict(num_pq=8, num_codebook=16, embed_dim=64, vq_type="param", normalize="l2")
    common = dict(model_type="vit_micro", patch_size=8, hidden_dim=64, dropout=False)
    cfg_j = jeq.EQUSSConfig(pq=JPQConfig(**pq), **common)
    cfg_t = EQUSSConfig(pq=tq.PQConfig(**pq), **common)
    model_j = jeq.EQUSS(cfg_j)
    params, state = model_j.init(jax.random.PRNGKey(0), img_hw=(16, 16))
    img = np.random.RandomState(1).uniform(size=(8, 16, 16, 3)).astype(np.float32)
    ref = model_j.apply(params, state, img, training=False)[0]
    return ({"cfg": cfg_t, "sd": params_from_jax(params, state, cfg_t),
             "img": torch.from_numpy(img)},
            {k: np.asarray(ref[k]) for k in ("indices", "z_q")})


def _launch(grid_name, job_path, tmp):
    data, model = GRIDS[grid_name]
    world, port = data * model, _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(world), str(data), str(model),
         str(port), job_path, str(tmp / f"{grid_name}_{r}.pt")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    return procs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both grids' ranks, started together, and the one-process references
    (JAX and the port) computed while they run."""
    from test_torch_parallel import _global_batches
    from test_torch_trainer import micro_cfg

    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("tensor_parallel")
    backbone, backbone_ref = _backbone_case()
    pqgo = micro_cfg(bf16=False)
    pqgo["model"]["pretrained"]["dropout"] = True
    batches = [{k: v[:, :32, :32] for k, v in b.items()} for b in _global_batches(STEPS, 0)]
    job = {"quantizer": _quantizer_job(), "backbone": backbone,
           "pqgo": {"cfg": pqgo, "batches": batches},
           "scores": torch.from_numpy(np.random.RandomState(4).randn(16, 5).astype(np.float32))}
    job_path = str(tmp / "job.pt")
    torch.save(job, job_path)
    procs = {g: _launch(g, job_path, tmp) for g in GRIDS}

    tr = Trainer(pqgo, device="cpu")
    one = {"metrics": [tr.train_step(b) for b in batches], "state_dict": tr.state_dict(),
           "train_state": tr.train_state()}
    logs = {}
    for g, ps in procs.items():
        for r, p in enumerate(ps):
            logs[(g, r)] = p.communicate(timeout=600)[0].decode(errors="replace")
            assert p.returncode == 0, f"grid {g} rank {r}:\n{logs[(g, r)][-4000:]}"
    ranks = {g: [torch.load(tmp / f"{g}_{r}.pt", weights_only=False)
                 for r in range(len(procs[g]))] for g in GRIDS}
    return {"job": job, "ranks": ranks, "one": one, "backbone_ref": backbone_ref}


def _jax_pq(name, case):
    import jax
    import jax.numpy as jnp

    from equss_tpu.ops import quantizer as jq

    cfg = jq.PQConfig(**{**Q_BASE, **Q_CASES[name][0]})
    to_j = lambda tree: {k: jnp.asarray(v.numpy()) for k, v in tree.items()}  # noqa: E731
    zq, idx, aux, state = jq.pq_forward(jnp.asarray(case["z"].numpy()), to_j(case["params"]),
                                        to_j(case["state"]), cfg, training=True,
                                        rng=jax.random.PRNGKey(2))
    return (np.asarray(idx), float(aux["vq-loss"]), {k: np.asarray(v) for k, v in state.items()},
            np.asarray(aux["distance_prob"]) if "distance_prob" in aux else None)


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("grid_name", sorted(GRIDS))
@pytest.mark.parametrize("name", [n for n, (_, j) in Q_CASES.items() if j])
def test_sharded_quantizer_matches_jax(runs, grid_name, name):
    """JAX's quantizer case on the grid against JAX's replicated
    ``pq_forward``: indices equal, vq-loss rtol 1e-6 (the data ranks'
    mean), the new state's shards concatenated equal to JAX's (counts
    exactly, the rest rtol 1e-6), an EMA softmax's shards within 1e-6."""
    case = runs["job"]["quantizer"][name]
    idx_j, loss_j, state_j, prob_j = _jax_pq(name, case)
    ranks = runs["ranks"][grid_name]
    data, model = GRIDS[grid_name]
    assert all("does not divide" in r["quantizer"]["uneven_k"] for r in ranks)
    outs = [r["quantizer"][name] for r in ranks]
    for r, o in enumerate(outs):             # every model rank of a data group alike
        assert torch.equal(o["idx"], outs[(r // model) * model]["idx"])
        assert torch.equal(o["z_q"], outs[(r // model) * model]["z_q"])
    idx = torch.cat([outs[i * model]["idx"] for i in range(data)])
    np.testing.assert_array_equal(idx.numpy(), idx_j)
    loss = np.mean([outs[i * model]["vq-loss"] for i in range(data)])
    np.testing.assert_allclose(loss, loss_j, rtol=1e-6)
    for k, want in state_j.items():
        got = torch.cat([outs[c]["state"][k] for c in range(model)], 1)
        for i in range(data):                # the data ranks hold the same state
            got_i = torch.cat([outs[i * model + c]["state"][k] for c in range(model)], 1)
            assert torch.equal(got_i, got), k
        if k.endswith("count"):
            np.testing.assert_array_equal(got.numpy(), want, err_msg=k)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7, err_msg=k)
    if prob_j is not None:
        # each data group's rows, the model ranks' codewords side by side
        prob = torch.cat([torch.cat([outs[i * model + c]["prob"] for c in range(model)], -1)
                          for i in range(data)])
        np.testing.assert_allclose(prob.numpy(), prob_j.reshape(prob.shape), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("grid_name", sorted(GRIDS))
@pytest.mark.parametrize("name", sorted(Q_CASES))
def test_sharded_quantizer_matches_one_process(runs, grid_name, name):
    """Every case (the kernel route through ``AssignShardSTE`` and the
    shard op's plain version, fast and exact; the restart, which gathers the
    codebook) against the one-process port on the whole batch: indices
    equal in training and inference, z_q and vq-loss within 1e-6, the
    usage telemetry equal, the new state's shards concatenated within
    1e-6 (counts exactly), the codebook gradient (the data ranks' mean)
    within 1e-5 of its scale, an EMA codebook's JSD and entropy within
    1e-5."""
    case = runs["job"]["quantizer"][name]
    cfg = _q_cfg(name)
    params = {k: v.clone().requires_grad_(k == "codebook") for k, v in case["params"].items()}
    kw = {"cand_idx": case["cand_idx"]} if "cand_idx" in case else {}
    zq, idx, aux, state = tq.pq_forward(case["z"], params, case["state"], cfg, training=True, **kw)
    data, model = GRIDS[grid_name]
    outs = [r["quantizer"][name] for r in runs["ranks"][grid_name]]
    # the kernel cases' training and inference calls take the shard op
    assert all(o["shard_op_calls"] == (2 if name.startswith("kernel") else 0) for o in outs)
    firsts = [outs[i * model] for i in range(data)]
    assert torch.equal(torch.cat([o["idx"] for o in firsts]), idx)
    torch.testing.assert_close(torch.cat([o["z_q"] for o in firsts]), zq.detach(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.mean([o["vq-loss"] for o in firsts]), aux["vq-loss"].item(),
                               rtol=1e-6)
    for o in outs:                           # the counts are the global batch's
        assert o["usage"] == aux["codebook-usage"].item()
    for k, want in state.items():
        got = torch.cat([outs[c]["state"][k] for c in range(model)], 1)
        if k.endswith("count"):
            assert torch.equal(got, want), k
        else:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-7)
    if cfg.vq_type == "param":
        aux["vq-loss"].backward()
        want = params["codebook"].grad
        got = sum(torch.cat([outs[i * model + c]["grad"] for c in range(model)], 1)
                  for i in range(data)) / data
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
        with torch.no_grad():
            infer = tq.pq_forward(case["z"], params, case["state"], cfg)[1]
        assert torch.equal(torch.cat([o["infer_idx"] for o in firsts]), infer)
    if "jsd" in outs[0]:
        prob = aux["distance_prob"].detach().reshape(-1, 4, cfg.num_codebook)
        half = prob.shape[0] // 2
        want = [v.item() for v in tq.ema_jsd_entropy(prob[:half], prob[half:])]
        for o in outs:
            np.testing.assert_allclose(o["jsd"], want, rtol=1e-5)


def test_backbone_tensor_parallel_matches_jax(runs):
    """JAX's backbone case on the 2 x 2 grid: fc1's rows and bias and fc2's
    columns split in two, everything else (qkv and proj included) whole;
    each data rank's indices equal to JAX's on its images, z_q within 2e-5,
    the model ranks of a data group alike."""
    ref = runs["backbone_ref"]
    ranks = runs["ranks"]["2x2"]
    full = runs["job"]["backbone"]["sd"]
    for r, out in enumerate(r["backbone"] for r in ranks):
        layout = out["layout"]
        assert layout and all(".mlp.fc" in k for k in layout)
        for name, shape in out["shapes"].items():
            whole = tuple(full[name].shape)
            if name.endswith(("mlp.fc1.weight", "mlp.fc1.bias")):
                assert shape == (whole[0] // 2, *whole[1:]) and layout[name] == 0, name
            elif name.endswith("mlp.fc2.weight"):
                assert shape == (whole[0], whole[1] // 2) and layout[name] == 1, name
            else:
                assert shape == whole and name not in layout, name
        i = r // 2
        np.testing.assert_array_equal(out["indices"].numpy(), ref["indices"][4 * i:4 * i + 4])
        np.testing.assert_allclose(out["z_q"].numpy(), ref["z_q"][4 * i:4 * i + 4],
                                   rtol=2e-5, atol=2e-5)
        assert torch.equal(out["z_q"], ranks[i * 2]["backbone"]["z_q"])


def test_pqgo_steps_on_a_sharded_grid_match_one_process(runs):
    """3 pqgo steps (dropout and STEGO's own draws) on the 1 x 2 grid with
    the quantizer and the backbone sharded: each loss term within rtol
    1e-5 of the one-process run's, the gathered weights within 1e-5 of
    their scale, the ranks' gathered state bit-equal, the whole (replicated)
    tensors of the two ranks bit-equal; ``state_dict`` and ``train_state``
    gathered to one process's names and shapes, and loadable into one
    process."""
    one = runs["one"]
    a, b = (r["steps"] for r in runs["ranks"]["1x2"])
    for ma, mb, mo in zip(a["metrics"], b["metrics"], one["metrics"]):
        assert ma == mb
        for k in ("loss", "stego-loss", "vq-loss", "linear-loss", "cluster-loss"):
            np.testing.assert_allclose(ma[k], mo[k], rtol=1e-5, err_msg=k)
        assert ma["skipped"] == 0.0
    assert set(a["state_dict"]) == set(one["state_dict"])
    for k, want in one["state_dict"].items():
        assert a["state_dict"][k].shape == want.shape, k
        assert torch.equal(a["state_dict"][k], b["state_dict"][k]), k
        scale = max(want.abs().max().item(), 1e-12)
        assert (a["state_dict"][k] - want).abs().max().item() <= 1e-5 * scale, k
    layout = {k for k in a["local"] if a["local"][k].shape != one["state_dict"][k].shape}
    assert layout and all(k.startswith("pq") or ".mlp.fc" in k for k in layout)
    for k in a["local"]:
        if k not in layout:
            assert torch.equal(a["local"][k], b["local"][k]), k
    ts = a["train_state"]
    for k, v in one["train_state"]["opt"]["model"]["state"].items():
        for m, t in v.items():
            assert ts["opt"]["model"]["state"][k][m].shape == t.shape, (k, m)
    tr = Trainer(runs["job"]["pqgo"]["cfg"], device="cpu")
    tr.load_train_state(ts)
    for k, v in tr.state_dict().items():
        assert torch.equal(v, a["state_dict"][k]), k
    # and the other way round: the whole state back into each rank's shards
    assert a["reloaded"] and b["reloaded"]


def test_sinkhorn_over_each_axis_matches_one_process(runs):
    """The 2 x 2 grid's Sinkhorn with ``axis_name`` ``data`` (the rows split
    over the data index) and ``model`` (over the model index) against one
    process on every row, within 1e-5; the 1 x 2 grid's over its model axis
    too."""
    scores = runs["job"]["scores"]
    want = tsink.distributed_sinkhorn(scores, epsilon=0.05)
    for grid_name, ranks in runs["ranks"].items():
        data, model = GRIDS[grid_name]
        for out in ranks:
            i, c = out["place"]
            for axis, index, size in (("data", i, data), ("model", c, model)):
                n = len(scores) // size
                torch.testing.assert_close(out["sinkhorn"][axis], want[index * n:(index + 1) * n],
                                           rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("K", [256, 512, 2048])
@pytest.mark.parametrize("exact", [True, False], ids=["exact", "fast"])
def test_shard_reference_merges_to_the_whole_reference(K, exact):
    """``pq_assign_shard_reference`` on 2 and 4 K-shards, merged by the
    least ``merge_key`` (z_q from the owner), equals ``pq_assign_reference``
    over the whole codebook: indices and z_q; K = 512 and 2048 cross the
    packed minimum's K <= 256 in fast mode, whose shards keep the whole
    codebook's rule."""
    g = torch.Generator().manual_seed(K)
    M, d, n = 4, 16, 257
    z = 3.0 * torch.randn((n, M, d), generator=g)
    cb = torch.randn((M, K, d), generator=g)
    cn = normalize_vectors(cb, "l2")
    idx, _, zq = pq_assign_reference(z, cn, cb, normalize="l2", exact=exact)
    for m in (2, 4):
        kp = K // m
        outs = [pq_assign_shard_reference(z, cn[:, r * kp:(r + 1) * kp], cb[:, r * kp:(r + 1) * kp],
                                          r * kp, K, normalize="l2", exact=exact)
                for r in range(m)]
        win = torch.stack([merge_key(o[3], o[0], packed_keys(K, exact)) for o in outs]).amin(0)
        got = (win & 0xFFFFFFFF).to(torch.int32)
        assert torch.equal(got, idx), m
        owner = torch.stack([o[0] for o in outs]) == got
        assert torch.equal((torch.stack([o[2] for o in outs]) * owner[..., None]).sum(0), zq)


def test_two_device_artifact_cpu_member_and_unlisted_device(tmp_path):
    """An artifact exported with ``platforms=cuda,cpu`` lists both devices
    and its CPU member predicts as the live predictor; one exported for the
    CPU alone raises for CUDA."""
    from test_torch_trainer import micro_cfg

    tr = Trainer(micro_cfg(bf16=False), device="cpu")
    img = torch.rand((2, 32, 32, 3), generator=torch.Generator().manual_seed(0))
    live = serve.build_predict_fn(tr)(img)
    both = serve.save_predictor(serve.export_predictor(tr, (32, 32), batch_size=2,
                                                       platforms="cuda,cpu"),
                                str(tmp_path / "both.pt2"))
    extra = {serve.PLATFORMS_FILE: ""}
    torch.export.load(both, extra_files=extra)
    assert extra[serve.PLATFORMS_FILE] == "cuda,cpu"
    got = serve.load_predictor(both, device="cpu")(img)
    for k in live:
        assert torch.equal(got[k], live[k]), k
    cpu_only = serve.save_predictor(serve.export_predictor(tr, (32, 32), batch_size=2),
                                    str(tmp_path / "cpu.pt2"))
    with pytest.raises(ValueError, match="serves \\['cpu'\\], not cuda"):
        serve.load_predictor(cpu_only, device="cuda")
