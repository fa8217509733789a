"""The ``models/variants.py`` families across ranks (``parallel/mesh.py``)
on the CPU: two gloo ranks, each a subprocess running this file, held
against the port's one-process run and the JAX package's on the global
batch.  This file holds ``pqgocls``, ``cluster`` (margin and SwAV),
``res`` and ``hihi`` (UnSeg) and the loss terms on their own;
``tests/test_torch_parallel_variants_quantized.py`` the quantizing
families, reusing the harness below.

vit_micro at 64^2, a global batch of 4 (2 rows a rank), dropout on where
the config has it, the photometric view drawn by the trainer.

* Every family, 3 steps: both ranks hold the same train state bit for
  bit after every step (weights, optimizer moments, the model's state
  buffers: the SwAV queue and counters, the EMA head, the CLUB encoder
  and its Adam moments, BatchNorm's running averages, the quantizers'
  state; and the generator); against the one-process run the loss
  terms of every step within rtol 1e-5, the first step's gradients
  within 1e-4 of their scale, the model state after 3 steps within 1e-5
  of its scale (integers equal) and the generator equal (the bars of
  ``ranks_match_one_process``, with an allowance for Adam's steps on
  gradients that are rounding in the families with BatchNorm); ``validate`` before training equal
  to the one-process run's (mIoU and Accuracy within 1e-6, losses rtol
  1e-5).  SwAV runs with its queue live from the second step on.
* ``cluster`` (margin; SwAV past both gates with a partly filled queue)
  and ``res``, from JAX's initial weights with JAX's draws fed (the
  view, the InfoNCE negatives): the ranks' summed gradients within 1e-4
  of their scale of JAX's one-process step on the global batch, the loss
  terms (the ranks' mean) within rtol 1e-5 (CLUB's and the margin's
  1e-4, as ``tests/test_torch_variants.py`` holds them) and the new
  state within its bars there.
* The margin ranking, InfoNCE (random and cosine), CLUB, the JSD and the
  entropy on their own: the ranks' mean value within 1e-5 of JAX's on
  the global batch (CLUB's 1e-4), and the input gradients (each rank's rows, the
  gathered columns' share returned to their owners) within 1e-5 of
  their scale of JAX's.
"""
import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from equss_tpu_torch.data.synthetic import synthetic_batches
from equss_tpu_torch.parallel import mesh
from equss_tpu_torch.train.trainer import Trainer
from test_torch_parallel import _close, _flat, _free_port, _snapshot, _steps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, N, RES = 2, 4, 64              # ranks, global batch, resolution
ROWS = N // WORLD
PIX = N * (RES // 8) ** 2             # pixel rows of the global batch
# batch keys that are not per image: every rank takes them whole
WHOLE = ("kmeans_first", "kmeans_gumbel", "split_noise_0", "split_noise_1",
         "proxy_q_idx", "proxy_neg_idx")
# batch keys that are per pixel row
PER_PIXEL = ("info_nce_idx", "gumbel_0", "gumbel_1", "gumbel_2")


def rows_of(batch, rank):
    """A rank's rows of a global batch: its images, its pixel rows of the
    per-pixel draws, ``dropout_keep``'s rows of each view, the rest
    whole."""
    out = {}
    for k, v in batch.items():
        if k in WHOLE:
            out[k] = v
        elif k in PER_PIXEL:
            per = v.shape[0] // WORLD
            out[k] = v[rank * per:(rank + 1) * per]
        elif k == "dropout_keep":
            out[k] = v[:, rank * ROWS:(rank + 1) * ROWS]
        else:
            out[k] = v[rank * ROWS:(rank + 1) * ROWS]
    return out


def train_batches(n, seed):
    """Global batches without ``aug_img``: the trainer draws the view."""
    return [{k: v for k, v in b.items() if k != "aug_img"}
            for b in synthetic_batches(seed, n, batch_size=N, res=RES, num_classes=4)]


def val_batches(n, seed=5):
    return list(synthetic_batches(seed, n, batch_size=N, res=RES, num_classes=4,
                                  with_pos=False))


# --------------------------------------------------------- the ranks

def run_family(cfg, train, val, rank=None):
    """``validate``, then ``data_init`` where the model needs one, then a
    step per batch: what the tests compare.  ``rank`` None runs the
    global batches on one process."""
    rows = (lambda bs: bs) if rank is None else (lambda bs: [rows_of(b, rank) for b in bs])
    tr = Trainer(cfg, device="cpu")
    out = {"validate": tr.validate(rows(val))}
    if getattr(tr.model, "needs_data_init", False):
        tr.data_init(rows(train)[0])
        out["data_init"] = _snapshot(tr)
    batches = rows(train)
    first = _steps(tr, batches[:1])
    # the gradients the first step took (the ranks' sum)
    out["grads"] = {n: p.grad.clone() for n, p in (*tr.model_params, *tr.probe_params)
                    if p.grad is not None}
    rest = _steps(tr, batches[1:])
    out.update(metrics=first["metrics"] + rest["metrics"],
               states=first["states"] + rest["states"])
    return out


def jax_case_on_ranks(case, rank):
    """A model-level training step from JAX's weights on this rank's rows
    inside a global program: the ranks' summed gradients, the loss terms'
    mean over the ranks and this rank's new state."""
    from equss_tpu_torch.models import registry

    tm = registry.build_model(case["cfg"], device="cpu", seed=5)
    tm.load_state_dict(case["sd"])
    inputs = rows_of(case["inputs"], rank)
    draws = rows_of(case["draws"], rank)
    with mesh.global_program():
        out = tm(inputs["img"], inputs["img_pos"], aug_img=inputs["aug_img"], training=True,
                 generator=torch.Generator(), **draws)
        loss = sum(w * out["aux"][k] for k, w in case["weights"].items())
        (loss / WORLD).backward()
        grads = {k: None if p.grad is None else mesh.all_reduce_sum(p.grad.clone())
                 for k, p in tm.named_parameters() if not k.startswith("backbone.")}
        aux = {k: float(mesh.mean_over_ranks(v.detach().float()))
               for k, v in out["aux"].items() if v.ndim == 0}
    return {"grads": grads, "aux": aux,
            "state": {k: v.detach() for k, v in out.get("state", {}).items()}}


def terms_on_ranks(terms, rank):
    """Each loss term on this rank's rows in a global program: its value
    (this rank's share) and the gradient of the ranks' mean at this
    rank's inputs."""
    from equss_tpu_torch.losses import basic

    def local(x, per=None):
        per = per or x.shape[0] // WORLD
        return torch.from_numpy(x[rank * per:(rank + 1) * per]).requires_grad_()

    out = {}
    with mesh.global_program():
        for name, t in terms.items():
            if name == "margin":
                args = [local(t["ori"]), torch.from_numpy(t["aug"][rank * ROWS:(rank + 1) * ROWS])]
                value = basic.margin_ranking_loss(*args, block=24)
            elif name.startswith("info_nce"):
                args = [local(t["x1"]), local(t["x2"])]
                idx = t.get("idx")
                idx = None if idx is None else torch.from_numpy(rows_of(
                    {"info_nce_idx": idx}, rank)["info_nce_idx"])
                value = basic.info_nce_loss(*args, idx, **t["kwargs"])
            elif name == "club":
                args = [local(t["x"]), local(t["mu"]), local(t["logvar"])]
                value = basic.club_loss(*args)
            elif name == "jsd":
                args = [local(t["p"]), local(t["q"])]
                value = basic.jsd_loss(*args, block=7)
            else:
                args = [local(t["p"])]
                value = basic.entropy_loss(*args)
            (value / WORLD).backward()
            out[name] = {"value": float(value), "grads": [a.grad for a in args if a.requires_grad]}
    return out


def _rank(rank, port, job_path, out_path):
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    mesh.init_distributed(f"localhost:{port}", WORLD, rank, device="cpu")
    out = {"families": {name: run_family(cfg, job["train"], job["val"], rank)
                        for name, cfg in job["cfgs"].items()},
           "jax": {name: jax_case_on_ranks(case, rank) for name, case in job["jax"].items()}}
    if "terms" in job:
        out["terms"] = terms_on_ranks(job["terms"], rank)
    torch.save(out, out_path)


def launch(tmp, job, script):
    """Start the two ranks of ``script`` on ``job``; returns a function
    that waits for them and returns their outputs."""
    torch.save(job, tmp / "job.pt")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, script, str(r), str(port), str(tmp / "job.pt"),
                               str(tmp / f"rank{r}.pt")], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]

    def wait():
        try:
            outs = [p.communicate(timeout=420)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for r, (p, text) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"rank {r} failed:\n{text[-4000:]}"
        return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return wait


if __name__ == "__main__":
    _rank(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    sys.exit(0)


# ------------------------------------------------------- the fixtures

def family_cfg(name, dropout=None):
    """``name`` at vit_micro (``tests/test_torch_variants.py::micro``),
    with channel dropout as the config has it unless ``dropout``."""
    from equss_tpu.core.config import load_config
    from test_torch_variants import micro

    cfg = micro(name)
    pre = load_config(f"configs/{name}.yaml")["model"]["pretrained"]
    cfg["model"]["pretrained"]["dropout"] = pre.get("dropout", False) if dropout is None \
        else dropout
    return cfg


def jax_draws(name, cfg, rng, feat_dim):
    """JAX's draws inside ``apply`` at the global batch, as the port's
    overrides (``tests/test_torch_variants.py::_draws`` at N images)."""
    import jax

    from test_torch_variants import _t

    kw = {}
    vq = cfg["model"].get("vq", {})
    if name.startswith("contra"):
        for i, (k, e, m) in enumerate(zip(vq["num_codebooks"], vq["embed_dims"], vq["num_pq"])):
            key = jax.random.split(jax.random.fold_in(rng, i))[1]
            kw[f"split_noise_{i}"] = _t(jax.random.normal(key, (m, k, e // m)))
    if name.startswith("ema"):
        keys = jax.random.split(rng, 4)
        mb, ince = cfg["model"]["memory_bank"], cfg["loss"]["info_nce"]
        C, Q = mb["n_cluster"], mb["queue_size"]
        k_q, k_n = jax.random.split(keys[2])
        kw["proxy_q_idx"] = _t(jax.random.randint(k_q, (C, ince["num_queries"]), 0, Q))
        kw["proxy_neg_idx"] = _t(jax.random.randint(
            k_n, (C, ince["num_queries"] * ince["num_neg"]), 0, (C - 1) * Q))
        pre = cfg["model"]["pretrained"]
        if pre["dropout"]:
            kw["dropout_keep"] = torch.stack([_t(jax.random.bernoulli(
                keys[j], 1.0 - pre["drop_prob"], (N, 1, 1, feat_dim))) for j in (0, 1)])
    if name.startswith(("cluster", "res", "new_vq", "spq")):
        fold = {"cluster": 23, "res": 3}.get(name.split("_")[0], 7)
        neg = (cfg["loss"].get("info_nce", {}) or {}).get("neg_sample", 10)
        kw["info_nce_idx"] = _t(jax.random.randint(jax.random.fold_in(rng, fold),
                                                   (PIX, neg), 0, PIX))
    return kw


def jax_case(name, swav_it=None):
    """JAX's one-process training forward and backward on the global batch
    from its initial weights, and what the ranks need to run the same:
    (the job's case, JAX's gradients, aux terms and new state)."""
    import jax
    import jax.numpy as jnp

    from equss_tpu_torch.convert import batch_stats_prefix, state_from_flax
    from equss_tpu_torch.convert import _trainable_from_flax, params_from_jax
    from equss_tpu.train.trainer import LOSS_WEIGHT_MAP
    from test_torch_variants import _mcfg, _pair

    cfg, jm, params, state, tm = _pair(name, swav_it=swav_it)
    rs = np.random.RandomState(1)
    img, pos, aug = (rs.randn(N, RES, RES, 3).astype(np.float32) for _ in range(3))
    rng = jax.random.PRNGKey(1)
    weights = {aux: float(cfg["loss"][w]) for w, aux in LOSS_WEIGHT_MAP.items()
               if float(cfg["loss"].get(w, 0.0) or 0.0) > 0.0}
    for part, w in (cfg["loss"].get("contra_weight", {}) or {}).items():
        if float(w) > 0.0:
            weights[f"contra-loss-{part}"] = float(w)

    def loss_j(trainable):
        out, new_state = jm.apply(dict(params, **trainable), state, jnp.asarray(img),
                                  img_pos=jnp.asarray(pos), aug_img=jnp.asarray(aug),
                                  training=True, rng=rng)
        return sum(w * out["aux"][k] for k, w in weights.items()), (out, new_state)

    trainable = {k: v for k, v in params.items() if k != "backbone"}
    (_, (out_j, state_j)), grads_j = jax.value_and_grad(loss_j, has_aux=True)(trainable)
    case = {"cfg": cfg, "sd": params_from_jax(params, state, _mcfg()), "weights": weights,
            "inputs": {"img": torch.from_numpy(img), "img_pos": torch.from_numpy(pos),
                       "aug_img": torch.from_numpy(aug)},
            "draws": jax_draws(name, cfg, rng, tm.feat_dim)}
    want = {"grads": _trainable_from_flax(jax.device_get(grads_j)),
            "aux": {k: float(v) for k, v in out_j["aux"].items() if np.ndim(v) == 0},
            "state": state_from_flax(jax.device_get(state_j), batch_stats_prefix(params))}
    return case, want


def loss_terms():
    """Inputs of the loss terms on their own, at the global batch: (b, h,
    w, d) features, per-pixel means and log-variances, probability
    rows."""
    import jax

    rs = np.random.RandomState(7)
    f = lambda *s: rs.randn(*s).astype(np.float32)  # noqa: E731
    feat = (N, 8, 8, 16)
    prob = lambda: np.exp(f(PIX, 12)) / np.exp(f(PIX, 12)).sum(-1, keepdims=True)  # noqa: E731
    # JAX's random negatives for its key 0, fed to the port
    idx = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (PIX, 10), 0, PIX), np.int64)
    return {"margin": {"ori": f(*feat), "aug": f(*feat)},
            "info_nce_random": {"x1": f(*feat), "x2": f(*feat), "idx": idx,
                                "kwargs": {"cal_type": "random", "neg_sample": 10,
                                           "temperature": 0.5}},
            "info_nce_cosine": {"x1": f(*feat), "x2": f(*feat),
                                "kwargs": {"cal_type": "cosine", "neg_sample": 10}},
            "club": {"x": f(*feat), "mu": f(PIX, 16), "logvar": 0.3 * f(PIX, 16)},
            "jsd": {"p": prob().astype(np.float32), "q": prob().astype(np.float32)},
            "entropy": {"p": prob().astype(np.float32)}}


FAMILIES = ("pqgo_cls_cocostuff27", "cluster_margin_cocostuff27", "cluster_swav_cocostuff27",
            "res_cocostuff27", "unseg_cocostuff27")
JAX_CASES = {"cluster_margin": ("cluster_margin_cocostuff27", None),
             "cluster_swav": ("cluster_swav_cocostuff27", 200),
             "res": ("res_cocostuff27", None)}


def swav_live(cfg):
    """SwAV with its gates open after the first step and a short queue."""
    cfg["loss"]["cluster"].update(queue_start_iter=1, freeze_prototypes_niter=1,
                                  queue_len=256)
    return cfg


def one_process(job):
    torch.set_num_threads(1)
    return {name: run_family(cfg, job["train"], job["val"]) for name, cfg in job["cfgs"].items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Launch the two ranks, compute the one-process references (the port
    and JAX) while they run, and return both."""
    cfgs = {name: family_cfg(name) for name in FAMILIES}
    swav_live(cfgs["cluster_swav_cocostuff27"])
    cases, jax_want = {}, {}
    for key, (name, swav_it) in JAX_CASES.items():
        cases[key], jax_want[key] = jax_case(name, swav_it)
    job = {"cfgs": cfgs, "train": train_batches(3, seed=0), "val": val_batches(1),
           "jax": cases, "terms": loss_terms()}
    wait = launch(tmp_path_factory.mktemp("variants"), job, os.path.abspath(__file__))
    ref = one_process(job)
    return {"ranks": wait(), "ref": ref, "jax": jax_want, "job": job}


# ------------------------------------------------------------ tests

def _validate_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if k.endswith(("mIoU", "Accuracy")):
            assert got[k] == pytest.approx(v, abs=1e-6), k
        else:
            assert got[k] == pytest.approx(v, rel=1e-5, abs=1e-7), k


def ranks_hold_the_same_state(runs, name):
    a, b = (out["families"][name] for out in runs["ranks"])
    states = [("data_init", a["data_init"], b["data_init"])] if "data_init" in a else []
    states += [(step, sa, sb) for step, (sa, sb) in enumerate(zip(a["states"], b["states"]))]
    assert len(a["states"]) == 3
    for step, sa, sb in states:
        assert set(sa) == set(sb)
        for k in sa:                # weights, moments, model state, generator
            assert torch.equal(sa[k], sb[k]), (step, k)


# the families whose decoders hold BatchNorm: the gradient a BatchNorm
# returns is a difference of near-equal sums, so some of its elements are
# rounding, and Adam moves an element by up to its learning rate whatever
# the gradient's size
BATCHNORM = ("res", "unseg", "new_vq", "info", "contra")


def ranks_match_one_process(runs, name):
    """Against the one-process run: ``validate`` equal, the first batch's
    ``data_init`` bit-equal, the generator's state equal (the same
    draws); the first step's loss terms within rtol 1e-5 (the gradient
    norms 1e-4) and its gradients (model and probes) within 1e-4 of their
    scale (a bias right ahead of a BatchNorm, whose gradient is zero up
    to rounding, within 1e-4 of the model's largest); the later steps'
    loss terms within rtol 1e-5; after the last step the model's
    trainable weights within 1e-5 of their scale plus 2 lr a step (Adam
    steps an element whose gradient is rounding by up to its learning
    rate either way), its state buffers within 1e-5 of their scale and
    its integers equal.  In the ``BATCHNORM`` families (where E[x^2] -
    E[x]^2 rounds by the order of its sums: on one process, UnSeg's
    statistics summed as two halves move its gradients by up to 1.6e-4
    of the largest) the first step's gradients are held within 1e-3 of
    the model's largest, the later steps' loss terms within rtol 1e-4
    (the gradient norms 1e-3) and the state buffers within 1e-4 of their
    scale (a running mean of zero-mean products: of the spread its
    variance gives) plus 2 lr a step, which a running mean inherits from
    the bias that feeds its BatchNorm."""
    from test_torch_variants import _AHEAD_OF_BN, _ZERO_MEAN_STATS, _rel_close

    got, ref = runs["ranks"][0]["families"][name], runs["ref"][name]
    bn = name.startswith(BATCHNORM)
    lr = runs["job"]["cfgs"][name]["optimizer"]["model"]["lr"]
    steps = len(ref["states"])
    _validate_equal(got["validate"], ref["validate"])
    if "data_init" in ref:
        for k, v in ref["data_init"].items():
            assert torch.equal(got["data_init"][k], v), k
    for step, (m_got, m_ref) in enumerate(zip(got["metrics"], ref["metrics"])):
        assert m_got["skipped"] == m_ref["skipped"] == 0.0
        assert set(m_got) == set(m_ref)
        for k in m_ref:
            rtol = 1e-4 if k.endswith("grad-norm") or (bn and step > 0) else 1e-5
            if bn and step > 0 and k.endswith("grad-norm"):
                rtol = 1e-3
            assert m_got[k] == pytest.approx(m_ref[k], rel=rtol, abs=1e-6), (step, k)
    assert set(got["grads"]) == set(ref["grads"])
    largest = max(float(g.abs().max()) for g in ref["grads"].values())
    for k, g in ref["grads"].items():
        _rel_close(got["grads"][k].numpy(), g.numpy(), 1e-3 if bn else 1e-4, k,
                   floor=largest if bn or k in _AHEAD_OF_BN else 0.0)
    final, want = got["states"][-1], ref["states"][-1]
    assert set(final) == set(want)
    assert torch.equal(final["generator"], want["generator"])     # the same draws
    for k, v in want.items():
        if not k.startswith("model.") or k.startswith("model.backbone."):
            continue
        if not v.is_floating_point():
            assert torch.equal(final[k], v), k
        elif k[len("model."):] in ref["grads"]:          # trainable
            tol = 1e-5 * float(v.abs().max()) + 2 * lr * steps
            assert float((final[k] - v).abs().max()) <= tol, k
        elif bn:
            scale = float(v.abs().max())
            if k[len("model."):] in _ZERO_MEAN_STATS:
                scale = max(scale, float(want[k[:-4] + "var"].abs().max().sqrt()))
            tol = 1e-4 * scale + 2 * lr * steps
            assert float((final[k] - v).abs().max()) <= tol, k
        else:
            _close(final[k].numpy(), v.numpy(), 1e-5)


@pytest.mark.parametrize("name", FAMILIES)
def test_ranks_hold_the_same_state_after_every_step(runs, name):
    ranks_hold_the_same_state(runs, name)


@pytest.mark.parametrize("name", FAMILIES)
def test_two_ranks_match_one_process(runs, name):
    ranks_match_one_process(runs, name)


def test_swav_queue_fills_from_the_global_batch(runs):
    """The queue's newest block is the strided subsample of the global
    [img; view] codes: equal on the ranks and to one process, and live."""
    name = "cluster_swav_cocostuff27"
    final = runs["ranks"][0]["families"][name]["states"][-1]
    want = runs["ref"][name]["states"][-1]
    assert int(final["model.swav_queue_n"]) == int(want["model.swav_queue_n"]) > 0
    _close(final["model.swav_queue"].numpy(), want["model.swav_queue"].numpy(), 1e-5)


def jax_case_matches(runs, key):
    """The ranks' summed gradients within 1e-4 of their scale of JAX's
    (a bias ahead of a BatchNorm to 1e-4 of the largest), the loss terms
    rtol 1e-5 (CLUB's and the margin's 1e-4) and the new state within
    ``tests/test_torch_variants.py``'s bars."""
    from test_torch_variants import _AHEAD_OF_BN, _ZERO_MEAN_STATS, _rel_close

    want = runs["jax"][key]
    cfg = runs["job"]["jax"][key]["cfg"]
    for r, out in enumerate(runs["ranks"]):
        got = out["jax"][key]
        for k, v in want["aux"].items():
            rtol = 1e-4 if k.startswith(("club-loss", "margin")) else 1e-5
            np.testing.assert_allclose(got["aux"][k], v, rtol=rtol, atol=1e-7, err_msg=k)
        assert set(got["grads"]) == set(want["grads"])
        largest = max(np.abs(w.numpy()).max() for w in want["grads"].values())
        for k, g in got["grads"].items():
            w = want["grads"][k].numpy()
            g = np.zeros_like(w) if g is None else g.numpy()
            _rel_close(g, w, 1e-4, (r, k), floor=largest if k in _AHEAD_OF_BN else 0.0)
        assert set(got["state"]) == set(want["state"])
        lr = float(cfg["optimizer"].get("club_enc", {}).get("lr", 0.0))
        for k, v in got["state"].items():
            w = want["state"][k].numpy()
            if k.startswith("club_enc."):
                np.testing.assert_allclose(v.numpy(), w, rtol=0,
                                           atol=max(1e-4 * np.abs(w).max(), 1e-3 * lr),
                                           err_msg=k)
            elif k in _ZERO_MEAN_STATS:
                spread = float(np.sqrt(np.abs(want["state"][k[:-4] + "var"].numpy()).max()))
                _rel_close(v.numpy(), w, 1e-4, k, floor=spread)
            else:
                _rel_close(v.numpy(), w, 1e-4, (r, k))


@pytest.mark.parametrize("key", sorted(JAX_CASES))
def test_two_ranks_match_jax_one_process(runs, key):
    jax_case_matches(runs, key)


@pytest.mark.parametrize("name", ["margin", "info_nce_random", "info_nce_cosine", "club",
                                  "jsd", "entropy"])
def test_loss_term_across_ranks_matches_jax(runs, name):
    import jax
    import jax.numpy as jnp
    from equss_tpu.losses import basic as jb

    t = runs["job"]["terms"][name]
    got = [out["terms"][name] for out in runs["ranks"]]
    if name == "margin":
        fn, args = (lambda o: jb.margin_ranking_loss(o, jnp.asarray(t["aug"]))), [t["ori"]]
    elif name.startswith("info_nce"):
        # JAX draws its negatives from key 0 (``loss_terms`` fed them)
        fn = lambda a, b: jb.info_nce_loss(jax.random.PRNGKey(0), a, b,  # noqa: E731
                                           **t["kwargs"])
        args = [t["x1"], t["x2"]]
    elif name == "club":
        fn, args = jb.club_loss, [t["x"], t["mu"], t["logvar"]]
    elif name == "jsd":
        fn, args = jb.jsd_loss, [t["p"], t["q"]]
    else:
        fn, args = jb.entropy_loss, [t["p"]]
    value, grads = jax.value_and_grad(fn, argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args])
    # CLUB's O(n d) form sums in another order (tests/test_torch_variants.py)
    rtol = 1e-4 if name == "club" else 1e-5
    assert sum(g["value"] for g in got) / WORLD == pytest.approx(float(value), rel=rtol)
    for i, g in enumerate(grads):
        _close(torch.cat([r["grads"][i] for r in got]).numpy(), np.asarray(g), 1e-5)
