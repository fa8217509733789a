"""The port's config loader and CLI train job.

* ``core/config.py``: every file in ``configs/`` loads and resolves to
  the dict the JAX package's loader gives, before and after the same
  dotted overrides; ``_parse_value`` reads override values as the JAX
  package's does, malformed YAML kept as text; a dict config with
  ``${...}`` strings and ``chip_smoke.with_overrides`` resolves with
  PyYAML hidden.
* ``cli.main`` on ``configs/smoke_synthetic.yaml`` (vit_micro, 32^2) on
  the CPU with ``eval.final_crf`` on and a small ``eval.crf``: train ->
  checkpoints on each new best -> final and final CRF evaluations logged
  in ``metrics.jsonl``; an eval-only resume on that checkpoint directory
  reproduces ``final_Cluster_mIoU`` within 1e-6 (as
  ``tests/test_registry_cli.py`` holds the JAX CLI); a ``resume.mode:
  train`` run from the step-2 checkpoint logs exactly what the
  uninterrupted run logged after step 2 and returns the same final
  weights.
* The own-data path through ``cli.main`` on the CPU, vit_micro on a
  miniature COCO-Stuff corpus: ``crop`` (five-crops) -> ``knn`` (the
  neighbour cache the train split's positives come from) -> ``pack``
  (both splits) -> ``train`` on the files (from the pack) -> ``export``
  of the run's checkpoint -> ``load_predictor``, whose predictions equal
  the live predictor's on that checkpoint.  The train job's first
  batches (train with positives, val) equal the JAX package's
  ``_make_batch_fns`` on the same corpus and seed.
* Without ``device`` the jobs that run a model take CUDA and raise
  without it; multi-process runs, ``train.profile_dir`` and
  ``build_sharded_predict_fn`` raise ``NotImplementedError``.
"""
import builtins
import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch

from equss_tpu.core import config as jconfig
from equss_tpu_torch import cli
from equss_tpu_torch.core import config
from test_torch_checkpoint import _one_intra_op_thread  # noqa: F401 (autouse)


CONFIGS = sorted(glob.glob("configs/*.yaml"))
OVERRIDES = ["train.max_epochs=3", "model.vq.num_pq=[32]", "seed=7",
             "eval.crf={max_iter: 2, block: 64}", "dataset.synthetic=true",
             "optimizer.model.lr=1.0e-4", "resume.checkpoint=null", "save_dir=out/x_1",
             "data_dir=/data/${dataset_name}"]


@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_config_loader_matches_jax(path):
    raw = config.load_config(path)
    assert raw == jconfig.load_config(path)
    assert config.resolve_config(raw) == jconfig.resolve_config(raw)
    mine = config.resolve_config(config.override_config_by_cli(raw, OVERRIDES))
    want = jconfig.resolve_config(jconfig.override_config_by_cli(raw, OVERRIDES))
    assert mine == want


def test_parse_value_reads_yaml_scalars_and_flow():
    values = ["1", "-3", "1_000", "0x1F", "1.5", "1.0e-06", "3.0e-4", "1e-3", ".5",
              "true", "off", "null", "", "abc", "[1, 2, 3]", "[a, 'b c', [1, 2.5]]",
              "{max_iter: 2, block: 64}", "'quoted'", "x: 1", "configs/a.yaml",
              "${data_dir}/x", "[1, 2", "{a: 1", "'open", "a: b: c"]
    for v in values:
        got, want = config._parse_value(v), jconfig._parse_value(v)
        assert (got, type(got)) == (want, type(want)), v
    assert config._parse_value("[1, 2") == "[1, 2"


def test_dict_config_resolves_without_yaml(monkeypatch):
    import chip_smoke

    real_import = builtins.__import__

    def no_yaml(name, *args, **kwargs):
        if name == "yaml":
            raise ImportError("no PyYAML")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    cfg = chip_smoke.with_overrides(chip_smoke.PQGO_COCOSTUFF27,
                                    {"dataset.synthetic": True, "train.max_epochs": 1,
                                     "resume.mode": "eval"})
    cfg = config.resolve_config(cfg)
    assert cfg["resume"] == {"mode": "eval"}
    assert chip_smoke.PQGO_COCOSTUFF27["train"]["max_epochs"] == 15
    assert cfg["dataset"]["train"]["data_dir"] == "../Datasets/cocostuff27"
    assert cfg["dataset"]["val"]["model_type"] == "vit_small"
    assert cfg["dataset"]["synthetic"] is True and cfg["train"]["max_epochs"] == 1


def _records(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _main(tmp_path, *extra):
    before = set(glob.glob(str(tmp_path / "runs" / "*")))
    result = cli.main(["--config", "configs/smoke_synthetic.yaml", "--debug",
                       f"save_dir={tmp_path / 'runs'}", "device=cpu",
                       "dataset.synthetic_batches=4", "train.print_interval_iters=1",
                       "train.valid_interval_iters=2", "eval.final_crf=true",
                       "eval.crf={max_iter: 2, block: 256}", *extra])
    (run_dir,) = set(glob.glob(str(tmp_path / "runs" / "*"))) - before
    return result, run_dir


def _without_time(records):
    return [{k: v for k, v in r.items() if k != "iter_time"} for r in records]


def test_cli_train_checkpoint_final_crf_and_resume(tmp_path):
    result, run_dir = _main(tmp_path)
    records = _records(run_dir)
    ckpt_dir = os.path.join(run_dir, "ckpt")
    saved = sorted(int(s) for s in os.listdir(ckpt_dir))
    assert saved and saved[0] == 2 and set(saved) <= {2, 4}
    best_iter = result["best"]["iter"]
    assert best_iter == saved[-1]
    final = [r for r in records if "final_Cluster_mIoU" in r]
    crf = [r for r in records if "final_crf_Cluster_mIoU" in r]
    assert len(final) == len(crf) == 1
    assert final[0]["step"] == crf[0]["step"] == best_iter
    assert all(0.0 <= crf[0][f"final_crf_{k}"] <= 100.0
               for k in ("Cluster_mIoU", "Cluster_Accuracy", "Linear_mIoU", "Linear_Accuracy"))
    assert [r["step"] for r in records if "loss" in r] == [1, 2, 3, 4]

    evald, _ = _main(tmp_path, f"resume.checkpoint={ckpt_dir}", "resume.mode=eval")
    assert abs(evald["best"]["Cluster_mIoU"] - final[0]["final_Cluster_mIoU"]) < 1e-6
    assert abs(evald["best"]["crf_Cluster_mIoU"] - crf[0]["final_crf_Cluster_mIoU"]) < 1e-6

    from_step2 = tmp_path / "from_step2"
    shutil.copytree(os.path.join(ckpt_dir, "2"), from_step2 / "2")
    resumed_result, resumed_dir = _main(tmp_path, f"resume.checkpoint={from_step2}",
                                        "resume.mode=train")
    resumed = [r for r in _records(resumed_dir) if "final_Cluster_mIoU" not in r
               and "final_crf_Cluster_mIoU" not in r]
    after = [r for r in records if r["step"] > 2 and "final_Cluster_mIoU" not in r
             and "final_crf_Cluster_mIoU" not in r]
    assert _without_time(resumed) == _without_time(after)
    # both runs return the weights after step 4, not the best ones reloaded
    assert set(resumed_result["state"]) == set(result["state"])
    for k, v in result["state"].items():
        assert torch.equal(resumed_result["state"][k], v), k


def test_cli_defaults_to_cuda_and_raises_on_what_is_not_ported(tmp_path, monkeypatch):
    from equss_tpu_torch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = ["--config", "configs/smoke_synthetic.yaml", "--debug", f"save_dir={tmp_path}"]
    for job in ("train", "knn", "export"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main([job, *base, f"export.path={tmp_path / 'm.pt2'}"])
    with pytest.raises(NotImplementedError, match="multi-process"):
        cli.main([*base, "device=cpu", "dist.num_processes=2"])
    with pytest.raises(NotImplementedError, match="profile_dir"):
        cli.main([*base, "device=cpu", f"train.profile_dir={tmp_path / 'prof'}"])
    with pytest.raises(NotImplementedError, match="build_sharded_predict_fn"):
        serve.build_sharded_predict_fn(None)


def _corpus_args(root, tmp_path):
    """vit_micro on the COCO-Stuff corpus at ``root``: the train split the
    five-crop corpus at 16^2 with 3 neighbours, val the val images."""
    return ["--config", "configs/smoke_synthetic.yaml", "--debug", "device=cpu",
            "dataset.synthetic=false", f"data_dir={root}", f"save_dir={tmp_path / 'runs'}",
            "dataset.train={model_type: vit_micro, crop_type: five, crop_ratio: 0.5, res: 16, "
            "num_neighbors: 3}",
            "dataset.train.data_dir=${data_dir}", "dataset.train.dataset_name=${dataset_name}",
            "dataset.val={model_type: vit_micro, crop_type: null, res: 16}",
            "dataset.val.data_dir=${data_dir}", "dataset.val.dataset_name=${dataset_name}",
            "dataloader.train={batch_size: 4, num_workers: 0}",
            "dataloader.val={batch_size: 2, num_workers: 0}",
            "train.print_interval_iters=1", "train.valid_interval_iters=4"]


def test_cli_own_data_path_end_to_end(tmp_path):
    from equss_tpu import cli as jcli
    from equss_tpu_torch import serve
    from equss_tpu_torch.core.checkpoint import CheckpointManager
    from equss_tpu_torch.train.trainer import Trainer
    from test_torch_data import assert_items_equal, write_coco

    root = write_coco(tmp_path / "coco", n_train=6, n_val=4)
    args = _corpus_args(root, tmp_path)
    crops = cli.main(["crop", *args])
    assert len(os.listdir(os.path.join(crops, "img", "train"))) == 30
    nns_path = cli.main(["knn", *args])
    assert os.path.basename(nns_path) == "nns_vit_micro_cocostuff27_train_five_224.npz"
    nns = np.load(nns_path)["nns"]
    assert nns.shape == (30, 30)
    np.testing.assert_array_equal(nns[:, 0], np.arange(30))
    packs = cli.main(["pack", *args])
    assert [os.path.basename(p) for p in packs] == [
        "pack_cocostuff27_train_five_0.5_16.bin", "pack_cocostuff27_val_None_16.bin"]

    cfg, _ = config.prepare_config(args)
    train_b, val_b, res = cli._make_batch_fns(cfg)
    assert cfg["_iter_per_epoch"] == 7 and res == 16
    jcfg, _ = jconfig.prepare_config(args)
    jtrain_b, jval_b, _ = jcli._make_batch_fns(jcfg)
    assert_items_equal(next(iter(train_b(0))), next(iter(jtrain_b(0))))
    assert_items_equal(next(iter(val_b())), next(iter(jval_b())))
    assert "img_pos" in next(iter(train_b(0)))

    result = cli.main(args)
    (run_dir,) = glob.glob(str(tmp_path / "runs" / "*"))
    records = _records(run_dir)
    assert [r["step"] for r in records if "loss" in r] == list(range(1, 8))
    assert any("final_Cluster_mIoU" in r for r in records)
    ckpt = os.path.join(run_dir, "ckpt")
    assert result["best"]["iter"] in (4, 7)

    out = cli.main(["export", *args, f"resume.checkpoint={ckpt}",
                    f"export.path={tmp_path / 'model.pt2'}", "export.batch_size=2",
                    "export.platforms=cpu"])
    predict = serve.load_predictor(out)
    tr = Trainer(cfg, device="cpu")
    tr.load_train_state(CheckpointManager(ckpt).restore(), resume_training=False)
    live = serve.build_predict_fn(tr)
    img = next(iter(val_b()))["img"]
    got, want = predict(img), live(torch.from_numpy(img))
    assert set(got) == {"cluster_preds", "linear_preds"}
    for k in want:
        assert torch.equal(got[k], want[k]), k
