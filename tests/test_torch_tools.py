"""The port's tools (``equss_tpu_torch/tools``) and ``testing.py`` against
the JAX package's (``tools/``, ``equss_tpu/testing.py``).

* ``flops``: every count equal to ``tools/flops.py``'s for ViT-S/8 and
  ViT-B/8 at 224^2 (46.69 GFLOP/img for ViT-S/8), ``mfu`` against the
  H100's dense bf16 peak, and ``chip_smoke.py``'s peaks and profiler the
  tools' own objects.
* ``tiny_pqgo_cfg`` equal to JAX's.
* Each benchmark tool once with ``--device cpu`` at tiny shapes
  (vit_micro, 32^2, b = 2; the config is ``tiny_pqgo_cfg`` written to a
  YAML file, with dataset sections where the tool reads a corpus), as
  ``tests/test_tools_bench.py`` runs the JAX tools: each prints its JSON
  result line with its keys; ``bench_pq_kernel``'s plain route agrees with
  the library route, ``bench_serving``'s artifacts with the live
  predictor.
* Without ``--device`` each tool takes the card, and raises here.
"""
import importlib
import importlib.util
import json
import os

import numpy as np
import pytest
import torch
import yaml

from equss_tpu.testing import tiny_pqgo_cfg as jtiny_pqgo_cfg
from equss_tpu_torch.testing import tiny_pqgo_cfg
from equss_tpu_torch.tools import flops
from test_torch_checkpoint import _one_intra_op_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--batch", "2", "--res", "32", "--device", "cpu"]


def _jax_flops():
    spec = importlib.util.spec_from_file_location("jax_tools_flops",
                                                  os.path.join(REPO, "tools", "flops.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_flops_equal_the_jax_tools_counts():
    jf = _jax_flops()
    for model, d in (("vit_small", 384), ("vit_base", 768)):
        assert flops.equss_inference_flops(model) == jf.equss_inference_flops(model), model
        assert flops.vit_backbone_flops(d=d) == jf.vit_backbone_flops(d=d), model
        assert flops.head_flops(d=d) == jf.head_flops(d=d), model
    assert flops.pq_flops() == jf.pq_flops()
    assert round(flops.equss_inference_flops("vit_small") / 1e9, 2) == 46.69
    assert flops.mfu(1000.0, 1e9) == pytest.approx(1e12 / 989e12)
    assert flops.PEAK_BF16_FLOPS == 989e12


def test_chip_smoke_takes_the_tools_peaks_and_profiler():
    import chip_smoke
    from equss_tpu_torch.tools import profile_forward

    assert (chip_smoke.PEAK_BF16_FLOPS, chip_smoke.PEAK_F32_FLOPS, chip_smoke.PEAK_BYTES) == (
        flops.PEAK_BF16_FLOPS, flops.PEAK_F32_FLOPS, flops.PEAK_BYTES)
    assert chip_smoke.device_profile is profile_forward.device_profile
    assert chip_smoke.main_config("exact") == profile_forward.serving_config("vit_small", "exact")


@pytest.mark.parametrize("num_classes", [4, 27])
def test_tiny_pqgo_cfg_equals_jax(num_classes):
    assert tiny_pqgo_cfg(num_classes) == jtiny_pqgo_cfg(num_classes)


def _tiny_config(tmp_path, with_data=False):
    """``tiny_pqgo_cfg(27)`` as a YAML file; ``with_data`` adds the
    COCO-Stuff dataset sections at 32^2 (vit_micro, 3 neighbours), b = 2,
    and a one-iteration CRF."""
    cfg = tiny_pqgo_cfg(27)
    if with_data:
        common = {"data_dir": "${data_dir}", "dataset_name": "${dataset_name}",
                  "model_type": "vit_micro", "loader_crop_type": "center", "res": 32}
        cfg.update(
            dataset_name="cocostuff27", data_dir="unset",
            wandb={"project": "equss_tpu", "mode": "offline", "name": "tiny"},
            dataset={"train": {**common, "crop_type": "five", "crop_ratio": 0.5,
                               "num_neighbors": 3},
                     "val": {**common, "crop_type": None}},
            dataloader={"train": {"batch_size": 2, "num_workers": 0},
                        "val": {"batch_size": 2, "num_workers": 0}})
        cfg["eval"]["crf"] = {"max_iter": 1}
    path = tmp_path / ("tiny_data.yaml" if with_data else "tiny.yaml")
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _run(name, argv, capsys):
    """The tool's ``main(argv)``: its returned result and its last printed
    JSON line."""
    out = importlib.import_module(f"equss_tpu_torch.tools.{name}").main(argv)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return out, line


def test_bench_train_step_on_the_cpu(tmp_path, capsys):
    out, line = _run("bench_train_step", [*TINY, "--windows", "1", "--iters", "1",
                                          "--config", _tiny_config(tmp_path)], capsys)
    assert line == out
    assert out["tool"] == "bench_train_step" and out["device"] == "cpu"
    assert out["ms_per_step_best"] > 0 and out["img_per_sec_best"] > 0
    assert (out["ln_stats"], out["route"], out["batch"], out["res"]) == ("f32", "stock", 2, 32)


def test_profile_forward_on_the_cpu(capsys):
    out, line = _run("profile_forward", ["--model", "vit_micro", *TINY, "--steps", "1",
                                         "--top", "5"], capsys)
    assert line == out
    assert out["tool"] == "profile_forward" and out["device"] == "cpu"
    assert out["cpu_ms_per_step"] > 0 and 0 < len(out["kernels"]) <= 5
    assert (out["model"], out["batch"], out["res"]) == ("vit_micro", 2, 32)


@pytest.mark.parametrize("mode", [[], ["--exact", "--no-zq"]])
def test_bench_pq_kernel_on_the_cpu(mode, capsys):
    out = importlib.import_module("equss_tpu_torch.tools.bench_pq_kernel").main(
        ["--n", "96", "--device", "cpu", *mode])
    rows = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.startswith("{")]
    assert rows == out["rows"] and len(rows) == 1
    row = rows[0]
    assert row["kernel_ms"] > 0 and row["library_ms"] > 0 and row["body"] == "narrow"
    assert row["want_zq"] == (not mode)
    # the plain version computes the same first minimum as cdist's
    assert row["index_agreement"] == (1.0 if mode else pytest.approx(1.0, abs=0.01))


def test_bench_serving_on_the_cpu(tmp_path, capsys):
    out, line = _run("bench_serving", [*TINY, "--config", _tiny_config(tmp_path)], capsys)
    assert line == out
    assert set(out) >= {"live", "symbolic_batch=auto", "symbolic_batch=off"}
    for mode in ("auto", "off"):
        row = out[f"symbolic_batch={mode}"]
        assert row["img_per_sec"] > 0 and row["ms_per_call"] > 0
        assert row["pixel_agreement_vs_live"] == {"cluster_preds": 1.0, "linear_preds": 1.0}
    assert out["symbolic_batch=off"]["input_shape"] == "(2, 32, 32, 3)"
    assert out["symbolic_batch=auto"]["input_shape"] != "(2, 32, 32, 3)"


def test_bench_pipeline_on_the_cpu(tmp_path, capsys):
    out, line = _run("bench_pipeline", [*TINY, "--n", "4", "--epochs", "1",
                                        "--config", _tiny_config(tmp_path)], capsys)
    assert line == out
    assert set(out["img_per_sec"]) == {"pil", "native", "pack"}
    assert all(v > 0 for v in out["img_per_sec"].values())
    assert out["h2d_mb_per_step"] == {"pil": 0.0, "native": 0.0, "pack": 0.0}
    assert out["pack_build_seconds"] > 0


def test_e2e_demo_on_the_cpu(tmp_path, capsys):
    out, line = _run("e2e_demo", ["--device", "cpu", "--n-train", "4", "--n-val", "2",
                                  "--root", str(tmp_path / "e2e"),
                                  "--config", _tiny_config(tmp_path, with_data=True)], capsys)
    assert line == out and out["e2e"] == "ok"
    assert list(out["timings_s"]) == ["corpus", "crop", "knn", "pack", "train", "final_crf",
                                      "export"]
    assert {"crf_Cluster_mIoU", "Cluster_mIoU"} <= set(out["final"])
    assert all(np.isfinite(v) for v in out["final"].values())
    assert out["export"]["ckpts"] == 1
    assert not os.path.exists(tmp_path / "e2e")


@pytest.mark.parametrize("name", ["profile_forward", "bench_train_step", "bench_serving",
                                  "bench_pq_kernel", "bench_pipeline", "e2e_demo"])
def test_tools_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tools would run on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        importlib.import_module(f"equss_tpu_torch.tools.{name}").main([])
