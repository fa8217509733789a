"""The port's serving path (``equss_tpu_torch/serve.py``) and the
kernels' custom ops.

* ``build_predict_fn`` against the JAX package's ``build_predict_fn`` on
  ``tests/test_trainer.py::tiny_cfg`` with the JAX weights carried across
  (``params_from_jax``): both predictions equal, the bar
  ``tests/test_torch_valid.py`` holds the valid step's predictions to.
* The ``torch.export`` round trip (``export_predictor`` ->
  ``save_predictor`` -> ``load_predictor``) equal to the live predictor
  bit for bit on the CPU: a symbolic-batch artifact at two batch sizes,
  ``symbolic_batch="off"`` pinning the batch, uint8 input equal to
  float / 255, and ``export.platforms`` read as one device.
* A bf16 model on the kernel routes (attention at >= 512 tokens, PQ with
  ``use_pallas``) exports the ops ``equss::attention_qkv`` and
  ``equss::pq_assign`` themselves, and its artifact loads and predicts in
  a process that imports only ``equss_tpu_torch.ops``'s registrations.
* Each of the five custom ops passes ``torch.library.opcheck`` (schema,
  fake implementation, autograd registration) on CPU tensors, where its
  plain version runs, and on meta tensors, where only its fake
  implementation can: its CUDA implementation runs on the card only
  (``tests/test_torch_gpu.py``).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from equss_tpu import serve as jserve
from equss_tpu.parallel.mesh import make_mesh
from equss_tpu.train.trainer import Trainer as JTrainer
from equss_tpu_torch import serve
from equss_tpu_torch.convert import params_from_jax
from equss_tpu_torch.train.trainer import Trainer
from test_torch_checkpoint import _one_intra_op_thread  # noqa: F401 (autouse)
from test_trainer import tiny_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pair():
    """The JAX Trainer of ``tiny_cfg`` with its state, and the port's
    Trainer on the CPU with the same weights and probes."""
    cfg = tiny_cfg()
    jtr = JTrainer(cfg, mesh=make_mesh(1))
    ts = jax.device_get(jtr.init_state(jax.random.PRNGKey(0), img_hw=(16, 16)))
    tr = Trainer(cfg, device="cpu")
    tr.load_state_dict(params_from_jax(ts["params"], ts["model_state"], tr.model.cfg,
                                       probe_params=ts["probe_params"]))
    return jtr, ts, tr


@pytest.fixture(scope="module")
def artifact(pair, tmp_path_factory):
    """A symbolic-batch artifact of the port's trainer, saved and loaded."""
    _, _, tr = pair
    exported = serve.export_predictor(tr, (16, 16))
    path = serve.save_predictor(exported, str(tmp_path_factory.mktemp("art") / "model.pt2"))
    return exported, serve.load_predictor(path)


def _images(b, seed):
    return np.random.RandomState(seed).rand(b, 16, 16, 3).astype(np.float32)


def test_predict_fn_equals_jax(pair):
    jtr, ts, tr = pair
    jpredict = jax.jit(jserve.build_predict_fn(jtr, ts))
    predict = serve.build_predict_fn(tr)
    for seed in range(3):
        img = _images(4, seed)
        want = jpredict(img)
        got = predict(torch.from_numpy(img))
        assert set(got) == set(want) == {"cluster_preds", "linear_preds"}
        for k in want:
            assert got[k].dtype == torch.int32 and tuple(got[k].shape) == (4, 16, 16)
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_export_round_trip_equals_live(pair, artifact):
    _, _, tr = pair
    exported, predict = artifact
    live = serve.build_predict_fn(tr)
    img = torch.from_numpy(_images(2, 10))
    out, ref = predict(img), live(img)
    assert set(out) == {"cluster_preds", "linear_preds"}
    for k in out:
        assert out[k].dtype == torch.int32 and tuple(out[k].shape) == (2, 16, 16)
        assert torch.equal(out[k], ref[k]), k


def test_export_symbolic_batch_serves_two_sizes(pair, artifact):
    _, _, tr = pair
    exported, predict = artifact
    img = [n for n in exported.graph.nodes if n.op == "placeholder"][-1].meta["val"]
    assert not isinstance(img.shape[0], int)            # symbolic
    live = serve.build_predict_fn(tr)
    for b in (1, 3):
        x = torch.from_numpy(_images(b, 20 + b))
        out, ref = predict(x), live(x)
        for k in ref:
            assert tuple(out[k].shape) == (b, 16, 16)
            assert torch.equal(out[k], ref[k])


def test_export_symbolic_batch_off_pins_batch(pair, tmp_path):
    _, _, tr = pair
    exported = serve.export_predictor(tr, (16, 16), batch_size=3, symbolic_batch="off")
    img = [n for n in exported.graph.nodes if n.op == "placeholder"][-1].meta["val"]
    assert tuple(img.shape) == (3, 16, 16, 3)
    predict = serve.load_predictor(serve.save_predictor(exported, str(tmp_path / "m.pt2")))
    x = torch.from_numpy(_images(3, 30))
    ref = serve.build_predict_fn(tr)(x)
    out = predict(x)
    for k in ref:
        assert torch.equal(out[k], ref[k])
    with pytest.raises(Exception):
        predict(torch.from_numpy(_images(2, 31)))
    with pytest.raises(ValueError):
        serve.export_predictor(tr, (16, 16), symbolic_batch="x")


def test_uint8_input_equals_float(artifact):
    _, predict = artifact
    u8 = np.random.RandomState(1).randint(0, 256, (2, 16, 16, 3), np.uint8)
    out_u8 = predict(u8)
    out_f = predict(u8.astype(np.float32) / 255.0)
    for k in out_f:
        assert torch.equal(out_u8[k], out_f[k])


def test_export_platforms_is_one_device(pair, tmp_path):
    _, _, tr = pair
    assert serve.export_device("cpu") == "cpu"
    assert serve.export_device(" cuda ") == "cuda"
    assert serve.export_device(["cpu"]) == "cpu"
    assert serve.export_device(None) is None
    for many in ("cuda,cpu", ["cuda", "cpu"]):
        with pytest.raises(NotImplementedError, match="one device"):
            serve.export_device(many)
    with pytest.raises(ValueError, match="cuda or cpu"):
        serve.export_device("tpu")
    with pytest.raises(ValueError, match="trainer runs on cpu"):
        serve.export_predictor(tr, (16, 16), platforms="cuda")
    with pytest.raises(NotImplementedError):
        serve.build_sharded_predict_fn(tr)


_LOAD_ONLY_OPS = """
import sys, torch
from equss_tpu_torch.serve import load_predictor
predict = load_predictor(sys.argv[1])
out = predict(torch.load(sys.argv[2]))
torch.save(out, sys.argv[3])
bad = [m for m in sys.modules if m.startswith(("equss_tpu_torch.models", "equss_tpu_torch.train",
                                               "jax", "equss_tpu."))]
assert not bad, bad
print("ok")
"""


def test_kernel_routes_export_their_ops_and_load_without_the_model(tmp_path):
    """bf16 vit_micro at 184^2 (23 x 23 patches + cls = 530 tokens, over
    the attention kernel's 512) with ``use_pallas``: the graph calls
    ``equss::attention_qkv`` (2 blocks) and ``equss::pq_assign`` (1), the
    artifact equals the live predictor bit for bit, and it predicts in a
    process that imports no model code."""
    cfg = tiny_cfg()
    cfg["model"]["pretrained"]["precision"] = "bf16"
    cfg["model"]["vq"].update(use_pallas=True, assign_precision="bf16", num_codebooks=[128])
    tr = Trainer(cfg, device="cpu")
    exported = serve.export_predictor(tr, (184, 184), batch_size=2, symbolic_batch="off")
    targets = [str(n.target) for n in exported.graph.nodes if n.op == "call_function"]
    assert targets.count("equss.attention_qkv.default") == 2
    assert targets.count("equss.pq_assign.default") == 1
    path = serve.save_predictor(exported, str(tmp_path / "model.pt2"))
    img = torch.from_numpy(np.random.RandomState(4).rand(2, 184, 184, 3).astype(np.float32))
    torch.save(img, tmp_path / "img.pt")
    res = subprocess.run([sys.executable, "-c", _LOAD_ONLY_OPS, path, str(tmp_path / "img.pt"),
                          str(tmp_path / "out.pt")], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
    out = torch.load(tmp_path / "out.pt")
    ref = serve.build_predict_fn(tr)(img)
    for k in ref:
        assert torch.equal(out[k], ref[k]), k


def _op_cases():
    """(op, args) of each custom op on small CPU operands."""
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn((2, 10, 3 * 2 * 64), generator=g).bfloat16()
    q, k, v = (torch.randn((2, 10, 2, 32), generator=g).bfloat16() for _ in range(3))
    x, y = (torch.randn((6, 16), generator=g).bfloat16() for _ in range(2))
    scale, bias = 1 + 0.1 * torch.randn(16, generator=g), 0.1 * torch.randn(16, generator=g)
    z = torch.randn((12, 4, 8), generator=g)
    cb = torch.randn((4, 16, 8), generator=g)
    zm, zs = torch.randn((4, 8), generator=g), torch.rand((4, 8), generator=g) + 0.5
    ops = torch.ops.equss
    return {
        "attention_qkv": (ops.attention_qkv.default, (qkv, 2, 0.125, 7)),
        "attention": (ops.attention.default, (q, k, v, 0.2)),
        "layernorm": (ops.layernorm.default, (x, scale, bias, 1e-6)),
        "add_layernorm": (ops.add_layernorm.default, (x, y, scale, bias, 1e-6)),
        "pq_assign_l2": (ops.pq_assign.default, (z, cb, cb, None, None, "l2", False)),
        "pq_assign_none": (ops.pq_assign.default, (z, cb, cb, None, None, "none", True)),
        "pq_assign_z_trainable": (ops.pq_assign.default, (z, cb, cb, zm, zs, "z_trainable", True)),
    }


@pytest.mark.parametrize("name", sorted(_op_cases()))
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_custom_op_opcheck(name, device):
    import equss_tpu_torch.ops  # noqa: F401 - the registrations

    op, args = _op_cases()[name]
    args = tuple(a.to(device) if isinstance(a, torch.Tensor) else a for a in args)
    torch.library.opcheck(op, args)
    outs = op(*args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert all(o.device.type == device for o in outs)
    if name == "attention_qkv":
        assert tuple(outs[0].shape) == (2, 10, 128) and outs[0].dtype == torch.bfloat16
    if name.startswith("pq_assign"):
        assert [tuple(o.shape) for o in outs] == [(12, 4), (12, 4, 8), (12, 4, 8)]
        assert [o.dtype for o in outs] == [torch.int32, torch.float32, torch.float32]


def test_ctypes_wrappers_stand_in_for_the_custom_ops():
    """``tools/ctypes_ab.py`` (the wrappers of the custom-op dispatch A/B)
    takes the model's attention and PQ calls inside its block and gives
    them back after; on CPU tensors its wrappers run the plain versions,
    so the bf16 kernel-route forward is the same either way."""
    from unittest import mock

    from equss_tpu_torch.data.transforms import normalize_images
    from equss_tpu_torch.models import vit
    from equss_tpu_torch.ops import quantizer
    from equss_tpu_torch.tools import ctypes_ab

    cfg = tiny_cfg()
    cfg["model"]["pretrained"]["precision"] = "bf16"
    cfg["model"]["vq"].update(use_pallas=True, assign_precision="bf16", num_codebooks=[128])
    model = Trainer(cfg, device="cpu").model
    img = normalize_images(torch.from_numpy(
        np.random.RandomState(5).rand(1, 184, 184, 3).astype(np.float32)))
    with torch.no_grad():
        ref = model(img)
        with ctypes_ab.ctypes_wrappers(), \
                mock.patch.object(ctypes_ab.attention, "attention_qkv_reference",
                                  wraps=ctypes_ab.attention.attention_qkv_reference) as attn, \
                mock.patch.object(ctypes_ab.pq, "pq_assign_reference",
                                  wraps=ctypes_ab.pq.pq_assign_reference) as assign:
            assert vit.attention_qkv is ctypes_ab.attention_qkv_ctypes
            assert quantizer.pq_assign is ctypes_ab.pq_assign_ctypes
            out = model(img)
    assert attn.call_count == 2 and assign.call_count == 1
    assert vit.attention_qkv is not ctypes_ab.attention_qkv_ctypes
    assert quantizer.pq_assign is not ctypes_ab.pq_assign_ctypes
    for k in ("indices", "z_q"):
        assert torch.equal(out[k], ref[k]), k
