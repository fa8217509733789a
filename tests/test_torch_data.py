"""The port's data layer vs the JAX package's, on miniature corpora in
the datasets' on-disk layouts written from a numpy seed.

Bit-equal to ``equss_tpu.data``: the host transforms; every dataset
class's items (COCO-Stuff 27/15/3, the cropped corpus, Cityscapes,
Potsdam, Pascal) under center, none and random loader crops with the
same per-item RandomState; ``UnSegData.batches`` with kNN positives,
serial against 2 decode workers against 2 producers, and the native
decode path against PIL; the crop job's decoded outputs; ``pack_dataset``
+ ``PackedDataset``, and a pack written by one package read by the
other.  The native loader (``native/imageloader.cpp`` built by g++ into
the port's ``_build/``) against PIL.

The kNN job: ``extract_pooled_features`` against JAX's on vit_micro with
the JAX weights carried across by ``convert.params_from_jax``, within
1e-4 (the class ``tests/test_vit.py`` pins for dense features);
``precompute_knns`` gives JAX's neighbours wherever the gap between
neighbours exceeds 1e-4, and every image is its own nearest.
"""
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from equss_tpu.data import cache as jcache
from equss_tpu.data import datasets as jdatasets
from equss_tpu.data import jobs as jjobs
from equss_tpu.data import pipeline as jpipeline
from equss_tpu.data import transforms as jtransforms
from equss_tpu_torch.data import cache, datasets, jobs, native_loader, pipeline, transforms
from test_torch_checkpoint import _one_intra_op_thread  # noqa: F401 (autouse)


def write_coco(root, sizes=((37, 43), (29, 61)), n_train=6, n_val=4, seed=0):
    """A COCO-Stuff-style corpus (images/, annotations/, curated/ lists)
    of random JPEG images and fine labels with a 255 ignore corner."""
    rng = np.random.RandomState(seed)
    for split, n in (("train2017", n_train), ("val2017", n_val)):
        for sub in ("images", "annotations", "curated"):
            os.makedirs(os.path.join(root, sub, split))
        ids = []
        for i in range(n):
            img_id = f"{split[:-4]}_{i:06d}"
            ids.append(img_id)
            h, w = sizes[i % len(sizes)]
            Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(
                os.path.join(root, "images", split, img_id + ".jpg"))
            lbl = rng.randint(0, 182, (h, w), np.uint8)
            lbl[:5, :5] = 255
            Image.fromarray(lbl).save(os.path.join(root, "annotations", split, img_id + ".png"))
        for name in ("Coco164kFull_Stuff_Coarse.txt", "Coco164kFull_Stuff_Coarse_7.txt",
                     "Coco164kFew_Stuff_6.txt"):
            with open(os.path.join(root, "curated", split, name), "w") as f:
                f.write("\n".join(ids) + "\n")
    return str(root)


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    return write_coco(tmp_path_factory.mktemp("coco"))


@pytest.fixture(scope="module")
def other_roots(tmp_path_factory):
    """Cityscapes, Potsdam and Pascal corpora, 3 items each."""
    from scipy.io import savemat

    rng = np.random.RandomState(1)
    city = tmp_path_factory.mktemp("cityscapes")
    for q in ("leftImg8bit", "gtFine"):
        os.makedirs(city / q / "train" / "aachen")
    for i in range(3):
        stem = f"aachen_{i:06d}_000019"
        Image.fromarray(rng.randint(0, 255, (24, 48, 3), np.uint8)).save(
            city / "leftImg8bit" / "train" / "aachen" / f"{stem}_leftImg8bit.png")
        Image.fromarray(rng.randint(0, 34, (24, 48), np.uint8)).save(
            city / "gtFine" / "train" / "aachen" / f"{stem}_gtFine_labelIds.png")
    potsdam = tmp_path_factory.mktemp("potsdam")
    os.makedirs(potsdam / "imgs")
    os.makedirs(potsdam / "gt")
    for i in range(3):
        savemat(str(potsdam / "imgs" / f"t{i}.mat"),
                {"img": rng.randint(0, 255, (30, 30, 4)).astype(np.uint8)})
        if i != 1:          # item 1 has no ground truth: all ignore
            savemat(str(potsdam / "gt" / f"t{i}.mat"),
                    {"gt": rng.randint(0, 6, (30, 30)).astype(np.uint8)})
    (potsdam / "labelled_train.txt").write_text("t0\nt1\nt2\n")
    voc = tmp_path_factory.mktemp("pascal")
    for sub in ("JPEGImages", "SegmentationClass", "ImageSets/Segmentation"):
        os.makedirs(voc / sub)
    pal = np.zeros(768, np.uint8)
    pal[:63] = np.arange(63)
    for i in range(3):
        Image.fromarray(rng.randint(0, 255, (33, 41, 3), np.uint8)).save(
            voc / "JPEGImages" / f"s{i}.jpg")
        lbl = rng.randint(0, 21, (33, 41)).astype(np.uint8)
        lbl[:4] = 255
        im = Image.fromarray(lbl, "P")
        im.putpalette(pal)
        im.save(voc / "SegmentationClass" / f"s{i}.png")
    (voc / "ImageSets" / "Segmentation" / "train.txt").write_text("s0\ns1\ns2\n")
    return {"cityscapes": str(city), "potsdam": str(potsdam), "pascal": str(voc)}


def assert_items_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def assert_batches_equal(xs, ys):
    xs, ys = list(xs), list(ys)
    assert len(xs) == len(ys)
    for a, b in zip(xs, ys):
        assert_items_equal(a, b)


# ---------------------------------------------------------------- transforms

@pytest.mark.parametrize("name", ["resize_shorter", "center_crop", "random_crop", "load_image",
                                  "prepare_image", "load_label", "five_crop", "random_crops"])
def test_host_transforms_equal_jax(name, coco_root):
    rng = np.random.RandomState(3)
    arr = rng.randint(0, 255, (29, 47, 3), np.uint8)
    img = Image.fromarray(arr)
    path = os.path.join(coco_root, "images", "train2017", "train_000001.jpg")
    lbl_path = os.path.join(coco_root, "annotations", "train2017", "train_000001.png")

    def both(fn_name, *args, **kw):
        return (getattr(transforms, fn_name)(*args, **kw),
                getattr(jtransforms, fn_name)(*args, **kw))

    if name == "resize_shorter":
        pairs = [tuple(np.asarray(x) for x in both("resize_shorter_np", img, r))
                 for r in (15, 20, (7, 9), 64)]
    elif name == "center_crop":
        pairs = [both("center_crop_np", arr, s) for s in (5, 20, 40)]
    elif name == "random_crop":
        pairs = [(transforms.random_crop_np(arr, 16, np.random.RandomState(s)),
                  jtransforms.random_crop_np(arr, 16, np.random.RandomState(s))) for s in range(4)]
    elif name == "load_image":
        pairs = [both("load_image", path, r, ct) for r in (16, 21) for ct in ("center", "none")]
    elif name == "prepare_image":
        pairs = [(transforms.prepare_image(img, 16, "random", np.random.RandomState(5)),
                  jtransforms.prepare_image(img, 16, "random", np.random.RandomState(5))),
                 both("prepare_image", img, 16, "random", crop_coords=(2, 7)),
                 both("prepare_image", img, 13, "center"), both("prepare_image", img, 13, "none")]
    elif name == "load_label":
        pairs = [both("load_label", lbl_path, r, ct) for r in (16, 21) for ct in ("center", "none")]
        pairs.append((transforms.load_label(lbl_path, 16, "random", np.random.RandomState(2)),
                      jtransforms.load_label(lbl_path, 16, "random", np.random.RandomState(2))))
    elif name == "five_crop":
        pairs = [(np.stack(a), np.stack(b)) for a, b in
                 (both("five_crop_np", arr, 14, 23), both("five_crop_np", arr, 12, 12))]
    else:
        pairs = [(np.stack(a), np.stack(b)) for a, b in
                 (both("random_crops_np", arr, 14, 23, s) for s in (0, 7))]
    for got, want in pairs:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ datasets

def _dataset_pairs(coco_root, other_roots, crop_dir):
    """(name, port dataset, JAX dataset) for every class and variant."""
    out = []
    for name in ("cocostuff27", "cocostuff15", "cocostuff3"):
        for mode in ("train", "val"):
            for lct in ("center", "none", "random"):
                args = (name, mode, coco_root, 16, None, 0.5, lct, 4)
                out.append((f"{name}-{mode}-{lct}", datasets.build_base_dataset(*args),
                            jdatasets.build_base_dataset(*args)))
    for lct in ("center", "random"):
        args = ("cocostuff27", "train", crop_dir, 12, "five", 0.5, lct, 0)
        out.append((f"cropped-{lct}", datasets.build_base_dataset(*args),
                    jdatasets.build_base_dataset(*args)))
    for name in ("cityscapes", "potsdam", "pascal"):
        for lct in ("center", "random"):
            args = (name, "train", other_roots[name], 16, None, 0.5, lct, 1)
            out.append((f"{name}-{lct}", datasets.build_base_dataset(*args),
                        jdatasets.build_base_dataset(*args)))
    return out


def test_every_dataset_item_equals_jax(coco_root, other_roots, tmp_path):
    jjobs.materialize_crops("cocostuff27", coco_root, str(tmp_path), limit=2)
    pairs = _dataset_pairs(coco_root, other_roots, str(tmp_path))
    assert {type(p).__name__ for _, p, _ in pairs} == {
        "CocoSeg", "CroppedDataset", "CityscapesSeg", "Potsdam", "Pascal"}
    for name, mine, ref in pairs:
        assert len(mine) == len(ref) > 0, name
        for i in range(len(ref)):
            assert_items_equal(mine.get(i, np.random.RandomState(100 + i)),
                               ref.get(i, np.random.RandomState(100 + i)))
        assert_items_equal(mine[0], ref[0])          # the dataset's own rng
        assert_items_equal(mine[1], ref[1])


# ------------------------------------------------------------------ pipeline

@pytest.fixture(scope="module")
def nns6(tmp_path_factory):
    nns = np.stack([np.roll(np.arange(6), -i)[:4] for i in range(6)]).astype(np.int32)
    path = str(tmp_path_factory.mktemp("nns") / "nns6.npz")
    np.savez_compressed(path, nns=nns)
    return path


def _pipe(module, coco_root, nns_path, **kw):
    return module.UnSegData("train", coco_root, "cocostuff27", crop_type=None,
                            loader_crop_type=kw.pop("loader_crop_type", "center"), res=16,
                            pos_images=True, num_neighbors=3, nns_path=nns_path, **kw)


@pytest.mark.parametrize("loader_crop_type", ["center", "random"])
def test_pipeline_batches_equal_jax_serial_workers_producers(coco_root, nns6, loader_crop_type):
    kw = dict(native="off", pack="off", loader_crop_type=loader_crop_type)
    want = list(_pipe(jpipeline, coco_root, nns6, **kw).batches(2, seed=7))
    mine = _pipe(pipeline, coco_root, nns6, **kw)
    assert len(want) == 3 and "img_pos" in want[0]
    assert_batches_equal(mine.batches(2, seed=7), want)
    assert_batches_equal(mine.batches(2, seed=7, num_workers=2, prefetch=2), want)
    assert_batches_equal(mine.batches(2, seed=7, producers=2), want)
    # val-style iteration: no shuffle, ragged last batch kept
    assert_batches_equal(mine.batches(4, shuffle=False, drop_last=False),
                         _pipe(jpipeline, coco_root, nns6, **kw).batches(
                             4, shuffle=False, drop_last=False))
    # early abandonment joins the producer threads
    it = mine.batches(2, seed=7, num_workers=2)
    next(it)
    it.close()


def test_pipeline_process_slices_equal_jax(coco_root, nns6):
    """Rank r of a 2-process group reads JAX process r's rows."""
    for rank in (0, 1):
        kw = dict(native="off", pack="off", process_index=rank, process_count=2)
        assert_batches_equal(_pipe(pipeline, coco_root, nns6, **kw).batches(3, seed=2),
                             _pipe(jpipeline, coco_root, nns6, **kw).batches(3, seed=2))


def test_build_data_reads_its_rank_without_a_group(coco_root):
    cfg = {"dataset": {"val": {"data_dir": coco_root, "dataset_name": "cocostuff27",
                               "res": 16}},
           "dataloader": {"val": {"num_workers": 0, "native": "off"}}}
    data = pipeline.build_data(cfg, "val", seed=3)
    assert (data.process_index, data.process_count) == (0, 1)
    assert data.nns is None and len(data) == 4
    assert_batches_equal(data.batches(3), jpipeline.build_data(cfg, "val", seed=3).batches(3))


def test_native_loader_equals_pil_and_native_path_equals_jax(coco_root, nns6):
    """The C++ decode (built into the port's _build/) gives PIL's pixels
    for JPEG images and PNG labels in both geometries, and the native
    pipeline path gives JAX's PIL batches."""
    assert native_loader.available()
    from equss_tpu_torch.ops._build import BUILD_DIR

    assert native_loader.library_path().parent == BUILD_DIR     # never native/build/
    imgs = [os.path.join(coco_root, "images", "train2017", f"train_{i:06d}.jpg") for i in range(4)]
    lbls = [os.path.join(coco_root, "annotations", "train2017", f"train_{i:06d}.png")
            for i in range(4)]
    for mode in ("center", "none"):
        for res in (16, 21):
            np.testing.assert_array_equal(
                native_loader.load_image_batch(imgs, res, 2, mode),
                np.stack([jtransforms.load_image(p, res, mode) for p in imgs]))
            np.testing.assert_array_equal(
                native_loader.load_label_batch(lbls, res, 2, mode).astype(np.int32),
                np.stack([jtransforms.load_label(p, res, mode) for p in lbls]))
    nat = _pipe(pipeline, coco_root, nns6, native="on", pack="off")
    assert nat._fast_batch_kind() == "native"
    assert_batches_equal(nat.batches(2, seed=11),
                         _pipe(jpipeline, coco_root, nns6, native="off", pack="off")
                         .batches(2, seed=11))
    with pytest.raises(IOError):
        native_loader.load_image_batch([imgs[0], lbls[0] + ".missing"], 16, 2)


# ------------------------------------------------------------------ jobs

def test_crop_job_outputs_equal_jax(coco_root, tmp_path):
    mine = jobs.materialize_crops("cocostuff27", coco_root, str(tmp_path / "mine"), limit=3)
    ref = jjobs.materialize_crops("cocostuff27", coco_root, str(tmp_path / "ref"), limit=3)
    assert os.path.relpath(mine, tmp_path / "mine") == os.path.relpath(ref, tmp_path / "ref")
    files = sorted(os.listdir(os.path.join(ref, "img", "train")))
    assert len(files) == 15 and sorted(os.listdir(os.path.join(mine, "img", "train"))) == files
    for sub, ext in (("img", "jpg"), ("label", "png")):
        for i in range(15):
            a = np.asarray(Image.open(os.path.join(mine, sub, "train", f"{i}.{ext}")))
            b = np.asarray(Image.open(os.path.join(ref, sub, "train", f"{i}.{ext}")))
            np.testing.assert_array_equal(a, b)


def test_pack_equals_jax_and_packs_cross_read(coco_root, nns6, tmp_path):
    """Both packages' packs hold the same bytes; each reads the other's
    (center, none and random loader crops) into the PIL batches."""
    for lct in ("center", "none"):
        args = ("cocostuff27", "train", coco_root, 16, None, 0.5, lct, 0)
        mine, ref = str(tmp_path / f"mine_{lct}"), str(tmp_path / f"ref_{lct}")
        cache.pack_dataset(datasets.build_base_dataset(*args), mine, log_every=0)
        jcache.pack_dataset(jdatasets.build_base_dataset(*args), ref, log_every=0)
        with open(mine + ".bin", "rb") as f, open(ref + ".bin", "rb") as g:
            assert f.read() == g.read()
        im, ij = np.load(mine + ".npz"), np.load(ref + ".npz")
        assert sorted(im.files) == sorted(ij.files)
        for k in im.files:
            np.testing.assert_array_equal(im[k], ij[k])
        crops = ("center", "random") if lct == "center" else ("none",)
        for crop in crops:
            pil = list(_pipe(jpipeline, coco_root, nns6, native="off", pack="off",
                             loader_crop_type=crop).batches(2, seed=5))
            port_reads_jax = _pipe(pipeline, coco_root, nns6, pack="on", pack_path=ref,
                                   loader_crop_type=crop)
            jax_reads_port = _pipe(jpipeline, coco_root, nns6, pack="on", pack_path=mine,
                                   loader_crop_type=crop)
            assert isinstance(port_reads_jax.dataset, cache.PackedDataset)
            assert port_reads_jax._fast_batch_kind() == (None if crop == "random" else "pack")
            assert_batches_equal(port_reads_jax.batches(2, seed=5), pil)
            assert_batches_equal(jax_reads_port.batches(2, seed=5), pil)
    with pytest.raises(ValueError):        # a shorter-side pack for a none crop
        _pipe(pipeline, coco_root, nns6, pack="on", pack_path=str(tmp_path / "mine_center"),
              loader_crop_type="none")
    with pytest.raises(FileNotFoundError):
        _pipe(pipeline, coco_root, nns6, pack="on", pack_path=str(tmp_path / "missing"))


def _micro_models():
    """The JAX vit_micro EQUSS with its weights and the port's copy."""
    from equss_tpu.models import equss as jeq
    from equss_tpu.ops.quantizer import PQConfig as JPQConfig
    from equss_tpu_torch.convert import params_from_jax
    from equss_tpu_torch.models.equss import EQUSS, EQUSSConfig
    from equss_tpu_torch.ops.quantizer import PQConfig

    pq = dict(num_pq=4, num_codebook=8, embed_dim=32, vq_type="param", normalize="l2")
    model_j = jeq.EQUSS(jeq.EQUSSConfig(model_type="vit_micro", patch_size=8, hidden_dim=32,
                                        dropout=False, pq=JPQConfig(**pq)))
    params, state = model_j.init(jax.random.PRNGKey(0), img_hw=(32, 32))
    cfg_t = EQUSSConfig(model_type="vit_micro", patch_size=8, hidden_dim=32, dropout=False,
                        pq=PQConfig(**pq))
    model_t = EQUSS(cfg_t, device="cpu")
    model_t.load_state_dict(params_from_jax(params, state, cfg_t))
    return model_j, params, model_t


def test_knn_features_and_neighbours_equal_jax(coco_root, tmp_path):
    model_j, params, model_t = _micro_models()
    kw = dict(crop_type=None, loader_crop_type="center", res=32, native="off")
    data_t = pipeline.UnSegData("train", coco_root, "cocostuff27", **kw)
    data_j = jpipeline.UnSegData("train", coco_root, "cocostuff27", **kw)
    feats_t = jobs.extract_pooled_features(model_t, data_t, batch_size=4)
    feats_j = jjobs.extract_pooled_features(model_j, params, data_j, batch_size=4)
    assert feats_t.shape == feats_j.shape == (6, 32)
    np.testing.assert_allclose(feats_t.numpy(), feats_j, rtol=1e-4, atol=1e-4)
    assert jobs.extract_pooled_features(model_t, data_t, batch_size=4, max_items=5).shape == (5, 32)

    out_t = jobs.precompute_knns(model_t, data_t, str(tmp_path / "t" / "nns.npz"), k=4,
                                 batch_size=3)
    out_j = jjobs.precompute_knns(model_j, params, data_j, str(tmp_path / "j" / "nns.npz"),
                                  k=4, batch_size=3)
    nns_t, nns_j = np.load(out_t)["nns"], np.load(out_j)["nns"]
    assert nns_t.shape == nns_j.shape == (6, 4) and nns_t.dtype == np.int32
    np.testing.assert_array_equal(nns_t[:, 0], np.arange(6))
    sim = np.sort(feats_j @ feats_j.T, axis=1)[:, ::-1]
    # rank r is decided where both of its gaps to the neighbouring ranks
    # exceed 1e-4
    gaps = -np.diff(sim, axis=1)
    decided = np.ones((6, 4), bool)
    decided[:, :4] &= np.concatenate([np.full((6, 1), np.inf), gaps[:, :3]], 1)[:, :4] > 1e-4
    decided[:, :4] &= gaps[:, :4] > 1e-4
    assert decided.any()
    np.testing.assert_array_equal(nns_t[decided], nns_j[decided])
    # the port's top-k is torch.topk of its own similarities, chunked or not
    np.testing.assert_array_equal(jobs.topk_neighbors(feats_t, 4, chunk=2),
                                  jobs.topk_neighbors(feats_t, 4))
