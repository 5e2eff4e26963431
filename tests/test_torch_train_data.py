"""PyTorch port: training data, driver and checkpoints, on the CPU.

- The port's PNG decoder (C unfilter routine and its plain Python version)
  against imageio, on windows written by the JAX ETL's own writer and on
  the port's encoder output, which cycles all five row filters.
- ImgDataset items, collate_batch, the file listing, the split and the
  batch order against the JAX package, bit for bit under the same seed.
- The driver on --device cpu with the flags of tests/test_train_driver.py:
  2 steps, the files, a resume to 4; the checkpoint read back by the port's
  CLI and by the JAX package's load_params.
- Kill-and-resume is bitwise equal to an uninterrupted run; resuming
  without optimizer state raises; the multi-device flags and a batch
  that does not split into grad_accum_steps microbatches are refused.
"""

import json
import shutil
import wave

import numpy as np
import pandas as pd
import pytest
import torch

from birdsoundclassif_tpu.data import etl as jetl
from birdsoundclassif_tpu.data import image_dataset as jdata
from birdsoundclassif_tpu.train import driver as jdriver
from birdsoundclassif_tpu.utils import checkpoint as jckpt
from birdsoundclassif_tpu_torch import kernels
from birdsoundclassif_tpu_torch.config import NbmConfig
from birdsoundclassif_tpu_torch.data import image_dataset as tdata
from birdsoundclassif_tpu_torch.data import png
from birdsoundclassif_tpu_torch.models import weights
from birdsoundclassif_tpu_torch.models.detector import NbmModel
from birdsoundclassif_tpu_torch.train import driver as tdriver
from birdsoundclassif_tpu_torch.train import loop as tloop
from birdsoundclassif_tpu_torch.utils import checkpoint as tckpt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several pytest workers at once; torch's own pool
    of one thread a core in each of them oversubscribes the cores many
    times over, which slows these small-tensor steps by tens of times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_wav(path, samples, sr=44100):
    x = (np.clip(samples, -1, 1) * 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(x.tobytes())


def spectrogram_like(rng, h=375, w=256):
    """Smooth rows with a few bright bands, as the ETL's windows look."""
    y = np.linspace(0, 1, h)[:, None]
    x = np.linspace(0, 1, w)[None, :]
    img = 0.4 + 0.2 * np.sin(7 * x + 3 * y) + 0.05 * rng.standard_normal((h, w))
    img[h // 3: h // 3 + 12, w // 4: w // 2] += 0.3
    return np.clip(img, 0, 1)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------


def _filters(data):
    return set(np.unique(png._parse(data)[2][:, 0]).tolist())


@pytest.mark.parametrize("source", ["etl", "port"])
@pytest.mark.parametrize("plain", [False, True], ids=["c_routine", "plain"])
def test_png_decoder_matches_imageio(tmp_path, source, plain):
    import imageio.v2 as imageio

    rng = np.random.default_rng(0)
    seen = set()
    for i in range(3):
        img = spectrogram_like(rng)
        path = str(tmp_path / f"w{i}.png")
        if source == "etl":
            jetl._write_png(path, img)  # the JAX ETL's writer: round(img*255) via imageio
        else:
            png.write_png(path, np.round(img * 255).astype(np.uint8))
        with open(path, "rb") as f:
            data = f.read()
        seen |= _filters(data)
        got = png.decode_png(data)
        if plain:
            want = png.unfilter_plain(png._parse(data)[2])
            assert np.array_equal(got, want)
            got = want
        assert got.dtype == np.uint8
        assert np.array_equal(got, imageio.imread(path))
    if source == "port":
        assert seen == {0, 1, 2, 3, 4}
    else:
        assert seen & {3, 4}, f"the ETL's windows took only filters {seen}"


def test_png_rejects_what_it_does_not_read(tmp_path):
    import imageio.v2 as imageio

    path = str(tmp_path / "deep.png")
    imageio.imwrite(path, np.arange(64, dtype=np.uint16).reshape(8, 8))
    with pytest.raises(ValueError, match="unsupported PNG"):
        png.read_png(path)
    rgb = str(tmp_path / "rgb.png")
    imageio.imwrite(rgb, np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="colour type 2"):
        png.read_png(rgb)
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"GIF89a" + bytes(20))


def test_host_routine_needs_a_compiler(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    shutil.copy(png.UNFILTER.source, src / "probe_unfilter.c")
    monkeypatch.setattr(kernels, "CSRC_DIR", str(src))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("CC", "no-such-cc")
    monkeypatch.setenv("PATH", str(tmp_path))
    lib = kernels.NativeLibrary("probe_unfilter", {"png_unfilter_row": []})
    with pytest.raises(RuntimeError, match="no C compiler"):
        lib.build()


# ---------------------------------------------------------------------------
# dataset against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def crafted_dataset(tmp_path_factory):
    """The ETL's layout, written with the ETL's own PNG writer and pandas
    annotations.csv: 2 positive folders of 3 windows, 4 negative and 2
    hard-negative windows, one class-0 box."""
    root = tmp_path_factory.mktemp("crafted")
    rng = np.random.default_rng(11)
    for f in range(2):
        folder = f"rec{f}__bird__XC{f}"
        d = root / "positive_files" / folder
        d.mkdir(parents=True)
        rows = []
        for i in range(3):
            jetl._write_png(str(d / f"{folder}__{i:05d}.png"), spectrogram_like(rng))
            k = 1 + (i % 3)
            x1 = rng.integers(0, 200, k)
            y1 = rng.integers(0, 300, k)
            coord = [(int(a), int(b), int(a) + 30, int(b) + 40) for a, b in zip(x1, y1)]
            ids = [int(v) for v in rng.integers(1, 150, k)]
            if f == 1 and i == 2:
                ids[0] = 0
            rows.append({"index": i, "coord": coord, "bird_id": ids})
        pd.DataFrame(rows).to_csv(d / "annotations.csv", sep=";", index=False)
    for sub, n in (("negative_files", 4), ("hard_neg", 2)):
        d = root / sub / "recn__noise__XC9"
        d.mkdir(parents=True)
        for i in range(n):
            jetl._write_png(str(d / f"recn__noise__XC9__{i:05d}.png"), spectrogram_like(rng))
    return str(root)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dataset_items_match_jax_bit_for_bit(crafted_dataset, seed, monkeypatch):
    calls = {"butter": 0, "hard": 0}
    real_butter = tdata._butterworth_lowpass_mask

    def counting_butter(*a):
        calls["butter"] += 1
        return real_butter(*a)

    real_load = tdata.ImgDataset._load_png

    def counting_load(self, sub, name):
        calls["hard"] += sub == "hard_neg"
        return real_load(self, sub, name)

    monkeypatch.setattr(tdata, "_butterworth_lowpass_mask", counting_butter)
    monkeypatch.setattr(tdata.ImgDataset, "_load_png", counting_load)
    jds = jdata.ImgDataset(crafted_dataset, transform=True, rng=np.random.default_rng(seed))
    tds = tdata.ImgDataset(crafted_dataset, transform=True, rng=np.random.default_rng(seed))
    assert tds.positive_files == jds.positive_files and len(tds) == 6
    assert tds.negative_files == jds.negative_files
    assert tds.hard_negative_files == jds.hard_negative_files
    for _ in range(2):
        for idx in range(len(tds)):
            want, got = jds[idx], tds[idx]
            for w, g in zip(want, got):
                assert g.dtype == w.dtype and g.shape == w.shape
                assert np.array_equal(g, w), idx
    assert calls["butter"] > 0 and calls["hard"] > 0  # both optional branches taken
    # the same generator state afterwards: the same number of draws
    assert tds.rng.integers(1 << 30) == jds.rng.integers(1 << 30)


def test_dataset_drops_class_zero_boxes(crafted_dataset):
    tds = tdata.ImgDataset(crafted_dataset, transform=False, rng=np.random.default_rng(0))
    jds = jdata.ImgDataset(crafted_dataset, transform=False, rng=np.random.default_rng(0))
    for idx in range(len(tds)):
        _, _, boxes, ids = tds[idx]
        _, _, jboxes, jids = jds[idx]
        assert np.array_equal(boxes, jboxes) and np.array_equal(ids, jids)
        assert (ids != 0).all() and boxes.shape == (len(ids), 4)


def test_collate_batch_matches_jax(crafted_dataset):
    tds = tdata.ImgDataset(crafted_dataset, transform=True, rng=np.random.default_rng(3))
    items = [tds[i] for i in range(3)]
    got = tdata.collate_batch(items, 2)
    want = jdata.collate_batch(items, 2)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_split_and_batch_order_match_jax(crafted_dataset):
    for seed, prop in ((42, 0.03), (7, 0.34)):
        rng_t, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
        tds = tdata.ImgDataset(crafted_dataset, transform=True, rng=rng_t)
        jds = jdata.ImgDataset(crafted_dataset, transform=True, rng=rng_j)
        t_tr, t_val = tdriver.train_test_split(len(tds), prop, rng_t)
        j_tr, j_val = jdriver.train_test_split(len(jds), prop, rng_j)
        assert np.array_equal(t_tr, j_tr) and np.array_equal(t_val, j_val)
        tl = tdata.BatchLoader(tds, t_tr, 2, 4, rng_t)
        jl = jdata.BatchLoader(jds, j_tr, 2, 4, rng_j)
        for a, b in zip(tl._batches(), jl._batches()):
            assert np.array_equal(a, b)
        assert len(tl) == len(jl)


def test_batch_loader_yields_every_batch_and_raises_item_errors(crafted_dataset):
    tds = tdata.ImgDataset(crafted_dataset, transform=True, rng=np.random.default_rng(0))
    batches = list(tdata.BatchLoader(tds, np.arange(6), 2, 4, np.random.default_rng(0)))
    assert len(batches) == 3 and batches[0]["img"].shape == (2, 375, 256)
    bad = tdata.BatchLoader(tds, np.array([0, 99]), 2, 4, np.random.default_rng(0))
    with pytest.raises(IndexError):
        list(bad)


def test_batch_loader_stops_its_producer_when_left_early(crafted_dataset):
    import threading

    tds = tdata.ImgDataset(crafted_dataset, transform=True, rng=np.random.default_rng(0))
    before = threading.active_count()
    for _ in range(2):  # leave mid-epoch, as the driver does at max_steps
        for _batch in tdata.BatchLoader(tds, np.arange(6), 1, 4, np.random.default_rng(0)):
            break
    assert threading.active_count() == before


# ---------------------------------------------------------------------------
# driver and checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def etl_dataset(tmp_path_factory):
    """tests/test_train_driver.py's dataset: one 7 s recording through the
    JAX package's ETL."""
    rng = np.random.default_rng(0)
    tmp = tmp_path_factory.mktemp("drv")
    rec = tmp / "rec"
    rec.mkdir()
    sr = 44100
    t = np.arange(sr * 7) / sr
    sig = 0.02 * rng.standard_normal(len(t))
    m = (t > 1.0) & (t < 2.0)
    sig[m] += 0.5 * np.sin(2 * np.pi * 3000 * t[m])
    write_wav(rec / "turdus_merula#XC9.wav", sig, sr)
    (rec / "turdus_merula#XC9.txt").write_text("1.00\t2.00\tTurdus merula\n\\\t2500\t3500\n")
    out = tmp / "dataset"
    jetl.prepare_dataset(str(rec), str(out))
    return out, rec


def _flags(dataset_dir, save_root, max_steps):
    return [
        "--data_path", str(dataset_dir),
        "--save_dir", str(save_root),
        "--model_name", "itest",
        "--batch_size", "1",
        "--max_steps", str(max_steps),
        "--out_fpn_chan", "16",
        "--fpn_p_chan", "24",
        "--depth_rcnn", "1",
        "--pre_nms_topN", "256",
        "--post_nms_topN", "64",
        "--max_gt_boxes", "4",
        "--validation_prop", "0",
        "--first_neg_step", "100",  # keep all steps positive
        "--compute_dtype", "float32",
        "--device", "cpu",
    ]


def test_driver_runs_resumes_and_its_checkpoint_serves_both_clis(etl_dataset, tmp_path):
    from birdsoundclassif_tpu_torch.infer import cli

    dataset_dir, rec = etl_dataset
    save_root = tmp_path / "models"
    assert tdriver.main(_flags(dataset_dir, save_root, max_steps=2)) == 0
    mdir = save_root / "itest"
    assert (mdir / "args").exists()
    for name in ("params.npz", "opt_state.npz", "split.npz", "meta.json", "args"):
        assert (mdir / "ckpt_last" / name).exists(), name
    with open(mdir / "ckpt_last" / "meta.json") as f:
        assert json.load(f)["steps"] == 2
    with open(mdir / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert {"Training_Loss/first_class_loss", "Training_Loss/sec_class_loss"} <= {
        r["tag"] for r in lines}
    assert all(np.isfinite(r["value"]) for r in lines)

    assert tdriver.main(_flags(dataset_dir, save_root, max_steps=4)) == 0
    with open(mdir / "ckpt_last" / "meta.json") as f:
        assert json.load(f)["steps"] == 4

    # the trainer's checkpoint in the port's CLI ...
    audio = tmp_path / "audio"
    audio.mkdir()
    shutil.copy(rec / "turdus_merula#XC9.wav", audio / "night.wav")
    assert cli.main(["--ckpt", str(mdir / "ckpt_last"), "--audio_dir", str(audio),
                     "--min_score", "0.0", "--device", "cpu"]) == 0
    assert (audio / "night.txt").exists()
    # ... and in the JAX package
    cfg = NbmConfig.load(str(mdir / "args"))
    tree = jckpt.load_params(str(mdir / "ckpt_last"))
    assert "backbone" in tree and "head" in tree
    got = weights.params_to_state_dict(jckpt._flatten(tree), cfg)
    with np.load(mdir / "ckpt_last" / "params.npz") as z:
        assert set(z.files) == {jk for jk, _ in weights.key_map(cfg).values()}
    assert len(got) == len(weights.key_map(cfg))


def tiny(**kw):
    cfg = NbmConfig()
    cfg.num_classes = 6
    cfg.out_fpn_chan = 16
    cfg.fpn_p_chan = 24
    cfg.depth_rcnn = 1
    cfg.img_height, cfg.img_width = 128, 256
    cfg.pre_nms_topN = 256
    cfg.post_nms_topN = 64
    cfg.max_gt_boxes = 4
    cfg.compute_dtype = "float32"
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def tiny_batch(seed=0):
    rng = np.random.default_rng(seed)
    gt = np.zeros((2, 4, 4), np.float32)
    gt[:, 0] = [30.0, 20.0, 120.0, 60.0]
    valid = np.zeros((2, 4), bool)
    valid[:, 0] = True
    labels = np.where(valid, 3, 0).astype(np.int32)
    return {k: torch.from_numpy(v) for k, v in {
        "img": rng.random((2, 128, 256), dtype=np.float32),
        "neg_img": rng.random((2, 128, 256), dtype=np.float32),
        "gt_boxes": gt, "gt_valid": valid, "gt_labels": labels}.items()}


def _trainer(cfg, seed=0):
    model = NbmModel(cfg).init_weights(torch.Generator().manual_seed(seed))
    return tloop.Trainer(model, cfg)


def _step(trainer, batch, step, neg=False):
    gen = tdriver.step_generator(torch.device("cpu"), trainer.cfg.seed, step)
    return trainer.train_step(batch, negative_sample=neg, generator=gen)


def test_kill_and_resume_bitwise_identical(tmp_path):
    """A run restored from a full checkpoint takes the next steps (positive
    and negative) bit for bit as the run that never stopped."""
    cfg = tiny()
    batch = tiny_batch()
    live = _trainer(cfg)
    for s in range(2):
        _step(live, batch, s)
    tdriver.save_checkpoint(str(tmp_path), "last", live, epoch=1, best_val_cls_loss=9.0,
                            train_indices=np.arange(3), val_indices=np.arange(1), full=True)
    restored = _trainer(cfg, seed=1)  # other weights: all must come from the file
    meta, split = tdriver.load_checkpoint(str(tmp_path), "last", restored)
    assert meta == {"steps": 2, "epoch": 1, "best_val_cls_loss": 9.0}
    assert restored.steps == 2 and np.array_equal(split[0], np.arange(3))
    for s, neg in ((2, False), (3, True)):
        a, b = _step(live, batch, s, neg), _step(restored, batch, s, neg)
        assert all(torch.equal(a[k], b[k]) for k in a)
    sa, sb = live.model.state_dict(), restored.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    for pa, pb in zip(live.params, restored.params):
        for field in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(live.optimizer.state[pa][field],
                               restored.optimizer.state[pb][field])


def test_resume_without_optimizer_state_raises(tmp_path):
    cfg = tiny()
    trainer = _trainer(cfg)
    tdriver.save_checkpoint(str(tmp_path), "last", trainer, epoch=0, best_val_cls_loss=99.0)
    assert (tmp_path / "ckpt_last" / "meta.json").exists()
    with pytest.raises(FileNotFoundError, match="no opt_state.npz"):
        tdriver.load_checkpoint(str(tmp_path), "last", _trainer(cfg))


def test_optimizer_state_of_another_model_is_refused(tmp_path):
    trainer = _trainer(tiny())
    _step(trainer, tiny_batch(), 0)
    tckpt.save_opt_state(str(tmp_path / "opt_state.npz"), trainer)
    other = _trainer(tiny(depth_rcnn=2))
    with pytest.raises(ValueError, match="does not fit"):
        tckpt.load_opt_state(str(tmp_path / "opt_state.npz"), other)


def test_params_npz_round_trips_through_jax_load_params(tmp_path):
    import jax

    from birdsoundclassif_tpu.config import NbmConfig as JConfig
    from birdsoundclassif_tpu.models.detector import NbmModel as JModel

    cfg = tiny()
    model = NbmModel(cfg).init_weights(torch.Generator().manual_seed(4))
    tckpt.save_params(str(tmp_path), model, cfg)
    tree = jckpt.load_params(str(tmp_path))
    jcfg = JConfig.from_json(cfg.to_json())
    shapes = jax.eval_shape(lambda: JModel.init(jax.random.PRNGKey(0), jcfg))
    want = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    flat = jckpt._flatten(jax.device_get(tree))
    assert {k: tuple(v.shape) for k, v in flat.items()} == want
    back = weights.params_to_state_dict(flat, cfg)
    own = model.state_dict()
    assert sorted(back) == sorted(own)
    assert all(torch.equal(back[k], own[k]) for k in own)


@pytest.mark.parametrize("extra, error", [
    (["--data_parallel", "2"], SystemExit),
    (["--distributed"], SystemExit),
    (["--model_parallel", "2"], SystemExit),
    (["--num_processes", "2"], SystemExit),
    (["--batch_size", "4", "--grad_accum_steps", "3"], SystemExit),
    (["--remat_backbone", "maybe"], SystemExit),
])
def test_driver_refuses_unported_options(tmp_path, extra, error):
    with pytest.raises(error):
        tdriver.main(["--data_path", str(tmp_path), "--save_dir", str(tmp_path),
                      "--device", "cpu", *extra])
    assert not (tmp_path / "new_model").exists()


def test_driver_raises_without_gpu_unless_device_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the no-GPU error cannot occur")
    with pytest.raises(RuntimeError, match="--device cpu"):
        tdriver.main(["--data_path", str(tmp_path), "--save_dir", str(tmp_path)])


def test_step_generator_depends_on_seed_and_step_alone():
    cpu = torch.device("cpu")
    a = torch.rand(4, generator=tdriver.step_generator(cpu, 42, 7))
    b = torch.rand(4, generator=tdriver.step_generator(cpu, 42, 7))
    c = torch.rand(4, generator=tdriver.step_generator(cpu, 42, 8))
    d = torch.rand(4, generator=tdriver.step_generator(cpu, 43, 7))
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, d)
