"""PyTorch port: the device-side augmentation and the production training
recipe's driver, on the CPU.

- butterworth_logmask and assemble_image against the JAX package's
  data/device_aug.py on the same uint8 windows, parameters and noise (the
  port is handed the noise JAX draws), positive and negative, bank and
  stream mode: within 2e-5 (float32; XLA's log10 and division round
  otherwise than torch's by an ulp or two, and the Butterworth column adds
  a log of order 1);
- the port's own noise: a pure function of the item's seed, standard
  normal before the clip;
- ImgDataset in device mode: the augmentation parameters drawn bit for bit
  as JAX's, collate_batch, and build_banks' bank-or-stream decisions under
  a small aug_bank_mb;
- the driver on --device cpu with the whole recipe (device_augment,
  remat stages, grad_accum_steps 2, a live-BN backbone), validation and a
  resume, and the checkpoint it writes served by load_model.
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pandas as pd
import pytest
import torch

from birdsoundclassif_tpu.config import NbmConfig as JConfig
from birdsoundclassif_tpu.data import device_aug as jda
from birdsoundclassif_tpu.data import etl as jetl
from birdsoundclassif_tpu.data import image_dataset as jdata
from birdsoundclassif_tpu_torch.config import NbmConfig
from birdsoundclassif_tpu_torch.data import device_aug as tda
from birdsoundclassif_tpu_torch.data import image_dataset as tdata
from birdsoundclassif_tpu_torch.train import driver as tdriver

TOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several pytest workers at once: torch's own pool of one
    thread a core in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the arithmetic against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cutoff", [500, 1713, 5000, 9999])
def test_butterworth_logmask_matches_jax(cutoff):
    want = np.asarray(jda.butterworth_logmask(jnp.asarray([float(cutoff)]), 375))
    got = tda.butterworth_logmask(torch.tensor([float(cutoff)]), 375).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    host = tdata._butterworth_lowpass_mask(float(cutoff), 375)  # scipy, on the host
    np.testing.assert_allclose(got[0], host, rtol=1e-5, atol=1e-6)


def fake_batch(rng, bank_mode, b=3, h=16, w=24):
    """A device-mode batch (numpy) and its uint8 pools; item 1 has no hard
    mixing, item 2 no Butterworth mask."""
    pos = rng.integers(0, 256, (5, h, w)).astype(np.uint8)
    neg = rng.integers(0, 256, (4, h, w)).astype(np.uint8)
    hard = rng.integers(0, 256, (3, h, w)).astype(np.uint8)
    batch = {
        "aug_seed": rng.integers(0, 1 << 31, b).astype(np.uint32),
        "aug_use_noise": np.ones(b, bool),
        "aug_gain": rng.uniform(-0.1, 0.35, b).astype(np.float32),
        "aug_use_hard": np.array([True, False, True][:b]),
        "hard_idx": rng.integers(0, 3, b).astype(np.int32),
        "aug_hard_coef": rng.uniform(0.1, 0.4, b).astype(np.float32),
        "aug_neg_coef": rng.uniform(0.5, 0.99, b).astype(np.float32),
        "aug_use_butter": np.array([True, True, False][:b]),
        "aug_cutoff": rng.integers(500, 10000, b).astype(np.float32),
    }
    pos_pick = rng.integers(0, 5, b).astype(np.int32)
    neg_pick = rng.integers(0, 4, b).astype(np.int32)
    if bank_mode:
        batch["pos_idx"], batch["neg_idx"] = pos_pick, neg_pick
        pools = (pos, neg, hard)
    else:
        batch["pos_u8"], batch["neg_u8"] = pos[pos_pick], neg[neg_pick]
        pools = (None, None, hard)
    return batch, pools


def jax_noise(seeds, shape):
    return np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(jda._NOISE_BASE, np.uint32(s)), shape, jnp.float32)) for s in seeds])


def _port_batch(batch):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.uint32 else v)
            for k, v in batch.items()}


def _banks(module, pools, put):
    return module.AugBanks(*[None if p is None else put(p) for p in pools])


@pytest.mark.parametrize("negative", [False, True], ids=["positive", "negative"])
@pytest.mark.parametrize("bank_mode", [True, False], ids=["bank", "stream"])
def test_assemble_image_matches_jax(bank_mode, negative):
    rng = np.random.default_rng(3 + bank_mode)
    batch, pools = fake_batch(rng, bank_mode)
    want = np.asarray(jda.assemble_image(batch, _banks(jda, pools, jnp.asarray), negative))
    noise = torch.from_numpy(jax_noise(batch["aug_seed"], (16, 24)))
    got = tda.assemble_image(_port_batch(batch), _banks(tda, pools, torch.from_numpy), negative,
                             noise=noise).numpy()
    assert got.shape == want.shape == (3, 16, 24) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_disabled_augmentations_are_exact_identities():
    """All gates off and gain 0: the raw window / 255 bit for bit, whatever
    the noise."""
    rng = np.random.default_rng(5)
    batch, pools = fake_batch(rng, True)
    b = len(batch["aug_gain"])
    batch.update(aug_use_noise=np.zeros(b, bool), aug_gain=np.zeros(b, np.float32),
                 aug_use_hard=np.zeros(b, bool), aug_use_butter=np.zeros(b, bool))
    got = tda.assemble_image(_port_batch(batch), _banks(tda, pools, torch.from_numpy), False)
    want = pools[0][batch["pos_idx"]].astype(np.float32) / 255.0
    np.testing.assert_array_equal(got.numpy(), want)


def test_port_noise_is_a_pure_function_of_the_seed():
    """item_noise: the same seed gives the same bits in any batch position
    and on any call, another seed other bits; standard normal before the
    clip (mean within 4 standard errors of 0, std within 1 %)."""
    a = tda.item_noise([7, 11, 7], (256, 256), "cpu")
    b = tda.item_noise([11], (256, 256), "cpu")
    assert torch.equal(a[0], a[2]) and torch.equal(a[1], b[0]) and not torch.equal(a[0], a[1])
    n = a[0].numel()
    for x in (a[0], a[1]):
        assert abs(float(x.mean())) < 4 / np.sqrt(n)
        assert abs(float(x.std()) - 1.0) < 0.01
    # drawn when no noise is given: the assembled residual is that noise
    # scaled by the raw image's std / 2 and clipped
    rng = np.random.default_rng(6)
    batch, pools = fake_batch(rng, True, b=1, h=64, w=96)
    batch.update(aug_gain=np.zeros(1, np.float32), aug_use_hard=np.zeros(1, bool),
                 aug_use_butter=np.zeros(1, bool))
    tb, banks = _port_batch(batch), _banks(tda, pools, torch.from_numpy)
    img = torch.from_numpy(pools[0][batch["pos_idx"]].astype(np.float32) / 255.0)
    resid = tda.assemble_image(tb, banks, False) - img
    noise = tda.item_noise(tb["aug_seed"].tolist(), (64, 96), "cpu")
    want = torch.clamp(noise * (torch.std(img, dim=(1, 2), keepdim=True, correction=0) / 2),
                       -0.5, 0.5)
    torch.testing.assert_close(resid, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# dataset, collate, banks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_dataset(tmp_path_factory):
    """The ETL's layout at 128x256, written with the ETL's own PNG writer
    and pandas annotations.csv: 2 positive folders of 3 windows (bird ids
    1-5, boxes inside the window), 4 negative and 2 hard-negative windows."""
    root = tmp_path_factory.mktemp("recipe_ds")
    rng = np.random.default_rng(21)
    for f in range(2):
        folder = f"rec{f}__bird__XC{f}"
        d = root / "positive_files" / folder
        d.mkdir(parents=True)
        rows = []
        for i in range(3):
            img = 0.3 + 0.1 * rng.random((128, 256))
            x1, y1 = int(rng.integers(10, 150)), int(rng.integers(10, 70))
            img[y1:y1 + 30, x1:x1 + 60] += 0.5
            jetl._write_png(str(d / f"{folder}__{i:05d}.png"), np.clip(img, 0, 1))
            rows.append({"index": i, "coord": [(x1, y1, x1 + 59, y1 + 29)],
                         "bird_id": [int(rng.integers(1, 6))]})
        pd.DataFrame(rows).to_csv(d / "annotations.csv", sep=";", index=False)
    for sub, n in (("negative_files", 4), ("hard_neg", 2)):
        d = root / sub / "recn__noise__XC9"
        d.mkdir(parents=True)
        for i in range(n):
            jetl._write_png(str(d / f"recn__noise__XC9__{i:05d}.png"),
                            0.3 + 0.1 * rng.random((128, 256)))
    return str(root)


@pytest.mark.parametrize("banked", [(True, True), (False, False), (True, False)])
def test_device_items_and_batches_match_jax(small_dataset, banked):
    """The same seed gives the same items (indices or bytes, every drawn
    parameter bit for bit) and the same collated batch."""
    tds = tdata.ImgDataset(small_dataset, transform=True, rng=np.random.default_rng(3))
    jds = jdata.ImgDataset(small_dataset, transform=True, rng=np.random.default_rng(3))
    for ds in (tds, jds):
        ds.device_mode = True
        ds.bank_positives, ds.bank_negatives = banked
    assert tds.positive_files == jds.positive_files
    t_items = [tds[i] for i in (0, 3, 5, 1)]
    j_items = [jds[i] for i in (0, 3, 5, 1)]
    for (ti, tb, tl), (ji, jb, jl) in zip(t_items, j_items):
        assert sorted(ti) == sorted(ji)
        for k in ji:
            assert np.asarray(ti[k]).dtype == np.asarray(ji[k]).dtype, k
            np.testing.assert_array_equal(ti[k], ji[k], err_msg=k)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tl, jl)
    tbatch = tdata.collate_batch(t_items, 4)
    jbatch = jdata.collate_batch(j_items, 4)
    assert sorted(tbatch) == sorted(jbatch)
    for k in jbatch:
        np.testing.assert_array_equal(tbatch[k], jbatch[k], err_msg=k)
    assert ("pos_idx" in tbatch) == banked[0] and ("neg_u8" in tbatch) == (not banked[1])
    assert any(t[0]["aug_use_hard"] for t in t_items)


@pytest.mark.parametrize("budget_mb", [0, 1])
def test_build_banks_decides_as_jax(small_dataset, budget_mb):
    """aug_bank_mb 0: every pool streamed but the hard one; 1 MB: all three
    banked; the banks hold the same bytes as JAX's."""
    tcfg, jcfg = NbmConfig(), JConfig()
    tcfg.aug_bank_mb = jcfg.aug_bank_mb = budget_mb
    tds = tdata.ImgDataset(small_dataset, transform=True)
    jds = jdata.ImgDataset(small_dataset, transform=True)
    tb = tda.build_banks(tds, tcfg, "cpu")
    jb = jda.build_banks(jds, jcfg)
    assert (tds.device_mode, tds.bank_positives, tds.bank_negatives) == (
        jds.device_mode, jds.bank_positives, jds.bank_negatives) == (True, budget_mb > 0,
                                                                    budget_mb > 0)
    for t, j in zip(tb, jb):
        assert (t is None) == (j is None)
        if t is not None:
            assert t.dtype == torch.uint8
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_build_banks_banks_positives_before_negatives(small_dataset):
    """A budget that holds the hard and positive pools but not the
    negatives (2 + 6 windows of 32,768 bytes fit, 4 more do not), on both
    sides (the budget is aug_bank_mb * 1e6 bytes, here a fraction of a
    MB)."""
    window = 128 * 256
    budget_mb = (8 * window + window) / 1e6  # room for one negative, not four
    tcfg, jcfg = NbmConfig(), JConfig()
    tcfg.aug_bank_mb = jcfg.aug_bank_mb = budget_mb
    tds = tdata.ImgDataset(small_dataset, transform=True)
    jds = jdata.ImgDataset(small_dataset, transform=True)
    tb, jb = tda.build_banks(tds, tcfg, "cpu"), jda.build_banks(jds, jcfg)
    assert (tds.bank_positives, tds.bank_negatives) == (jds.bank_positives,
                                                        jds.bank_negatives) == (True, False)
    assert tb.neg is None and jb.neg is None
    np.testing.assert_array_equal(tb.pos.numpy(), np.asarray(jb.pos))
    np.testing.assert_array_equal(tb.hard.numpy(), np.asarray(jb.hard))


# ---------------------------------------------------------------------------
# the driver with the production recipe
# ---------------------------------------------------------------------------


def recipe_flags(dataset_dir, save_root, max_steps):
    return [
        "--data_path", str(dataset_dir), "--save_dir", str(save_root),
        "--model_name", "recipe", "--max_steps", str(max_steps),
        "--batch_size", "2", "--grad_accum_steps", "2",
        "--remat_backbone", "true", "--remat_granularity", "stages",
        "--device_augment", "true", "--norm_layer_backbone", "batchnorm",
        "--img_height", "128", "--img_width", "256", "--num_classes", "6",
        "--out_fpn_chan", "16", "--fpn_p_chan", "24", "--depth_rcnn", "1",
        "--pre_nms_topN", "256", "--post_nms_topN", "64", "--max_gt_boxes", "4",
        "--validation_prop", "0.67", "--eval_every", "3",
        "--neg_step_freq", "2", "--first_neg_step", "1",
        "--compute_dtype", "float32", "--device", "cpu",
    ]


def test_driver_runs_the_recipe_resumes_and_serves(small_dataset, tmp_path, capsys):
    """Steps 0-2 (step 2 negative), validation after step 3, a resume to
    step 4; every proposal NMS one a microbatch; the checkpoint (live
    backbone norms, their running statistics moved) folds and serves."""
    from birdsoundclassif_tpu_torch.infer.pipeline import load_model
    from birdsoundclassif_tpu_torch.models import rpn as trpn
    from birdsoundclassif_tpu_torch.models import weights
    from birdsoundclassif_tpu_torch.train import loop as tloop

    calls = []
    real_nms, real_step = trpn.greedy_nms_prefix, tloop.Trainer.train_step
    negs = []

    def counting_nms(*a):
        calls.append(a[0].shape[0])
        return real_nms(*a)

    def logged_step(self, batch, negative_sample=False, generator=None, uniforms=None):
        assert "img" not in batch and "pos_idx" in batch and batch["aug_seed"].device.type == "cpu"
        negs.append(bool(negative_sample))
        return real_step(self, batch, negative_sample, generator, uniforms)

    save_root = tmp_path / "models"
    trpn.greedy_nms_prefix, tloop.Trainer.train_step = counting_nms, logged_step
    try:
        assert tdriver.main(recipe_flags(small_dataset, save_root, 3)) == 0
        first = list(calls)
        assert tdriver.main(recipe_flags(small_dataset, save_root, 4)) == 0
    finally:
        trpn.greedy_nms_prefix, tloop.Trainer.train_step = real_nms, real_step
    out = capsys.readouterr().out
    assert "device_augment: banks pos=True neg=True (0 MB on device" in out
    assert "Resuming training" in out
    assert negs == [False, False, True, False]
    # 3 steps x 2 microbatches of 1, then validation: one batch of 4 (eval
    # top-N) and its negative; the resume's step: 2 microbatches
    assert first == [1] * 6 + [4, 4] and calls == first + [1, 1]
    mdir = save_root / "recipe"
    with open(mdir / "ckpt_last" / "meta.json") as f:
        assert json.load(f)["steps"] == 4
    with open(mdir / "metrics.jsonl") as f:
        tags = {json.loads(line)["tag"] for line in f}
    assert "Val_Loss/sec_class_loss" in tags
    cfg = NbmConfig.load(str(mdir / "args"))
    assert (cfg.grad_accum_steps, cfg.remat_backbone, cfg.device_augment,
            cfg.norm_layer_backbone) == (2, True, True, "batchnorm")
    params = weights.load_params(str(mdir / "ckpt_last"), cfg)
    assert float((params["backbone.0.body.layer1.0.bn1.running_var"] - 1).abs().max()) > 1e-3
    model, _ = load_model(str(mdir / "ckpt_last"), "cpu")
    with torch.no_grad():
        det = model(torch.rand(2, 128, 256, generator=torch.Generator().manual_seed(0)),
                    min_score=0.0)
    assert all(torch.isfinite(t).all() for t in det if t.dtype.is_floating_point)
