"""PyTorch port: the training path held against the JAX package on the CPU.

Tiny float32 config (tests/test_train_driver.py:_tiny_cfg): ResNet-50 at
128x256, out_fpn_chan 16, fpn_p_chan 24, depth_rcnn 1, 6 classes, pre/post
NMS 256/64, 4 GT slots. JAX params from create_train_state(PRNGKey(0)) are
carried into the port with models/weights.py; both sides get the same numpy
batch.

The target layers' random draws cannot come from the same stream
(docs/PARITY.md deviation 1), so the port is handed the uniforms JAX draws,
rebuilt from the same key chain: split(key) -> (k_atl, k_ptl), split(k, B)
per image, then split(k) for the anchor targets and split(k, 3) for the
proposal targets. With those, labels, sampled RoIs and ok flags must be
EXACT, and so must the regression targets' centre offsets; their log
width and height ratios may differ in the last bit (XLA's float32 log and
torch's are not rounded alike), and are held to 2 ulp.

Tolerances, float32 on both sides:
  * each loss on JAX's own inputs: 1e-5 relative;
  * whole train step: losses 1e-4 relative;
  * gradients, compared through AdamW's first moment (0.1 x the clipped
    gradient after one update): 2e-2 of the tensor's largest magnitude
    (the deep backbone convs differ most: 1.25e-2 seen after two steps),
    or 1e-9 absolute for tensors whose gradient is analytically zero (a
    bias in front of a training-mode batch norm, an attention key bias),
    where both sides hold rounding noise;
  * updated parameters: an Adam update moves an entry by at most about lr
    (lr x sign(gradient) on the first), so an entry whose gradient is
    rounding noise can move the other way; after k updates every entry
    must be within k x 2.05 lr of JAX's (plus 1e-6 of the tensor's
    magnitude); of a tensor with a real gradient at most 1% of the entries
    may differ by more than 0.05 lr (0.6% seen), and over all of them the
    mean difference must stay under 1e-3 lr (1.5e-4 lr seen);
  * live batch-norm running statistics: 1e-4 of their largest magnitude
    (the second step's statistics see the first update's differences;
    1.3e-5 seen).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from birdsoundclassif_tpu.config import NbmConfig as JConfig
from birdsoundclassif_tpu.ops import anchors as janchors
from birdsoundclassif_tpu.train import losses as jlosses
from birdsoundclassif_tpu.train import loop as jloop
from birdsoundclassif_tpu.train import targets as jtargets
from birdsoundclassif_tpu_torch.config import NbmConfig
from birdsoundclassif_tpu_torch.models import weights
from birdsoundclassif_tpu_torch.models.detector import NbmModel
from birdsoundclassif_tpu_torch.ops import anchors as tanchors
from birdsoundclassif_tpu_torch.train import losses as tlosses
from birdsoundclassif_tpu_torch.train import loop as tloop
from birdsoundclassif_tpu_torch.train import targets as ttargets

B, G = 2, 4
ZERO_GRAD = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several pytest workers at once; torch's own pool
    of one thread a core in each of them oversubscribes the cores many
    times over, which slows these small-tensor steps by tens of times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(cls, **kw):
    cfg = cls()
    cfg.num_classes = 6
    cfg.out_fpn_chan = 16
    cfg.fpn_p_chan = 24
    cfg.depth_rcnn = 1
    cfg.img_height, cfg.img_width = 128, 256
    cfg.pre_nms_topN = 256
    cfg.post_nms_topN = 64
    cfg.max_gt_boxes = G
    cfg.compute_dtype = "float32"
    for k, v in kw.items():
        setattr(cfg, k, v)
    return cfg


def make_batch(seed=0):
    rng = np.random.default_rng(seed)
    gt = np.zeros((B, G, 4), np.float32)
    gt[:, 0] = [30.0, 20.0, 120.0, 60.0]
    gt[:, 1] = [140.0, 30.0, 200.0, 90.0]
    gt[1, 2] = [60.0, 70.0, 90.0, 120.0]
    valid = np.zeros((B, G), bool)
    valid[:, :2] = True
    valid[1, 2] = True
    labels = np.where(valid, np.array([[3, 5, 2, 0]] * B), 0).astype(np.int32)
    return {"img": rng.random((B, 128, 256), dtype=np.float32),
            "neg_img": rng.random((B, 128, 256), dtype=np.float32),
            "gt_boxes": gt, "gt_valid": valid, "gt_labels": labels}


def jax_uniforms(key, k_in, n_rois, g=G, b=B):
    """The uniforms the JAX target layers draw from `key`, as the port takes them."""
    k_atl, k_ptl = jax.random.split(key)
    atl = [[np.asarray(jax.random.uniform(k, (k_in,))) for k in jax.random.split(ki)]
           for ki in jax.random.split(k_atl, b)]
    ptl = [[np.asarray(jax.random.uniform(k, (n_rois + g,))) for k in jax.random.split(ki, 3)]
           for ki in jax.random.split(k_ptl, b)]
    return {"atl": torch.tensor(np.array(atl)), "ptl": torch.tensor(np.array(ptl))}


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_targets_equal(got, want, what):
    """Regression targets: dx, dy exact; log dw, log dh within 2 ulp."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    got4, want4 = got.reshape(-1, 4), want.reshape(-1, 4)
    assert np.array_equal(got4[:, :2], want4[:, :2]), f"{what}: centre offsets differ"
    ulp = np.spacing(np.maximum(np.abs(got4[:, 2:]), np.abs(want4[:, 2:])))
    assert (np.abs(got4[:, 2:] - want4[:, 2:]) <= 2 * ulp).all(), f"{what}: log ratios differ"


def _rel_close(got, want, rel, what):
    got, want = float(got), float(want)
    assert abs(got - want) <= rel * max(abs(want), 1e-12), f"{what}: {got} vs {want}"


# ---------------------------------------------------------------------------
# anchors and targets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [(128, 256), (375, 1024)])
def test_inside_image_mask_matches_jax(size):
    cfg = NbmConfig()
    cfg.img_height, cfg.img_width = size
    th, tw = cfg.top_size
    grid = tanchors.full_anchor_grid(cfg.base_size, tuple(cfg.ratios), tuple(cfg.scales), tw, th,
                                     cfg.anchor_stride)
    got = tanchors.inside_image_mask(grid, cfg.img_width, cfg.img_height)
    want = janchors.inside_image_mask(grid, cfg.img_width, cfg.img_height)
    assert got.dtype == bool and np.array_equal(got, want)
    assert 0 < got.sum() < got.size


def _random_gt(rng, cfg, b, g):
    x1 = rng.integers(0, cfg.img_width - 40, (b, g))
    y1 = rng.integers(0, cfg.img_height - 30, (b, g))
    w, h = rng.integers(8, 120, (b, g)), rng.integers(6, 60, (b, g))
    gt = np.stack([x1, y1, np.minimum(x1 + w, cfg.img_width - 1),
                   np.minimum(y1 + h, cfg.img_height - 1)], -1).astype(np.float32)
    valid = rng.random((b, g)) < 0.7
    valid[:, 0] = True
    valid[-1] = False  # an image without any GT
    return gt, valid


@pytest.mark.parametrize("size", [(128, 256), (375, 1024)])
def test_anchor_target_layer_exact_with_jax_uniforms(size):
    jcfg, tcfg = JConfig(), NbmConfig()
    for c in (jcfg, tcfg):
        c.img_height, c.img_width = size
    b, g = 3, 6
    gt, valid = _random_gt(np.random.default_rng(1), tcfg, b, g)
    key = jax.random.PRNGKey(3)
    jatl = jtargets.AnchorTargetLayer(jcfg)
    want = jatl(key, jnp.asarray(gt), jnp.asarray(valid))
    k_in = jatl.anchors_in.shape[0]
    u = [[np.asarray(jax.random.uniform(k, (k_in,))) for k in jax.random.split(ki)]
         for ki in jax.random.split(key, b)]
    tatl = ttargets.AnchorTargetLayer(tcfg)
    assert tatl.uniforms_shape(b) == (b, 2, k_in)
    got = tatl(_t(gt), _t(valid), uniforms=torch.tensor(np.array(u)))
    assert got.labels.dtype == torch.int32
    assert np.array_equal(got.labels.numpy(), np.asarray(want.labels))
    _assert_targets_equal(got.reg_targets.numpy(), want.reg_targets, "reg_targets")
    labels = got.labels.numpy()
    assert (labels == 1).sum() > 0 and (labels == 0).sum() > 0
    assert ((labels >= 0).sum(axis=1) <= tcfg.rpn_batchsize).all()


@pytest.mark.parametrize("n_rois", [64, 9])  # 9 + 4 GT < 16 slots: masked fill
def test_proposal_target_layer_exact_with_jax_uniforms(n_rois):
    jcfg, tcfg = tiny(JConfig), tiny(NbmConfig)
    rng = np.random.default_rng(n_rois)
    gt, valid = _random_gt(rng, tcfg, B, G)
    labels = np.where(valid, rng.integers(1, tcfg.num_classes + 1, (B, G)), 0).astype(np.int32)
    labels[0, 1] = 0  # a background GT
    # RoIs: jittered copies of the GT boxes (foreground) and random boxes
    rois, _ = _random_gt(rng, tcfg, B, n_rois)
    rois[:, : n_rois // 3] = np.round(gt[:, :1] + rng.normal(0, 4, (B, n_rois // 3, 4)))
    rois = np.clip(rois, 0, 255).astype(np.float32)
    rois[..., 2:] = np.maximum(rois[..., 2:], rois[..., :2] + 2)
    roi_valid = rng.random((B, n_rois)) < 0.8
    key = jax.random.PRNGKey(5)
    want = jtargets.proposal_target_layer(key, *map(jnp.asarray, (rois, roi_valid, gt, valid,
                                                                  labels)), jcfg)
    u = [[np.asarray(jax.random.uniform(k, (n_rois + G,))) for k in jax.random.split(ki, 3)]
         for ki in jax.random.split(key, B)]
    got = ttargets.proposal_target_layer(_t(rois), _t(roi_valid), _t(gt), _t(valid), _t(labels),
                                         tcfg, uniforms=torch.tensor(np.array(u)))
    assert got.rois.shape == (B, tcfg.rcnn_batch_size, 4)
    for name in ("rois", "labels", "ok"):
        assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name))), name
    _assert_targets_equal(got.bbox_targets.numpy(), want.bbox_targets, "bbox_targets")
    assert (got.labels.numpy() > 0).any()


# ---------------------------------------------------------------------------
# losses on JAX's inputs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def loss_inputs():
    jcfg = tiny(JConfig)
    rng = np.random.default_rng(7)
    th, tw = jcfg.top_size
    la = jcfg.n_layers * jcfg.n_ratios
    logits = rng.normal(0, 2, (B, th, tw, la, 2)).astype(np.float32)
    cls = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    reg = rng.normal(0, 0.5, (B, th, tw, la, 4)).astype(np.float32)
    batch = make_batch()
    at = jtargets.AnchorTargetLayer(jcfg)(jax.random.PRNGKey(1), jnp.asarray(batch["gt_boxes"]),
                                          jnp.asarray(batch["gt_valid"]))
    s, c = jcfg.rcnn_batch_size, jcfg.num_classes
    bbox_reg = rng.normal(0, 1, (B * s, 4 * (c + 1))).astype(np.float32)
    bbox_cls = np.asarray(jax.nn.softmax(jnp.asarray(rng.normal(0, 2, (B * s, c + 1))
                                                     .astype(np.float32)), axis=-1))
    pt_labels = rng.integers(0, c + 1, (B, s)).astype(np.int32)
    pt_targets = rng.normal(0, 0.3, (B, s, 4 * (c + 1))).astype(np.float32)
    roi_valid = rng.random((B, s)) < 0.7
    return dict(cls=cls, reg=reg, at=at, bbox_reg=bbox_reg, bbox_cls=bbox_cls,
                pt_labels=pt_labels, pt_targets=pt_targets, roi_valid=roi_valid)


@pytest.mark.parametrize("variant", ["reference", "fixed_neg_objective", "focal_loss"])
@pytest.mark.parametrize("ok", [(True, True), (True, False)])
def test_losses_match_jax(loss_inputs, variant, ok):
    li = loss_inputs
    kw = {variant: True} if variant != "reference" else {}
    jcfg, tcfg = tiny(JConfig, **kw), tiny(NbmConfig, **kw)
    ok = np.array(ok)
    want = {}
    want.update(jlosses.first_stage_loss(jnp.asarray(li["cls"]), jnp.asarray(li["reg"]), li["at"]))
    want.update(jlosses.first_stage_neg_loss(jnp.asarray(li["cls"]), jcfg))
    jpt = jtargets.ProposalTargets(rois=None, bbox_targets=jnp.asarray(li["pt_targets"]),
                                   labels=jnp.asarray(li["pt_labels"]), ok=jnp.asarray(ok))
    want.update(jlosses.second_stage_loss(jnp.asarray(li["bbox_reg"]),
                                          jnp.asarray(li["bbox_cls"]), jpt, jcfg))
    want.update(jlosses.second_stage_neg_loss(jnp.asarray(li["bbox_cls"]),
                                              jnp.asarray(li["roi_valid"])))
    want["cardinality_error"] = jlosses.cardinality_error(jnp.asarray(li["bbox_cls"]),
                                                          jnp.asarray(li["pt_labels"]))

    tat = ttargets.AnchorTargets(labels=_t(li["at"].labels), reg_targets=_t(li["at"].reg_targets))
    tpt = ttargets.ProposalTargets(rois=None, bbox_targets=_t(li["pt_targets"]),
                                   labels=_t(li["pt_labels"]), ok=_t(ok))
    got = {}
    got.update(tlosses.first_stage_loss(_t(li["cls"]), _t(li["reg"]), tat))
    got.update(tlosses.first_stage_neg_loss(_t(li["cls"]), tcfg))
    got.update(tlosses.second_stage_loss(_t(li["bbox_reg"]), _t(li["bbox_cls"]), tpt, tcfg))
    got.update(tlosses.second_stage_neg_loss(_t(li["bbox_cls"]), _t(li["roi_valid"])))
    got["cardinality_error"] = tlosses.cardinality_error(_t(li["bbox_cls"]), _t(li["pt_labels"]))
    assert sorted(got) == sorted(want)
    for k in want:
        _rel_close(got[k], want[k], 1e-5, k)
        assert float(want[k]) != 0.0 or k == "cardinality_error", k
    assert tlosses.weight_dict(tcfg) == jlosses.weight_dict(jcfg)


# ---------------------------------------------------------------------------
# whole train steps
# ---------------------------------------------------------------------------


def _flat(tree, pre=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{pre}{k}/"))
    elif hasattr(tree, "shape"):
        out[pre[:-1]] = np.asarray(tree)
    return out


def _jax_first_moments(opt_state):
    """JAX key -> Adam first moment, merged over the two optimizer groups."""
    mu = {}
    for group in opt_state[1].inner_states.values():
        mu.update(_flat(group.inner_state[0].mu))
    return mu


@pytest.fixture(scope="module")
def steps():
    """One positive and then one negative train step, JAX and port, from
    the same params, batch and uniforms."""
    jcfg, tcfg = tiny(JConfig), tiny(NbmConfig)
    key = jax.random.PRNGKey(0)
    state, tx = jloop.create_train_state(key, jcfg)
    train_step, _ = jloop.make_train_step(jcfg, tx)
    model = NbmModel(tcfg)
    weights.load_into(model, weights.params_to_state_dict(state.params, tcfg))
    trainer = tloop.Trainer(model, tcfg)
    k_in = trainer.atl.anchors_in.shape[0]
    batch = make_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: _t(v) for k, v in batch.items()}
    names = {id(p): n for n, p in model.named_parameters()}
    out = {"cfg": tcfg, "before": {k: v.clone() for k, v in model.state_dict().items()},
           "lr": {names[id(p)]: g["lr"] for g in trainer.optimizer.param_groups
                  for p in g["params"]}}
    for i, neg in enumerate((False, True)):
        sub = jax.random.fold_in(key, i)
        state, jl = train_step(state, jbatch, sub, negative_sample=neg)
        tl = trainer.train_step(tbatch, negative_sample=neg,
                                uniforms=None if neg else jax_uniforms(sub, k_in, tcfg.post_nms_topN))
        moments = {names[id(p)]: s["exp_avg"].clone() for p, s in trainer.optimizer.state.items()}
        out["neg" if neg else "pos"] = dict(
            jax_losses={k: float(v) for k, v in jl.items()},
            losses={k: float(v) for k, v in tl.items()},
            jax_sd=weights.params_to_state_dict(jax.device_get(state.params), tcfg),
            sd={k: v.clone() for k, v in model.state_dict().items()},
            jax_mu=_jax_first_moments(jax.device_get(state.opt_state)),
            mu=moments,
        )
    return out


@pytest.mark.parametrize("kind", ["pos", "neg"])
def test_train_step_losses_match_jax(steps, kind):
    s = steps[kind]
    want = s["jax_losses"]
    assert sorted(s["losses"]) == sorted(want)
    for k in want:
        _rel_close(s["losses"][k], want[k], 1e-4, k)
    assert np.isfinite(list(s["losses"].values())).all()


@pytest.mark.parametrize("kind", ["pos", "neg"])
def test_train_step_gradients_match_jax(steps, kind):
    """Adam's first moments, carried to JAX keys with the inverse key map."""
    s, cfg = steps[kind], steps["cfg"]
    km = weights.key_map(cfg)
    full = {k: s["mu"].get(k, steps["before"][k]) for k in km}  # shape filler for frozen keys
    got = weights.state_dict_to_params(full, cfg)
    checked = 0
    for tk in s["mu"]:
        jk = km[tk][0]
        want = s["jax_mu"][jk]
        err = np.abs(got[jk] - want).max()
        scale = np.abs(want).max()
        assert err <= max(2e-2 * scale, ZERO_GRAD), f"{tk}: err {err}, largest {scale}"
        checked += 1
    assert checked == len(s["mu"]) == len(steps["lr"]) > 100


@pytest.mark.parametrize("kind", ["pos", "neg"])
def test_train_step_parameters_match_jax(steps, kind):
    s, before = steps[kind], steps["before"]
    km = weights.key_map(steps["cfg"])
    n_real, diff_sum, n_entries = 0, 0.0, 0
    updates = 1 if kind == "pos" else 2
    for k, lr in steps["lr"].items():
        got, want = s["sd"][k], s["jax_sd"][k]
        d = (got - want).abs()
        assert d.max() <= updates * 2.05 * lr + 1e-6 * want.abs().max(), f"{k}: {d.max()} vs {lr}"
        if np.abs(s["jax_mu"][km[k][0]]).max() > ZERO_GRAD:
            frac = float((d > 0.05 * lr).float().mean())
            assert frac <= 0.01, f"{k}: {frac:.4f} of the entries moved apart"
            assert not torch.equal(got, before[k]), f"{k} was not updated"
            n_real += 1
            diff_sum += float(d.sum()) / lr
            n_entries += d.numel()
    assert n_real > 100
    assert diff_sum / n_entries <= 1e-3


@pytest.mark.parametrize("kind", ["pos", "neg"])
def test_train_step_batch_norm_state_matches_jax(steps, kind):
    """Live norms (inverted bottlenecks of the RPN and RCNN): running
    statistics updated as JAX merges them. Frozen norms (backbone): all
    four tensors untouched."""
    s, before = steps[kind], steps["before"]
    n_live = n_frozen = 0
    for k in before:
        if not k.endswith(("running_mean", "running_var")):
            continue
        got, want = s["sd"][k], s["jax_sd"][k]
        if ".norm." in k:
            err = (got - want).abs().max()
            assert err <= 1e-4 * want.abs().max(), f"{k}: {err}"
            assert not torch.equal(got, before[k]), f"{k}: running statistic not updated"
            n_live += 1
        else:
            base = k.rsplit(".", 1)[0]
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                assert torch.equal(s["sd"][f"{base}.{leaf}"], before[f"{base}.{leaf}"])
            n_frozen += 1
    cfg = steps["cfg"]
    assert n_live == 2 * (cfg.n_layers + cfg.depth_rcnn) and n_frozen == 2 * 53


# ---------------------------------------------------------------------------
# schedule and freezing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("count", [0, 999, 1000, 383_000, 383_999, 767_000, 1_149_000, 2_681_000])
def test_lr_schedule_matches_jax(count):
    lr_drop = 383
    for base in (1e-4, 1e-5):
        want = float(jloop.make_lr_schedule(base, lr_drop)(jnp.asarray(count, jnp.int32)))
        got = tloop.make_lr_schedule(base, lr_drop)(count)
        assert got == want, (count, got, want)
    assert tloop.make_lr_schedule(1e-4, 1)(999) == tloop.make_lr_schedule(1e-4, 1)(0)


def test_lr_backbone_zero_freezes_the_backbone():
    cfg = tiny(NbmConfig, lr_backbone=0.0)
    model = NbmModel(cfg).init_weights(torch.Generator().manual_seed(0))
    trainer = tloop.Trainer(model, cfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    losses = trainer.train_step({k: _t(v) for k, v in make_batch().items()},
                                generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(losses["total"]))
    after = model.state_dict()
    for k in before:
        if k.startswith("backbone."):
            assert torch.equal(after[k], before[k]), k
    assert all(not p.requires_grad for p in model.backbone.parameters())
    assert not torch.equal(after["head.rpn.cls_score.0.weight"],
                           before["head.rpn.cls_score.0.weight"])
    assert len(trainer.optimizer.param_groups) == 1
