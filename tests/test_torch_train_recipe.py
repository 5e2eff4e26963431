"""PyTorch port: the production training recipe held against the JAX package
on the CPU: gradient accumulation, the live-BN backbone, remat, and the
inference fold of a live-BN model.

Tiny float32 config of tests/test_torch_train.py (ResNet-50 at 128x256,
out_fpn_chan 16, depth_rcnn 1, 6 classes, pre/post NMS 256/64). JAX params
from create_train_state(PRNGKey(0)) go into the port with models/weights.py;
both sides get the same numpy batch of 4. With grad_accum_steps 2 the JAX
step splits its key into one key a microbatch (jax.random.split(key, 2)),
and the port is handed the uniforms each of those keys draws.

Tolerances are test_torch_train.py's: losses 1e-4 relative; Adam's first
moments 2e-2 of each tensor's largest magnitude (or 1e-9 where the gradient
is analytically zero); parameters within k x 2.05 lr after k updates, at
most 1 % of a tensor's entries 0.05 lr apart, 1e-3 lr apart on average;
running statistics 1e-4 of their largest magnitude. Remat against no remat
on the port alone, as the JAX package's tests/test_remat.py holds its own:
losses 2e-5 relative (1e-6 absolute), parameters 1e-4 relative (1e-6
absolute). Folded weights: test_torch_fold.py's 1e-6 of each tensor's
largest magnitude.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from birdsoundclassif_tpu.config import NbmConfig as JConfig
from birdsoundclassif_tpu.models import optimize as jopt
from birdsoundclassif_tpu.train import loop as jloop
from birdsoundclassif_tpu_torch.config import NbmConfig
from birdsoundclassif_tpu_torch.models import optimize as topt
from birdsoundclassif_tpu_torch.models import rpn as trpn
from birdsoundclassif_tpu_torch.models import weights
from birdsoundclassif_tpu_torch.models.detector import NbmModel
from birdsoundclassif_tpu_torch.models.nn import BatchNorm2d
from birdsoundclassif_tpu_torch.train import loop as tloop
from test_torch_fold import assert_close, jax_tree
from test_torch_train import ZERO_GRAD, _flat, _rel_close, _t, jax_uniforms, tiny

B, G, A = 4, 4, 2
LIVE = {"norm_layer_backbone": "batchnorm"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs several pytest workers at once: torch's own pool of one
    thread a core in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_batch(seed=0, b=B):
    rng = np.random.default_rng(seed)
    gt = np.zeros((b, G, 4), np.float32)
    gt[:, 0] = [30.0, 20.0, 120.0, 60.0]
    gt[:, 1] = [140.0, 30.0, 200.0, 90.0]
    gt[1::2, 2] = [60.0, 70.0, 90.0, 120.0]
    valid = np.zeros((b, G), bool)
    valid[:, :2] = True
    valid[1::2, 2] = True
    labels = np.where(valid, np.array([[3, 5, 2, 0]] * b), 0).astype(np.int32)
    return {"img": rng.random((b, 128, 256), dtype=np.float32),
            "neg_img": rng.random((b, 128, 256), dtype=np.float32),
            "gt_boxes": gt, "gt_valid": valid, "gt_labels": labels}


def _jax_first_moments(opt_state):
    """JAX key -> Adam first moment, merged over the two optimizer groups
    (the clip, when on, chains in front of them)."""
    groups = opt_state if hasattr(opt_state, "inner_states") else opt_state[1]
    mu = {}
    for group in groups.inner_states.values():
        mu.update(_flat(group.inner_state[0].mu))
    return mu


def micro_uniforms(key, k_in, n_rois):
    """The uniforms of each microbatch of JAX's accumulated step."""
    return [jax_uniforms(k, k_in, n_rois, b=B // A) for k in jax.random.split(key, A)]


def run_both(steps, **kw):
    """JAX and port from the same params and batch, the port handed JAX's
    uniforms; `steps` lists negative_sample per step. Also records what the
    port's trainer merges into the running statistics each step."""
    jcfg, tcfg = tiny(JConfig, **kw), tiny(NbmConfig, **kw)
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
    mod_names = {m: n for n, m in model.named_modules()}
    out = {"cfg": tcfg, "model": model,
           "before": {k: v.clone() for k, v in model.state_dict().items()},
           "lr": {names[id(p)]: g["lr"] for g in trainer.optimizer.param_groups
                  for p in g["params"]}, "steps": []}
    real_mean = tloop._mean_updates
    merged = []

    def recording_mean(per_micro):
        merged.append(([{mod_names[m]: (u[m][0].clone(), u[m][1].clone()) for m in u}
                        for u in per_micro],
                       {mod_names[m]: (m.running_mean.clone(), m.running_var.clone())
                        for m in per_micro[0]}))
        return real_mean(per_micro)

    tloop._mean_updates = recording_mean
    try:
        for i, neg in enumerate(steps):
            sub = jax.random.fold_in(key, i)
            state, jl = train_step(state, jbatch, sub, negative_sample=neg)
            uniforms = None
            if not neg:
                uniforms = (micro_uniforms(sub, k_in, tcfg.post_nms_topN)
                            if tcfg.grad_accum_steps > 1
                            else jax_uniforms(sub, k_in, tcfg.post_nms_topN, b=B))
            tl = trainer.train_step(tbatch, negative_sample=neg, uniforms=uniforms)
            out["steps"].append(dict(
                jax_losses={k: float(v) for k, v in jl.items()},
                losses={k: float(v) for k, v in tl.items()},
                jax_sd=weights.params_to_state_dict(jax.device_get(state.params), tcfg),
                sd={k: v.clone() for k, v in model.state_dict().items()},
                jax_mu=_jax_first_moments(jax.device_get(state.opt_state)),
                mu={names[id(p)]: s["exp_avg"].clone()
                    for p, s in trainer.optimizer.state.items()},
                merged=merged[-1]))
    finally:
        tloop._mean_updates = real_mean
    return out


@pytest.fixture(scope="module")
def accum():
    """grad_accum_steps 2 (frozen-BN backbone): one positive, one negative
    step."""
    return run_both([False, True], grad_accum_steps=A)


@pytest.fixture(scope="module")
def live_frozen():
    """grad_accum_steps 2 with a live-BN backbone at lr_backbone 0: one
    positive step. (Float32 rounding in a live backbone trained by such
    small microbatches is itself above test_torch_train.py's tolerances
    from the second step on: test_live_backbone_step_matches_jax.)"""
    return run_both([False], grad_accum_steps=A, lr_backbone=0.0, **LIVE)


@pytest.fixture(scope="module")
def live():
    """A live-BN backbone that trains: one positive step, without the
    gradient clip (see test_live_backbone_step_matches_jax)."""
    return run_both([False], clip_max_norm=0.0, **LIVE)


def _check_losses(s):
    want = s["jax_losses"]
    assert sorted(s["losses"]) == sorted(want)
    for k in want:
        _rel_close(s["losses"][k], want[k], 1e-4, k)


def _moment_errors(s, cfg, before):
    """{state_dict key: (largest |port - JAX| first moment, JAX's largest
    magnitude, JAX's, port's)} over the trainable tensors."""
    km = weights.key_map(cfg)
    full = {k: s["mu"].get(k, before[k]) for k in km}
    got = weights.state_dict_to_params(full, cfg)
    out = {}
    for tk in s["mu"]:
        want = s["jax_mu"][km[tk][0]]
        out[tk] = (np.abs(got[km[tk][0]] - want).max(), np.abs(want).max(), want,
                   got[km[tk][0]])
    return out


def _check_moments(s, cfg, before, keys=None):
    errs = _moment_errors(s, cfg, before)
    for tk in keys if keys is not None else errs:
        err, scale, _, _ = errs[tk]
        assert err <= max(2e-2 * scale, ZERO_GRAD), f"{tk}: err {err}, largest {scale}"
    return len(errs)


def _check_params(s, lrs, before, km, updates):
    n_real, diff_sum, n_entries = 0, 0.0, 0
    for k, lr in lrs.items():
        got, want = s["sd"][k], s["jax_sd"][k]
        d = (got - want).abs()
        assert d.max() <= updates * 2.05 * lr + 1e-6 * want.abs().max(), f"{k}: {d.max()}"
        if np.abs(s["jax_mu"][km[k][0]]).max() > ZERO_GRAD:
            assert float((d > 0.05 * lr).float().mean()) <= 0.01, k
            assert not torch.equal(got, before[k]), f"{k} was not updated"
            n_real += 1
            diff_sum += float(d.sum()) / lr
            n_entries += d.numel()
    assert diff_sum / n_entries <= 1e-3
    return n_real


def _running_keys(sd):
    return [k for k in sd if k.endswith(("running_mean", "running_var"))]


def _check_running_stats(s, before, keys):
    for k in keys:
        got, want = s["sd"][k], s["jax_sd"][k]
        err = (got - want).abs().max()
        assert err <= 1e-4 * want.abs().max(), f"{k}: {err}"
        assert not torch.equal(got, before[k]), f"{k}: running statistic not updated"


def _live_keys(sd):
    return [k for k in _running_keys(sd) if ".norm." in k]


# ---------------------------------------------------------------------------
# gradient accumulation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", [0, 1], ids=["positive", "negative"])
def test_accumulated_step_losses_match_jax(accum, kind):
    _check_losses(accum["steps"][kind])


@pytest.mark.parametrize("kind", [0, 1], ids=["positive", "negative"])
def test_accumulated_step_gradients_match_jax(accum, kind):
    n = _check_moments(accum["steps"][kind], accum["cfg"], accum["before"])
    assert n == len(accum["lr"]) > 100


@pytest.mark.parametrize("kind", [0, 1], ids=["positive", "negative"])
def test_accumulated_step_parameters_match_jax(accum, kind):
    km = weights.key_map(accum["cfg"])
    assert _check_params(accum["steps"][kind], accum["lr"], accum["before"], km,
                         updates=kind + 1) > 100


@pytest.mark.parametrize("kind", [0, 1], ids=["positive", "negative"])
def test_accumulated_step_running_stats_match_jax(accum, kind):
    """The live norms of the RPN and RCNN blocks: the mean over the
    microbatches of what each computed from the same starting statistics,
    merged once after the update. The frozen backbone norms stay."""
    s, before, cfg = accum["steps"][kind], accum["before"], accum["cfg"]
    live = _live_keys(before)
    assert len(live) == 2 * (cfg.n_layers + cfg.depth_rcnn)
    _check_running_stats(s, before, live)
    for k in set(_running_keys(before)) - set(live):
        assert torch.equal(s["sd"][k], before[k]), k
    per_micro, _ = s["merged"]
    assert len(per_micro) == A and len(per_micro[0]) == cfg.n_layers + cfg.depth_rcnn


def _sequential_worst(s):
    """The step's microbatch statistics applied one after another, as
    torch's in-place update would, instead of averaged: the worst running
    variance against JAX's, over its tensor's largest magnitude."""
    per_micro, start = s["merged"]
    m = BatchNorm2d.momentum
    worst = 0.0
    for name, (_, var0) in start.items():
        var = var0
        for u in per_micro:
            # u = (1 - m) var0 + m s_i: the microbatch's own statistic s_i
            var = (1 - m) * var + (u[name][1] - (1 - m) * var0)
        want = s["jax_sd"][f"{name}.running_var"]
        worst = max(worst, float((var - want).abs().max() / want.abs().max()))
    return worst


@pytest.mark.parametrize("fixture", ["accum", "live_frozen"])
def test_sequential_batch_norm_updates_break_the_running_var_check(request, fixture):
    """The control: the positive step's running variances with the
    microbatches' updates applied in turn miss JAX's by far more than the
    1e-4 limit the averaged ones meet."""
    assert _sequential_worst(request.getfixturevalue(fixture)["steps"][0]) > 10 * 1e-4


# ---------------------------------------------------------------------------
# the live-BN backbone
# ---------------------------------------------------------------------------


def test_live_backbone_accumulated_at_lr_backbone_zero_matches_jax(live_frozen):
    """norm_layer_backbone="batchnorm", lr_backbone 0, accumulation 2: the
    whole backbone, the norms' affines too, leaves the optimizer on both
    sides and keeps its values, while all 59 norms' running statistics
    (53 of the backbone) take the microbatches' mean as JAX merges them
    (freeze_mask zeroes and restores mean and var, then merge_bn_updates
    writes them). Everything at test_torch_train.py's tolerances."""
    r = live_frozen
    s, before, cfg = r["steps"][0], r["before"], r["cfg"]
    _check_losses(s)
    keys = _running_keys(before)
    assert len(keys) == 2 * (53 + cfg.n_layers + cfg.depth_rcnn)
    _check_running_stats(s, before, keys)
    assert not any(k.startswith("backbone.") for k in r["lr"])
    for k in before:
        if k.startswith("backbone.") and k not in keys:
            assert torch.equal(s["sd"][k], before[k]), k
            assert np.array_equal(s["jax_sd"][k].numpy(), before[k].numpy()), k
    _check_moments(s, cfg, before)
    assert _check_params(s, r["lr"], before, weights.key_map(cfg), updates=1) > 20
    assert all(not p.requires_grad for p in r["model"].backbone.parameters())
    assert isinstance(r["model"].backbone[0].body.layer1[0].bn1, BatchNorm2d)


def test_live_backbone_step_matches_jax(live):
    """A live-BN backbone that trains, one step. Losses, all running
    statistics and the gradients outside the backbone at test_torch_train.py's
    tolerances. The backbone's gradients are held per tensor in relative L2
    norm to 0.1: through 53 training-mode norms each backward pass
    subtracts the batch means of the gradient, and at this tiny size (two
    microbatch images of 128x256, 4x8 positions at layer4) float32
    rounding leaves the port's own backbone gradients 0.8 % apart (median
    over tensors, up to 2.4 %) between one and six CPU threads, and JAX's
    2.3 % (up to 3.3 %); a wrong batch-norm backward moves them by order 1.
    For the same reason the gradient clip is off here: its global norm,
    which those gradients dominate, scales every other gradient; and the
    parameters are not compared entry by entry, since Adam's first update
    turns each gradient entry's sign into a step of lr. The backbone
    norms' affines train in the backbone group."""
    s, before, cfg = live["steps"][0], live["before"], live["cfg"]
    _check_losses(s)
    _check_running_stats(s, before, _running_keys(before))
    errs = _moment_errors(s, cfg, before)
    rest = [k for k in errs if not k.startswith("backbone.")]
    _check_moments(s, cfg, before, rest)
    n_backbone = 0
    for k in errs:
        if k.startswith("backbone."):
            _, scale, want, got = errs[k]
            if scale > ZERO_GRAD:
                rel = np.linalg.norm(got - want) / np.linalg.norm(want)
                assert rel <= 0.1, f"{k}: relative L2 {rel}"
                assert not torch.equal(s["sd"][k], before[k]), f"{k} was not updated"
                n_backbone += 1
    assert n_backbone == 53 * 3 + 2  # every conv and norm affine, init_conv's two
    assert live["lr"]["backbone.0.body.layer1.0.bn1.weight"] == cfg.lr_backbone
    assert live["lr"]["backbone.0.body.layer1.0.bn1.bias"] == cfg.lr_backbone


def test_folded_live_batch_norm_model_matches_jax_fold(live):
    """A model trained with live backbone norms folds as JAX's
    fold_inference folds it: the norms' running statistics and affines go
    into the convs (at inference a live norm is the same affine constant
    as a frozen one)."""
    cfg = live["cfg"]
    jcfg = tiny(JConfig, **LIVE)
    model = live["model"].eval()
    want = weights.params_to_state_dict(
        jopt.fold_inference(jax_tree(model.state_dict(), jcfg), jcfg), cfg)
    got = topt.fold_inference(model, cfg).state_dict()
    assert sorted(got) == sorted(want)
    assert "backbone.0.body.layer1.0.bn1.weight" not in got
    for k in want:
        assert_close(got[k].numpy(), want[k].numpy(), k)


# ---------------------------------------------------------------------------
# remat: the port against itself
# ---------------------------------------------------------------------------


def port_step(remat, neg=False):
    """One step of the live-BN tiny config with accumulation 2 from seeded
    weights; counts the proposal layer's NMS calls."""
    kw = dict(grad_accum_steps=A, **LIVE)
    if remat != "none":
        kw.update(remat_backbone=True, remat_granularity=remat)
    cfg = tiny(NbmConfig, **kw)
    model = NbmModel(cfg).init_weights(torch.Generator().manual_seed(0))
    trainer = tloop.Trainer(model, cfg)
    calls = []
    real = trpn.greedy_nms_prefix

    def counting(*a):
        calls.append(a[0].shape)
        return real(*a)

    trpn.greedy_nms_prefix = counting
    try:
        losses = trainer.train_step({k: _t(v) for k, v in make_batch().items()},
                                    negative_sample=neg,
                                    generator=torch.Generator().manual_seed(5))
    finally:
        trpn.greedy_nms_prefix = real
    return ({k: float(v) for k, v in losses.items()},
            {k: v.clone() for k, v in model.state_dict().items()}, len(calls))


@pytest.fixture(scope="module")
def no_remat():
    return port_step("none")


@pytest.mark.parametrize("remat", ["trunk", "stages", "blocks"])
def test_remat_matches_no_remat(no_remat, remat):
    """Losses and parameters as without remat; running statistics, which
    the recompute must not record again, as without remat too; and one
    proposal NMS a microbatch, none in the recompute."""
    want_l, want_sd, want_calls = no_remat
    got_l, got_sd, calls = port_step(remat)
    assert calls == want_calls == A
    for k in want_l:
        np.testing.assert_allclose(got_l[k], want_l[k], rtol=2e-5, atol=1e-6, err_msg=k)
    for k in want_sd:
        np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    before = NbmModel(tiny(NbmConfig, **LIVE)).init_weights(
        torch.Generator().manual_seed(0)).state_dict()
    for k in _running_keys(want_sd):
        assert not torch.equal(got_sd[k], before[k]), k
        np.testing.assert_allclose(got_sd[k].numpy(), want_sd[k].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
