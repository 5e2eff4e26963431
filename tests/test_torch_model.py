"""PyTorch port: the detector, stage by stage, held against the JAX package.

Tiny config (the structure of __graft_entry__.py's dry run): ResNet-50,
128x256 windows, out_fpn_chan 16, fpn_p_chan 24, depth_rcnn 1, 6 classes,
float32 compute. JAX params from NbmModel.init(PRNGKey(0)) are carried into
the port with models/weights.py; both get the same numpy windows.

Float stages are compared at a relative tolerance of 1e-4 of the tensor's
largest magnitude (float32 convolutions summed in another order). The
integer logic is fed JAX's own float inputs and must then agree EXACTLY:
proposal_layer's boxes, scores and masks, and fast_rcnn_inference's boxes,
classes, scores and valid mask.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from birdsoundclassif_tpu.config import NbmConfig as JConfig
from birdsoundclassif_tpu.models import attention as jattn
from birdsoundclassif_tpu.models import backbone as jbackbone
from birdsoundclassif_tpu.models import fpn as jfpn
from birdsoundclassif_tpu.models import rcnn as jrcnn
from birdsoundclassif_tpu.models import roi as jroi
from birdsoundclassif_tpu.models import rpn as jrpn
from birdsoundclassif_tpu.models.detector import NbmModel as JModel
from birdsoundclassif_tpu_torch.config import NbmConfig
from birdsoundclassif_tpu_torch.models import rcnn as trcnn
from birdsoundclassif_tpu_torch.models import roi as troi
from birdsoundclassif_tpu_torch.models import rpn as trpn
from birdsoundclassif_tpu_torch.models import weights
from birdsoundclassif_tpu_torch.models.detector import NbmModel

REL = 1e-4


def tiny(cls):
    cfg = cls()
    cfg.num_classes = 6
    cfg.out_fpn_chan = 16
    cfg.fpn_p_chan = 24
    cfg.depth_rcnn = 1
    cfg.img_height, cfg.img_width = 128, 256
    cfg.compute_dtype = "float32"
    return cfg


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= REL * max(1.0, np.abs(want).max()), f"{what}: max abs err {err}"


def _nchw(x):
    return np.asarray(x).transpose(0, 3, 1, 2)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = tiny(JConfig), tiny(NbmConfig)
    params = JModel.init(jax.random.PRNGKey(0), jcfg)
    model = NbmModel(tcfg)
    weights.load_into(model, weights.params_to_state_dict(params, tcfg))
    model.eval()
    x = np.random.default_rng(0).random((2, 128, 256), dtype=np.float32)

    @jax.jit
    def stages(p, w):
        feats, pos = jbackbone.backbone_apply(p["backbone"], w[..., None], jcfg)
        attn = jattn.sa_pyramid_apply(p["attn"], feats, jcfg.pyramid_top_n_attn)
        fpn = jfpn.build_fpn_apply(p["fpn"], jcfg, attn, False, None)
        cls, reg = jrpn.rpn_apply(p["head"]["rpn"], fpn, jcfg)
        props = jrpn.proposal_layer(cls, reg, jcfg)
        pooled, pe, level = jroi.roi_pool(props.rois, fpn, jcfg)
        bbox_reg, bbox_cls = jrcnn.rcnn_apply(p["head"]["rcnn"], pooled, pe)
        det = jrcnn.fast_rcnn_inference(bbox_reg, bbox_cls, props.rois, props.valid, jcfg,
                                        0.3, 0.0)
        return dict(feats=feats, pos=pos, attn=attn, fpn=fpn, cls=cls, reg=reg, props=props,
                    pooled=pooled, pe=pe, level=level, bbox_reg=bbox_reg,
                    bbox_cls=bbox_cls, det=det)

    out = jax.tree_util.tree_map(np.array, stages(params, jnp.asarray(x)))  # writable copies
    return jcfg, tcfg, params, model, x, out


def test_trunk_and_rpn(setup):
    _, _, _, model, x, want = setup
    with torch.inference_mode():
        feats = model.backbone[0](torch.from_numpy(x)[:, None])
        attn = model.attn(feats)
        fpn = model.fpn(attn)
        cls, reg = model.head.rpn(fpn)
    pos = model.backbone[0].position_embeddings(feats)
    for name, got in (("feats", feats), ("pos", pos), ("attn", attn), ("fpn", fpn)):
        for lv, (g, w) in enumerate(zip(got, want[name])):
            _close(g.numpy(), _nchw(w), f"{name}[{lv}]")
    _close(cls.numpy(), want["cls"], "rpn cls")
    _close(reg.numpy(), want["reg"], "rpn reg")


def test_proposal_layer_exact_on_jax_inputs(setup):
    _, tcfg, _, _, _, want = setup
    got = trpn.proposal_layer(torch.from_numpy(want["cls"]), torch.from_numpy(want["reg"]), tcfg)
    for f in ("rois", "scores", "valid", "rpn_ok"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(want["props"], f),
                                      err_msg=f)
    assert want["props"].valid.sum() > 0


def test_roi_pool_and_rcnn_head(setup):
    _, tcfg, _, model, _, want = setup
    fpn = [torch.from_numpy(_nchw(f)) for f in want["fpn"]]
    pooled, pe, level = troi.roi_pool(torch.from_numpy(want["props"].rois), fpn, tcfg)
    np.testing.assert_array_equal(level.numpy(), want["level"])
    _close(pooled.numpy(), want["pooled"], "roi pooled")
    _close(pe.numpy(), want["pe"], "roi pe")
    with torch.inference_mode():
        bbox_reg, bbox_cls = model.head.fast_rcnn.rcnn(torch.from_numpy(want["pooled"]),
                                                       torch.from_numpy(want["pe"]))
    _close(bbox_reg.numpy(), want["bbox_reg"], "rcnn bbox_reg")
    _close(bbox_cls.numpy(), want["bbox_cls"], "rcnn bbox_classes")


@pytest.mark.parametrize("min_score", [0.0, 0.2])
def test_fast_rcnn_inference_exact_on_jax_inputs(setup, min_score):
    jcfg, tcfg, _, _, _, want = setup
    props = want["props"]
    jdet = jrcnn.fast_rcnn_inference(jnp.asarray(want["bbox_reg"]), jnp.asarray(want["bbox_cls"]),
                                     jnp.asarray(props.rois), jnp.asarray(props.valid), jcfg,
                                     0.3, min_score)
    got = trcnn.fast_rcnn_inference(
        torch.from_numpy(want["bbox_reg"]), torch.from_numpy(want["bbox_cls"]),
        torch.from_numpy(props.rois), torch.from_numpy(props.valid), tcfg, 0.3, min_score)
    for f in ("boxes", "scores", "classes", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(jdet, f)),
                                      err_msg=f)


def test_params_npz_and_model_chkpt(setup, tmp_path):
    """Both checkpoint formats load into the port with the converter's
    values, and a checkpoint the port writes reads back in the JAX package."""
    from birdsoundclassif_tpu.models.torch_convert import (
        convert_torch_checkpoint, params_to_state_dict)
    from birdsoundclassif_tpu.utils.checkpoint import _flatten, save_params

    jcfg, tcfg, params, model, _, _ = setup
    want = {k: torch.from_numpy(np.array(v)) for k, v in params_to_state_dict(params, jcfg).items()}
    assert set(want) == set(model.state_dict())

    npz_dir = tmp_path / "npz"
    save_params(str(npz_dir), params)
    got = weights.load_params(str(npz_dir), tcfg)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)

    pt_dir = tmp_path / "pt"
    os.makedirs(pt_dir)
    torch.save({"checkpoints": model.state_dict()}, pt_dir / "model_chkpt.pt")
    got = weights.load_params(str(pt_dir), tcfg)
    fresh = NbmModel(tcfg)
    weights.load_into(fresh, got)
    for k, v in fresh.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=0, atol=0, msg=k)
    back = _flatten(convert_torch_checkpoint(str(pt_dir / "model_chkpt.pt"), jcfg, params))
    for k, v in _flatten(params).items():
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(v), err_msg=k)


def test_random_init_is_seeded(setup):
    _, tcfg, _, _, _, _ = setup
    a = NbmModel(tcfg).init_weights(torch.Generator().manual_seed(3)).state_dict()
    b = NbmModel(tcfg).init_weights(torch.Generator().manual_seed(3)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.isfinite(v).all() for v in a.values())


def test_bf16_trunk_close_to_jax(setup):
    """compute_dtype="bfloat16" (the flagship default): the same casts at
    the same places. bf16 keeps 8 bits of mantissa and 50-odd layers round
    in another order, so the FPN levels may drift by a few percent of their
    largest magnitude: tolerance 0.1 relative, and 0.02 absolute on the
    (float32-headed) RPN objectness probabilities."""
    _, _, params, _, x, _ = setup
    jcfg, tcfg = tiny(JConfig), tiny(NbmConfig)
    jcfg.compute_dtype = tcfg.compute_dtype = "bfloat16"
    model = NbmModel(tcfg)
    weights.load_into(model, weights.params_to_state_dict(params, tcfg))
    model.eval()

    @jax.jit
    def trunk(p, w):
        feats, _ = jbackbone.backbone_apply(p["backbone"], w[..., None].astype(jnp.bfloat16), jcfg)
        attn = jattn.sa_pyramid_apply(p["attn"], feats, jcfg.pyramid_top_n_attn)
        fpn = jfpn.build_fpn_apply(p["fpn"], jcfg, attn, False, None)
        return fpn, jrpn.rpn_apply(p["head"]["rpn"], fpn, jcfg)[0]

    fpn_j, cls_j = trunk(params, jnp.asarray(x))
    with torch.inference_mode():
        feats = model.backbone[0](torch.from_numpy(x)[:, None].to(torch.bfloat16))
        fpn_t = model.fpn(model.attn(feats))
        cls_t = model.head.rpn(fpn_t)[0]
    for lv, (g, w) in enumerate(zip(fpn_t, fpn_j)):
        assert g.dtype == torch.bfloat16
        g, w = g.float().numpy(), _nchw(np.asarray(w, np.float32))
        assert np.abs(g - w).max() <= 0.1 * np.abs(w).max(), f"fpn[{lv}]"
    np.testing.assert_allclose(cls_t.numpy(), np.asarray(cls_j), atol=0.02, rtol=0)
