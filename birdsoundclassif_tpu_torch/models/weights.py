"""Weights into and out of the port: JAX params, ``params.npz`` and
reference ``model_chkpt.pt``.

The port's modules carry the reference torch layout and state_dict keys, so
a reference checkpoint (``{"checkpoints": state_dict}``, reference:
run_detection.py:87-122) loads as it is. JAX params (a nested dict of
arrays, or the flat slash-joined keys of ``params.npz``) are mapped onto
those keys with a numpy-only copy of the JAX package's
``models/torch_convert.py`` key map (:64) and ``params_to_state_dict``
(:302), for the model families the port has:

  * conv weight HWIO -> (O, I, kh, kw)
  * linear weight (I, O) -> (O, I)
  * the two RCNN output linears also permute their input rows from the JAX
    (ph, pw, C) flatten to the reference's (C, ph, pw) (:40-52)
  * BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var

``state_dict_to_params`` is the inverse: the port's trainer writes its
checkpoints as ``params.npz`` in the JAX package's flat layout, which both
CLIs and the JAX package's ``utils/checkpoint.py:load_params`` read.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .backbone import RESNET_SPECS


def _conv_j2t(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.transpose(3, 2, 0, 1))


def _rcnn_lin_j2t(w: np.ndarray, c: int, ph: int, pw: int) -> np.ndarray:
    """(ph*pw*C, out) -> (out, C*ph*pw) with the flatten-layout permute."""
    out = w.shape[1]
    return np.ascontiguousarray(
        w.reshape(ph, pw, c, out).transpose(3, 2, 0, 1).reshape(out, c * ph * pw)
    )


def _rcnn_lin_t2j(w: np.ndarray, c: int, ph: int, pw: int) -> np.ndarray:
    """(out, C*ph*pw) -> (ph*pw*C, out), the inverse of _rcnn_lin_j2t."""
    out = w.shape[0]
    return np.ascontiguousarray(
        w.reshape(out, c, ph, pw).transpose(2, 3, 1, 0).reshape(ph * pw * c, out)
    )


def key_map(cfg, folded_bn: bool = False, folded_stem: bool = False
            ) -> Dict[str, Tuple[str, str]]:
    """-> {torch_key: (jax_path, transform)}, transform in {conv, lin,
    rcnn_lin, raw}, for ResNet backbones, the default attention pyramid,
    the plain FPN and the conv RCNN head. The flags map the trees of the
    inference folds (models/optimize.py, the JAX package's optimize.py):
    `folded_bn`, biased backbone convs and no backbone BNs (the JAX tree
    keeps them as identities, the folded port model has none);
    `folded_stem`, the stem's border term ``stem_corr`` and no
    init_conv."""
    if cfg.backbone not in RESNET_SPECS or cfg.fpn != "fpn" or cfg.tf_rcnn:
        raise ValueError(
            f"weights for backbone={cfg.backbone!r}, fpn={cfg.fpn!r}, "
            f"tf_rcnn={cfg.tf_rcnn} are not ported"
        )
    m: Dict[str, Tuple[str, str]] = {}

    def conv(tk, jk, bias=True):
        m[tk + ".weight"] = (jk + "/w", "conv")
        if bias:
            m[tk + ".bias"] = (jk + "/b", "raw")

    def lin(tk, jk):
        m[tk + ".weight"] = (jk + "/w", "lin")
        m[tk + ".bias"] = (jk + "/b", "raw")

    def bn(tk, jk):
        for t_name, j_name in (("weight", "scale"), ("bias", "bias"),
                               ("running_mean", "mean"), ("running_var", "var")):
            m[f"{tk}.{t_name}"] = (f"{jk}/{j_name}", "raw")

    def dsc(tk, jk, pe=False):
        conv(tk + ".depth_wise", jk + "/depth_wise")
        conv(tk + ".pt_wise", jk + "/pt_wise")
        bn(tk + ".norm", jk + "/norm")
        if pe:
            conv(tk + ".pe_proj", jk + "/pe_proj")

    def conv_bn(tc, jc, tn, jn):
        conv(tc, jc, bias=folded_bn)
        if not folded_bn:
            bn(tn, jn)

    # ---- backbone (Joiner '0') ----
    b, j = "backbone.0.body", "backbone/body"
    if cfg.inpt_channels != 3 and folded_stem:
        conv(b + ".stem_corr", j + "/stem_corr", bias=False)
    elif cfg.inpt_channels != 3:
        conv("backbone.0.init_conv", "backbone/init_conv")
    conv_bn(b + ".conv1", j + "/conv1", b + ".bn1", j + "/bn1")
    for stage, n_blocks in enumerate(RESNET_SPECS[cfg.backbone]["layers"]):
        for blk in range(n_blocks):
            tb = f"{b}.layer{stage + 1}.{blk}"
            jb = f"{j}/layer{stage + 1}/{blk}"
            for ci in (1, 2, 3):
                conv_bn(f"{tb}.conv{ci}", f"{jb}/conv{ci}", f"{tb}.bn{ci}", f"{jb}/bn{ci}")
            if blk == 0:
                conv_bn(f"{tb}.downsample.0", f"{jb}/downsample/conv",
                        f"{tb}.downsample.1", f"{jb}/downsample/bn")

    # ---- attention pyramid ----
    n_layers, top_n = cfg.n_layers, cfg.pyramid_top_n_attn
    attn_levels = range(n_layers) if top_n == n_layers else range(n_layers - top_n, n_layers)
    for i in attn_levels:
        for name in ("query", "key", "value", "final_projection"):
            lin(f"attn.attention_modules.{i}.{name}", f"attn/{i}/{name}")

    # ---- FPN ----
    for i in range(n_layers):
        conv(f"fpn.pt_wise.{i}", f"fpn/pt_wise/{i}")
        conv(f"fpn.out_convs.{i}", f"fpn/out_convs/{i}")

    # ---- head: RPN ----
    for i in range(n_layers):
        dsc(f"head.rpn.convs.{i}", f"head/rpn/convs/{i}")
        conv(f"head.rpn.cls_score.{i}", f"head/rpn/cls_score/{i}")
        conv(f"head.rpn.bbox_reg.{i}", f"head/rpn/bbox_reg/{i}")

    # ---- head: RCNN ----
    rc_t, rc_j = "head.fast_rcnn.rcnn", "head/rcnn"
    conv(rc_t + ".pe_proj", rc_j + "/pe_proj")
    for i in range(cfg.depth_rcnn):
        dsc(f"{rc_t}.rcnn.{i}", f"{rc_j}/blocks/{i}", pe=True)
    for name in ("bbox_reg_layer", "bbox_classif_layer"):
        m[f"{rc_t}.{name}.weight"] = (f"{rc_j}/{name}/w", "rcnn_lin")
        m[f"{rc_t}.{name}.bias"] = (f"{rc_j}/{name}/b", "raw")
    return m


def flatten_params(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict of arrays -> flat slash-joined keys (the params.npz
    format, utils/checkpoint.py:23-33 of the JAX package)."""
    if not isinstance(tree, dict):
        return {prefix[:-1]: np.asarray(tree)}
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        out.update(flatten_params(v, f"{prefix}{k}/"))
    return out


def params_to_state_dict(params: Any, cfg) -> Dict[str, torch.Tensor]:
    """JAX params (nested dict or flat slash-joined keys) -> the port's
    state_dict (float32 CPU tensors). Keys absent from `params` are left
    out. A folded tree gives the state_dict of a folded model
    (models/optimize.py), such as ``fold_inference(NbmModel(cfg))``."""
    flat = flatten_params(params)  # a flat dict passes through unchanged
    c, ph, pw = cfg.out_fpn_chan, cfg.roi_pool_h, cfg.roi_pool_w
    out: Dict[str, torch.Tensor] = {}
    folds = ("backbone/body/conv1/b" in flat, "backbone/body/stem_corr/w" in flat)
    for tk, (jk, kind) in key_map(cfg, *folds).items():
        if jk not in flat:
            continue
        v = np.asarray(flat[jk], dtype=np.float32)
        if kind == "conv":
            v = _conv_j2t(v)
        elif kind == "lin":
            v = np.ascontiguousarray(v.T)
        elif kind == "rcnn_lin":
            v = _rcnn_lin_j2t(v, c, ph, pw)
        out[tk] = torch.from_numpy(np.array(v))
    return out


def state_dict_to_params(state_dict: Dict[str, torch.Tensor], cfg) -> Dict[str, np.ndarray]:
    """The port's state_dict -> JAX params as flat slash-joined keys
    (float32 numpy, the ``params.npz`` layout); the inverse of
    params_to_state_dict (of a folded model too). Every key of the map
    must be present."""
    c, ph, pw = cfg.out_fpn_chan, cfg.roi_pool_h, cfg.roi_pool_w
    out: Dict[str, np.ndarray] = {}
    folds = ("backbone.0.body.conv1.bias" in state_dict,
             "backbone.0.body.stem_corr.weight" in state_dict)
    for tk, (jk, kind) in key_map(cfg, *folds).items():
        if tk not in state_dict:
            raise KeyError(f"state_dict has no '{tk}' (JAX key '{jk}')")
        v = state_dict[tk].detach().to("cpu", torch.float32).numpy()
        if kind == "conv":
            v = np.ascontiguousarray(v.transpose(2, 3, 1, 0))
        elif kind == "lin":
            v = np.ascontiguousarray(v.T)
        elif kind == "rcnn_lin":
            v = _rcnn_lin_t2j(v, c, ph, pw)
        out[jk] = np.array(v)
    return out


def load_into(model: torch.nn.Module, state_dict: Dict[str, torch.Tensor]) -> None:
    """Copy `state_dict` into `model`. Keys the model lacks (such as
    BatchNorm's num_batches_tracked) are ignored; keys absent from the
    checkpoint keep the model's values, the reference's partial merge
    (nbm_model.py:325-341), and are reported. A shape mismatch raises."""
    own = model.state_dict()
    missing = [k for k in own if k not in state_dict]
    for k, v in state_dict.items():
        if k not in own:
            continue
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(
                f"checkpoint/config mismatch for '{k}': checkpoint {tuple(v.shape)}, "
                f"model {tuple(own[k].shape)}"
            )
        with torch.no_grad():
            own[k].copy_(v.to(dtype=own[k].dtype))
    if missing:
        print(f"weights: {len(missing)} keys absent from checkpoint (e.g. {missing[:3]})")


def load_params(model_dir: str, cfg) -> Dict[str, torch.Tensor]:
    """State_dict from a checkpoint directory: ``params.npz`` (JAX flat
    keys) first, then a reference ``model_chkpt.pt``."""
    npz = os.path.join(model_dir, "params.npz")
    if os.path.exists(npz):
        with np.load(npz) as data:
            return params_to_state_dict({k: data[k] for k in data.files}, cfg)
    pt = os.path.join(model_dir, "model_chkpt.pt")
    if os.path.exists(pt):
        ckpt = torch.load(pt, map_location="cpu", weights_only=True)
        return ckpt["checkpoints"] if "checkpoints" in ckpt else ckpt
    raise FileNotFoundError(
        f"no params.npz or model_chkpt.pt in {model_dir} (orbax checkpoints are not "
        f"read by the PyTorch port yet)"
    )
