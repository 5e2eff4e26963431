"""PyTorch port: the inference folds and mp3 decode, held against the JAX
package on the CPU.

Tiny config of tests/test_torch_pipeline.py (ResNet-50 at 128x256, 6
classes); weights from the port's seeded init (the JAX package's
distributions) with non-trivial batch-norm statistics and init_conv biases
drawn with numpy (the folds are identities on mean 0 / var 1 BNs), carried
into a JAX params tree with models/weights.py.

Tolerances:
  * folded weights, float32: within 1e-6 of each tensor's largest
    magnitude. The fold's operations are the JAX package's, in its order,
    but XLA's float32 rsqrt on the CPU is not torch's: the two differ by
    up to 2 ulp (each within 1 ulp of the correctly rounded value), so a
    folded weight differs by up to 4 ulp (2.1e-7 of its tensor's largest
    magnitude seen), and a folded bias, a difference that may cancel, by
    more ulp of a small value. The composed stem is a three-term sum per
    entry;
  * whole-file detections, float32: the PERF.md section 2 bar (species,
    count and order exact, boxes within 1 px, scores within 1e-4);
  * bf16 trunk (FPN levels): 0.1 of each level's largest magnitude, as in
    tests/test_torch_model.py;
  * mp3 decode: bit for bit.
"""

import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from birdsoundclassif_tpu.audio import mp3 as jmp3
from birdsoundclassif_tpu.audio import wavio as jwavio
from birdsoundclassif_tpu.audio.frontend import SpectrogramFrontend as JFrontend
from birdsoundclassif_tpu.config import NbmConfig as JConfig
from birdsoundclassif_tpu.infer import pipeline as jpipe
from birdsoundclassif_tpu.models import attention as jattn
from birdsoundclassif_tpu.models import backbone as jbackbone
from birdsoundclassif_tpu.models import fpn as jfpn
from birdsoundclassif_tpu.models import optimize as jopt
from birdsoundclassif_tpu_torch.audio import mp3 as tmp3
from birdsoundclassif_tpu_torch.audio import wavio as twavio
from birdsoundclassif_tpu_torch.audio.frontend import SpectrogramFrontend
from birdsoundclassif_tpu_torch.config import NbmConfig
from birdsoundclassif_tpu_torch.infer import pipeline as tpipe
from birdsoundclassif_tpu_torch.models import optimize as topt
from birdsoundclassif_tpu_torch.models import weights
from birdsoundclassif_tpu_torch.models.detector import NbmModel
from test_torch_pipeline import assert_same_detections, tiny, write_wav

REL = 1e-6

needs_mp3 = pytest.mark.skipif(
    not (jmp3.mpg123_available() and jmp3.lame_available()),
    reason="libmpg123/libmp3lame not present",
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs 6 workers on 8 cores: torch's default pool of one thread
    a core in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_state_dict(cfg, seed=0):
    """The unfolded port's weights: its seeded init, then the backbone BNs'
    statistics and affines and the init_conv bias drawn with numpy."""
    model = NbmModel(cfg).init_weights(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed + 1)
    sd = model.state_dict()
    for k, v in sd.items():
        if k.startswith("backbone.") and (".bn" in k or "downsample.1" in k):
            ch = v.shape[0]
            draw = {"running_mean": lambda: rng.normal(size=ch, scale=0.1),
                    "running_var": lambda: 1.0 + rng.uniform(size=ch),
                    "weight": lambda: rng.normal(size=ch, loc=1.0, scale=0.1),
                    "bias": lambda: rng.normal(size=ch, scale=0.1)}[k.rsplit(".", 1)[1]]
            v.copy_(torch.from_numpy(draw().astype(np.float32)))
    sd["backbone.0.init_conv.bias"].copy_(torch.tensor([0.5, -0.3, 0.2]))
    return sd


def jax_tree(sd, cfg):
    """A port state_dict as a nested JAX params tree."""
    tree = {}
    for k, v in weights.state_dict_to_params(sd, cfg).items():
        *path, leaf = k.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def port_model(sd, cfg):
    model = NbmModel(cfg)
    weights.load_into(model, sd)
    return model.eval()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg, tcfg = tiny(JConfig), tiny(NbmConfig)
    sd = seeded_state_dict(tcfg)
    params = jax_tree(sd, jcfg)
    model = port_model(sd, tcfg)
    wav = tmp_path_factory.mktemp("fold") / "night.wav"
    write_wav(wav)
    samples = twavio.load_audio_raw(str(wav))
    return jcfg, tcfg, params, model, samples


def assert_close(got: np.ndarray, want: np.ndarray, what: str) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32, what
    err = np.abs(got - want).max()
    assert err <= REL * np.abs(want).max(), f"{what}: max abs err {err}"


@pytest.mark.parametrize("fold", ["fold_frozen_bn", "fold_init_conv", "fold_inference"])
def test_folded_weights_match_jax(setup, fold):
    """Each fold of the port against the JAX package's on the same tree,
    tensor by tensor; the JAX tree keeps folded BNs as exact identities."""
    jcfg, tcfg, params, model, _ = setup
    before = {k: v.clone() for k, v in model.state_dict().items()}
    want_tree = getattr(jopt, fold)(params, jcfg)
    got = getattr(topt, fold)(model, tcfg).state_dict()
    want = weights.params_to_state_dict(want_tree, tcfg)
    assert sorted(got) == sorted(want)
    if fold != "fold_frozen_bn":
        assert "backbone.0.body.stem_corr.weight" in got and "backbone.0.init_conv.weight" not in got
    if fold != "fold_init_conv":
        assert "backbone.0.body.layer1.0.bn1.weight" not in got
        assert "backbone.0.body.layer4.2.conv3.bias" in got
        bn = want_tree["backbone"]["body"]["layer2"]["0"]["bn2"]
        np.testing.assert_array_equal(np.asarray(bn["var"]), np.float32(1.0 - 1e-5))
    n_changed = 0
    for k in want:
        g, w = got[k].numpy(), want[k].numpy()
        assert_close(g, w, k)
        n_changed += k not in before or not torch.equal(before[k], got[k])
    assert n_changed >= {"fold_frozen_bn": 106, "fold_init_conv": 2, "fold_inference": 107}[fold]
    # the model folded from is left as it was
    after = model.state_dict()
    assert sorted(after) == sorted(before)
    assert all(torch.equal(after[k], before[k]) for k in before)
    assert model.backbone[0].init_conv is not None


def test_folded_jax_tree_loads_into_folded_model(setup):
    jcfg, tcfg, params, model, _ = setup
    sd = weights.params_to_state_dict(jopt.fold_inference(params, jcfg), tcfg)
    folded = topt.fold_inference(NbmModel(tcfg))  # the folded tree; its values unused
    weights.load_into(folded, sd)
    got = folded.state_dict()
    assert sorted(got) == sorted(sd) and all(torch.equal(got[k], sd[k]) for k in sd)
    back = weights.state_dict_to_params(got, tcfg)
    assert "backbone/body/stem_corr/w" in back and "backbone/init_conv/w" not in back
    assert sorted(weights.params_to_state_dict(back, tcfg)) == sorted(sd)


def test_folded_whole_file_matches_jax(setup):
    """float32: the port's folded model against the JAX package's folded
    params on one 6 s file (10 windows), and against the port's unfolded
    model."""
    jcfg, tcfg, params, model, samples = setup
    fe_j = JFrontend(jcfg.frontend, wire_codec=False).process(samples)
    want = jpipe.packed_to_class_dict(np.asarray(jpipe.detect_file_packed(
        jopt.fold_inference(params, jcfg), jcfg, fe_j, 0.0, 2)), jcfg)
    fe_t = SpectrogramFrontend(tcfg.frontend, device="cpu").process(samples)
    folded = topt.fold_inference(model, tcfg)
    got = tpipe.packed_to_class_dict(tpipe.detect_file(folded, tcfg, fe_t, 0.0, 2).numpy(), tcfg)
    unfolded = tpipe.packed_to_class_dict(tpipe.detect_file(model, tcfg, fe_t, 0.0, 2).numpy(),
                                          tcfg)
    assert sum(len(v["scores"]) for v in want.values()) > 20
    assert_same_detections(got, want)
    assert_same_detections(got, unfolded)


def test_folded_bf16_trunk_close_to_jax(setup):
    """compute_dtype="bfloat16": the folded float32 weights cast at use, on
    both sides."""
    _, _, params, model, _ = setup
    jcfg, tcfg = tiny(JConfig), tiny(NbmConfig)
    jcfg.compute_dtype = tcfg.compute_dtype = "bfloat16"
    jfold = jopt.fold_inference(params, jcfg)
    model = topt.fold_inference(port_model(model.state_dict(), tcfg), tcfg)
    x = np.random.default_rng(0).random((2, 128, 256), dtype=np.float32)

    @jax.jit
    def trunk(p, w):
        feats, _ = jbackbone.backbone_apply(p["backbone"], w[..., None].astype(jnp.bfloat16), jcfg)
        attn = jattn.sa_pyramid_apply(p["attn"], feats, jcfg.pyramid_top_n_attn)
        return jfpn.build_fpn_apply(p["fpn"], jcfg, attn, False, None)

    fpn_j = trunk(jfold, jnp.asarray(x))
    with torch.inference_mode():
        fpn_t = model.fpn(model.attn(model.backbone[0](
            torch.from_numpy(x)[:, None].to(torch.bfloat16))))
    for lv, (g, w) in enumerate(zip(fpn_t, fpn_j)):
        assert g.dtype == torch.bfloat16
        g, w = g.float().numpy(), np.asarray(w, np.float32).transpose(0, 3, 1, 2)
        assert np.abs(g - w).max() <= 0.1 * np.abs(w).max(), f"fpn[{lv}]"


def test_load_model_returns_folded_model(setup, tmp_path):
    jcfg, tcfg, params, model, _ = setup
    ckpt = tmp_path / "model_weights"
    ckpt.mkdir()
    jcfg.save(str(ckpt / "args"))
    torch.save({"checkpoints": model.state_dict()}, ckpt / "model_chkpt.pt")
    loaded, cfg = tpipe.load_model(str(ckpt), "cpu")
    assert loaded.inference_folded and not loaded.training
    assert loaded.backbone[0].init_conv is None and loaded.backbone[0].body.stem_corr is not None
    assert not any(type(m).__name__ == "FrozenBatchNorm2d" for m in loaded.backbone.modules())
    want = topt.fold_inference(model, tcfg).state_dict()
    got = loaded.state_dict()
    assert sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)
    from birdsoundclassif_tpu_torch.train.loop import Trainer

    with pytest.raises(ValueError, match="inference folds"):
        Trainer(loaded, cfg)


@pytest.mark.parametrize("field,value", [("backbone", "vgg16_bn"), ("quantize_fpn", True)])
def test_fold_refuses_unported_variants(setup, field, value):
    _, _, _, model, _ = setup
    cfg = tiny(NbmConfig)
    setattr(cfg, field, value)
    for fold in (topt.fold_frozen_bn, topt.fold_init_conv, topt.fold_inference):
        with pytest.raises(NotImplementedError, match=r"ROADMAP\.md A\.3"):
            fold(model, cfg)


def _tone(seconds, sr, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    sig = 0.3 * np.sin(2 * np.pi * 3000 * t) * (np.sin(2 * np.pi * 1.3 * t) > 0)
    return (sig + 0.005 * rng.standard_normal(len(t))).astype(np.float32)


@needs_mp3
@pytest.mark.parametrize("sr", [44_100, 22_050])
def test_mp3_decode_matches_jax(tmp_path, sr):
    """An mp3 written by the JAX package's encoder decodes to the same
    samples and rate, and load_audio_raw (resampled at 22.05 kHz) to the
    same array, bit for bit."""
    path = str(tmp_path / "t.mp3")
    jmp3.encode_mp3(path, _tone(2.0, sr), sr)
    x, rate = tmp3.decode_mp3(path)
    want_x, want_rate = jmp3.decode_mp3(path)
    assert rate == want_rate == sr and x.dtype == want_x.dtype == np.float32
    np.testing.assert_array_equal(x, want_x)
    got, want = twavio.load_audio_raw(path), jwavio.load_audio_raw(path)
    assert got.dtype == want.dtype == np.float32 and got.ndim == 1
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["broken.mp3", "empty.mp3", "x.flac"])
def test_undecodable_audio_returns_none_as_jax(tmp_path, monkeypatch, name):
    """Bad mp3 bytes, an empty file, and a format that goes to ffmpeg: both
    packages print and return None (the reference skips the file). Without
    libmpg123 an mp3 goes to ffmpeg as well."""
    path = tmp_path / name
    path.write_bytes(b"" if name.startswith("empty") else b"\xff\xfb not audio" * 50)
    assert twavio.load_audio_raw(str(path)) is None
    assert jwavio.load_audio_raw(str(path)) is None
    if tmp3.mpg123_available() and shutil.which("ffmpeg") is None:
        monkeypatch.setattr(tmp3, "mpg123_available", lambda: False)
        assert twavio.load_audio_raw(str(path)) is None
