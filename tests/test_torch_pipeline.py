"""PyTorch port: whole-file inference held against the JAX package.

About 6 s of synthetic 44.1 kHz PCM16 (noise plus tone bursts, written with
the stdlib wave module) gives 10 windows at the tiny config's 128x256
windows (hop 204): border windows, interior windows and a reflect-padded
tail. The port runs on the CPU (device="cpu"), the JAX package with the
same unfolded params.

Tolerances: the normalised spectrogram within 5e-4 of its [0, 1] range
(float32 DFT sums in another order; bins near the -100 dB floor carry the
largest relative error); detections must match in species, count and
order, boxes within 1 px (rounded coordinates may flip at a .5 tie),
scores within 1e-4.
"""

import ast
import dataclasses
import wave

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from birdsoundclassif_tpu.audio import wavio as jwavio
from birdsoundclassif_tpu.audio.frontend import SpectrogramFrontend as JFrontend
from birdsoundclassif_tpu.config import NbmConfig as JConfig
from birdsoundclassif_tpu.infer import pipeline as jpipe
from birdsoundclassif_tpu.models.detector import NbmModel as JModel
from birdsoundclassif_tpu.models.torch_convert import params_to_state_dict
from birdsoundclassif_tpu_torch.audio.frontend import SpectrogramFrontend
from birdsoundclassif_tpu_torch.audio.wavio import load_audio_raw
from birdsoundclassif_tpu_torch.config import NbmConfig
from birdsoundclassif_tpu_torch.infer import pipeline as tpipe
from birdsoundclassif_tpu_torch.models import weights
from birdsoundclassif_tpu_torch.models.detector import NbmModel

SPEC_ATOL = 5e-4
BOX_PX = 1.0
SCORE_ATOL = 1e-4


def tiny(cls):
    cfg = cls()
    cfg.num_classes = 6
    cfg.out_fpn_chan = 16
    cfg.fpn_p_chan = 24
    cfg.depth_rcnn = 1
    cfg.img_height, cfg.img_width = 128, 256
    cfg.compute_dtype = "float32"
    return cfg


def write_wav(path, seconds=6.0, seed=0, sr=44100):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    sig = 0.3 * np.sin(2 * np.pi * 3000 * t) * (np.sin(2 * np.pi * 1.3 * t) > 0.5)
    sig += 0.15 * np.sin(2 * np.pi * 6500 * t) * (np.sin(2 * np.pi * 0.4 * t) > 0.7)
    sig += 0.02 * rng.standard_normal(t.size)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(sig, -1, 1) * 32767).astype("<i2").tobytes())


def assert_same_detections(got, want):
    """got / want: {key: {"bbox_coord": (k, 4), "scores": (k,)}}."""
    got = {k: v for k, v in got.items() if len(v["scores"])}
    want = {k: v for k, v in want.items() if len(v["scores"])}
    assert sorted(got) == sorted(want)
    for k in want:
        gb, wb = np.asarray(got[k]["bbox_coord"]), np.asarray(want[k]["bbox_coord"])
        assert gb.shape == wb.shape, f"{k}: {len(gb)} boxes, want {len(wb)}"
        np.testing.assert_allclose(gb, wb, atol=BOX_PX, rtol=0, err_msg=k)
        np.testing.assert_allclose(np.asarray(got[k]["scores"]), np.asarray(want[k]["scores"]),
                                   atol=SCORE_ATOL, rtol=0, err_msg=k)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline")
    jcfg, tcfg = tiny(JConfig), tiny(NbmConfig)
    params = JModel.init(jax.random.PRNGKey(0), jcfg)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in params_to_state_dict(params, jcfg).items()}
    ckpt = root / "model_weights"
    ckpt.mkdir()
    jcfg.save(str(ckpt / "args"))
    torch.save({"checkpoints": sd}, ckpt / "model_chkpt.pt")
    model = NbmModel(tcfg)
    weights.load_into(model, sd)
    model.eval()
    for sub in ("audio_jax", "audio_torch"):
        (root / sub).mkdir()
        write_wav(root / sub / "night.wav")
    samples = load_audio_raw(str(root / "audio_jax" / "night.wav"))
    return root, jcfg, tcfg, params, model, samples


@pytest.mark.parametrize("chunk", [None, 100_000])
def test_frontend_matches_jax(setup, chunk):
    """Whole-file STFT, and the reference's per-5e7-sample chunking (here
    cut to 100,000 samples: 3 chunks) with one global min-max."""
    _, jcfg, tcfg, _, _, samples = setup
    jfe, tfe = jcfg.frontend, tcfg.frontend
    if chunk:
        jfe = dataclasses.replace(jfe, stft_chunk_samples=chunk)
        tfe = dataclasses.replace(tfe, stft_chunk_samples=chunk)
    want = JFrontend(jfe, wire_codec=False).process(samples)
    got = SpectrogramFrontend(tfe, device="cpu").process(samples)
    assert got.total_frames == want.total_frames
    np.testing.assert_array_equal(got.window_cols, want.window_cols)
    assert got.n_windows == 10 and got.window_cols[-1, -1] < got.total_frames - 1  # reflect tail
    np.testing.assert_allclose(got.spec.numpy(), want.spec, atol=SPEC_ATOL, rtol=0)


@pytest.mark.parametrize("sr,channels", [(44100, 1), (22050, 1), (48000, 2)])
def test_wav_decode_matches_jax(tmp_path, sr, channels):
    """Mono PCM16 at 44.1 kHz stays int16; other rates are resampled with
    resample_poly, stereo is mean-downmixed."""
    rng = np.random.default_rng(sr + channels)
    pcm = (rng.uniform(-0.5, 0.5, (sr // 2, channels)) * 32767).astype("<i2")
    path = str(tmp_path / "x.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    got, want = load_audio_raw(path), jwavio.load_audio_raw(path)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("n_real,max_boxes", [(6, 8192), (5, 8192), (6, 40), (1, 8192)])
def test_merge_core_matches_jax(n_real, max_boxes):
    """Border drops, window shift, lexsort candidate order, merge NMS and
    the merge_nms_max_boxes cap with its dropped-count row: the packed
    rows equal the JAX package's exactly (padding windows past n_real
    included, as the bucketed JAX path has them)."""
    rng = np.random.default_rng(n_real * 100 + max_boxes)
    n, r, num_classes = 8, 12, 5
    boxes = np.zeros((n, r, 4), np.float32)
    boxes[..., 0] = np.round(rng.uniform(0, 240, (n, r)))
    boxes[..., 1] = np.round(rng.uniform(0, 100, (n, r)))
    boxes[..., 2] = np.minimum(boxes[..., 0] + np.round(rng.uniform(3, 120, (n, r))), 255)
    boxes[..., 3] = np.minimum(boxes[..., 1] + np.round(rng.uniform(3, 40, (n, r))), 127)
    boxes[0, :3, 2] = 255   # right-border boxes in the first window
    boxes[1, :3, 0] = 0     # left-border boxes in an interior window
    scores = rng.uniform(0.01, 1, (n, r)).astype(np.float32)
    scores[2, :4] = scores[2, 5]  # ties: the stable order decides
    classes = rng.integers(0, num_classes + 1, (n, r)).astype(np.int32)
    valid = (rng.random((n, r)) > 0.2) & (classes > 0)
    length = 204 * (n_real - 1) + 256 - 30  # the last window ends past the file
    args = (n_real, length, 256, 204, num_classes, 0.3, max_boxes)
    want = np.asarray(jpipe._merge_core(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes), jnp.asarray(valid),
        jnp.int32(n_real), jnp.float32(length), *args[2:]))
    got = tpipe._merge_core(torch.from_numpy(boxes), torch.from_numpy(scores),
                            torch.from_numpy(classes), torch.from_numpy(valid), *args).numpy()
    np.testing.assert_array_equal(got, want)
    if max_boxes < n * r:
        assert got[-1, 0] > 0 and tpipe.packed_dropped_count(got) == int(got[-1, 0])


def test_whole_file_matches_jax(setup):
    _, jcfg, tcfg, params, model, samples = setup
    fe_j = JFrontend(jcfg.frontend, wire_codec=False).process(samples)
    want = jpipe.packed_to_class_dict(
        np.asarray(jpipe.detect_file_packed(params, jcfg, fe_j, 0.0, 2)), jcfg)
    fe_t = SpectrogramFrontend(tcfg.frontend, device="cpu").process(samples)
    got = tpipe.packed_to_class_dict(
        tpipe.detect_file(model, tcfg, fe_t, 0.0, 2).numpy(), tcfg)
    assert sum(len(v["scores"]) for v in want.values()) > 20
    assert_same_detections(got, want)


def test_cli_txt_matches_jax_cli(setup, monkeypatch):
    from birdsoundclassif_tpu.infer import cli as jcli
    from birdsoundclassif_tpu_torch.infer import cli as tcli

    root, _, _, _, _, _ = setup
    monkeypatch.chdir(root)
    common = ["--ckpt", str(root / "model_weights"), "--min_score", "0.05", "--batch", "2"]
    assert jcli.main(common + ["--audio_dir", str(root / "audio_jax")]) == 0
    assert tcli.main(common + ["--audio_dir", str(root / "audio_torch"), "--device", "cpu"]) == 0
    want = ast.literal_eval((root / "audio_jax" / "night.txt").read_text())
    got = ast.literal_eval((root / "audio_torch" / "night.txt").read_text())
    assert want
    assert list(got) == list(want)  # species in class-id order
    assert_same_detections(got, want)
