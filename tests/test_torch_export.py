"""PyTorch port: the export path held against the JAX package on the CPU.

The NMS kernel's registered operator (ops/nms.py nms_op): torch.library's
opcheck, its fake, its CPU result against the JAX package's greedy NMS,
and its refusal of other devices. The live bucketed program
(infer/pipeline.py detect_file_packed) and the exported one
(infer/export.py) against the JAX package's live detect_file_packed, the
artifact's layout and weights, run-time thresholds, the bucket limit, the
service with --exported, and warm's shapes.

Tiny config of tests/test_export.py (ResNet-50 at the full 375x1024
windows, 6 classes, FPN 48->32, one RCNN block) in float32 for parity;
weights from the port's seeded init with non-trivial batch norms
(tests/test_torch_fold.py), written as params.npz for both packages.
Batch 2, buckets 2, 4 and 8.

Tolerances: keep masks, kept rows, classes and n_dropped exact; against
JAX, boxes within 1 px and scores within 1e-4 (the PERF.md section 2
bar); the JAX package's reading of the artifact's params.npz within 1e-6
of each tensor's largest magnitude of JAX's own fold (tests/
test_torch_fold.py says why); the exported program against the port's
live one bit for bit.
"""

import json
import os
import shutil

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from birdsoundclassif_tpu.audio.frontend import SpectrogramFrontend as JFrontend
from birdsoundclassif_tpu.config import NbmConfig as JConfig
from birdsoundclassif_tpu.infer import export as jexport
from birdsoundclassif_tpu.infer import pipeline as jpipe
from birdsoundclassif_tpu.ops import nms as jnms
from birdsoundclassif_tpu.utils import checkpoint as jcheckpoint
from birdsoundclassif_tpu_torch.audio.frontend import (FrontendResult, SpectrogramFrontend,
                                                       window_column_indices)
from birdsoundclassif_tpu_torch.config import NbmConfig
from birdsoundclassif_tpu_torch.infer import export as texport
from birdsoundclassif_tpu_torch.infer import pipeline as tpipe
from birdsoundclassif_tpu_torch.infer import serve as tserve
from birdsoundclassif_tpu_torch.models import weights
from birdsoundclassif_tpu_torch.ops import nms as tnms
from test_torch_fold import seeded_state_dict
from test_torch_nms import _boxes
from test_torch_pipeline import assert_same_detections, write_wav

BATCH = 2
MAX_WINDOWS = 8
OP = torch.ops.birdsoundclassif_tpu_torch.nms_in_order.default


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs 6 workers on 8 cores: torch's default pool of one thread
    a core in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def export_tiny(cls):
    """tests/test_export.py's tiny config, in float32."""
    cfg = cls()
    cfg.num_classes = 6
    cfg.out_fpn_chan = 32
    cfg.fpn_p_chan = 48
    cfg.depth_rcnn = 1
    cfg.compute_dtype = "float32"
    return cfg


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("export")
    jcfg, tcfg = export_tiny(JConfig), export_tiny(NbmConfig)
    ckpt = root / "model_weights"
    ckpt.mkdir()
    jcfg.save(str(ckpt / "args"))
    np.savez(ckpt / "params.npz", **weights.state_dict_to_params(seeded_state_dict(tcfg), tcfg))
    model, tcfg = tpipe.load_model(str(ckpt), "cpu")
    art = root / "artifact"
    assert texport.main(["--ckpt", str(ckpt), "--out", str(art), "--batch", str(BATCH),
                         "--max_windows", str(MAX_WINDOWS), "--device", "cpu"]) == 0
    det = texport.ExportedDetector.load(str(art), "cpu")
    return root, ckpt, art, model, tcfg, det


def pcm(seconds, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(seconds * 44100)) * 2000).astype(np.int16)


class CountOp(TorchDispatchMode):
    """Counts calls of the NMS operator below this mode."""

    def __init__(self):
        super().__init__()
        self.calls = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls += func is OP
        return func(*args, **(kwargs or {}))


# ---- the operator ----


@pytest.mark.parametrize("b,n", [(4, 50), (1, 500)])
def test_operator_opcheck(b, n):
    rng = np.random.default_rng(n)
    boxes = torch.from_numpy(_boxes(rng, b, n))
    nv = torch.from_numpy(rng.integers(0, n + 1, b).astype(np.int32))
    torch.library.opcheck(tnms.nms_op, (boxes, nv, 0.5))


def test_operator_fake_gives_shape_and_dtype():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        keep = tnms.nms_op(torch.empty(3, 70, 4), torch.empty(3, dtype=torch.int32), 0.3)
    assert keep.shape == (3, 70) and keep.dtype == torch.bool and keep.device.type == "cpu"


@pytest.mark.parametrize(
    "n,thresh,n_valid",
    [
        (500, 0.7, [500, 1, 0]),      # proposal NMS
        (500, 0.7, [431, 250, 499]),
        (50, 0.3, [50, 0, 1]),        # detection NMS
        (50, 0.3, [37, 12, 49]),
        (8192, 0.3, [2611]),          # merge NMS
    ],
)
def test_operator_matches_jax(n, thresh, n_valid):
    """The operator's CPU implementation against the JAX package's greedy
    NMS over the valid prefix, row by row, exactly (tests/test_torch_nms.py's
    shapes)."""
    rng = np.random.default_rng(n + len(n_valid) + n_valid[0])
    boxes = _boxes(rng, len(n_valid), n)
    got = tnms.nms_op(torch.from_numpy(boxes), torch.tensor(n_valid, dtype=torch.int32),
                      thresh).numpy()
    for r, nv in enumerate(n_valid):
        want = jnms.greedy_nms_in_order(jnp.asarray(boxes[r]), jnp.asarray(np.arange(n) < nv),
                                        thresh, valid_prefix=True)
        np.testing.assert_array_equal(got[r], np.asarray(want))


def test_operator_refuses_other_devices():
    boxes = torch.from_numpy(_boxes(np.random.default_rng(0), 1, 16))
    nv = torch.tensor([16], dtype=torch.int32)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tnms.nms_op(boxes.to("meta"), nv.to("meta"), 0.5)


# ---- the bucketed program and the artifact ----


@pytest.mark.parametrize("bs,max_windows", [(32, 512), (32, 40), (2, 8), (4, 64), (3, 100),
                                            (1, 1)])
def test_bucket_sizes_match_jax(bs, max_windows):
    assert tpipe.bucket_sizes(bs, max_windows) == jexport._bucket_sizes(bs, max_windows)


def test_artifact_layout_and_weights(setup):
    """Manifest, programs, cfg; params.npz read back by the port and, within
    1e-6, by the JAX package as JAX's own fold of the same checkpoint."""
    root, ckpt, art, model, tcfg, det = setup
    with open(art / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest == det.manifest
    assert manifest["format_version"] == 1 and manifest["torch_version"] == torch.__version__
    assert (manifest["batch_size"], manifest["nms_thresh"], manifest["frame_bucket"],
            manifest["device"]) == (BATCH, 0.3, 8192, "cpu")
    assert manifest["n_buckets"] == [2, 4, 8]
    assert sorted(manifest["programs"]) == ["2", "4", "8"]
    assert sorted(os.listdir(art)) == sorted(["args", "manifest.json", "params.npz",
                                              manifest["window_batch"],
                                              *manifest["programs"].values()])
    assert det.cfg.to_json() == tcfg.to_json()
    # the NMS reached as an operator: twice in a window batch, once in a merge
    assert sum(n.target is OP for n in det._window_batch.graph.nodes) == 2
    merge = torch.export.load(str(art / manifest["programs"]["4"]))
    assert sum(n.target is OP for n in merge.graph.nodes) == 1
    # weights: the port's reading equals the folded model
    got = weights.load_params(str(art), tcfg)
    want = model.state_dict()
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k].float()) for k in got)
    # the JAX package's reading against its own fold of the checkpoint,
    # which keeps each folded batch norm as an identity the file leaves out
    jtree = weights.flatten_params(jcheckpoint.load_params(str(art)))
    jfold = weights.flatten_params(jpipe.load_model(str(ckpt))[0])
    assert set(jtree) < set(jfold)
    for k, w in jfold.items():
        w = np.asarray(w)
        if k not in jtree:
            assert "/bn" in k or "/downsample/1/" in k, k
            identity = {"bias": 0.0, "mean": 0.0, "scale": 1.0, "var": np.float32(1 - 1e-5)}
            np.testing.assert_array_equal(w, identity[k.rsplit("/", 1)[1]], err_msg=k)
            continue
        g = np.asarray(jtree[k])
        assert g.shape == w.shape, k
        assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max(), k


def test_exported_matches_jax_live(setup):
    """An 8 s file (4 windows, bucket 4) through the artifact against the
    JAX package's live detect_file_packed at batch 2, min_score 0.01."""
    root, ckpt, art, model, tcfg, det = setup
    params, jcfg = jpipe.load_model(str(ckpt))
    x = pcm(8.0, 1)
    jfe = JFrontend(jcfg.frontend).process(x)
    fe = SpectrogramFrontend(tcfg.frontend, device="cpu").process(x)
    assert fe.n_windows == jfe.n_windows == 4
    want = np.asarray(jpipe.detect_file_packed(params, jcfg, jfe, 0.01, BATCH))
    got = det.detect_file_packed(fe, 0.01).numpy()
    gk, wk = got[:-1][got[:-1, 6] > 0.5], want[:-1][want[:-1, 6] > 0.5]
    assert len(gk) == len(wk) > 0
    np.testing.assert_array_equal(gk[:, 5], wk[:, 5])  # classes
    np.testing.assert_allclose(gk[:, :4], wk[:, :4], atol=1.0, rtol=0)
    np.testing.assert_allclose(gk[:, 4], wk[:, 4], atol=1e-4, rtol=0)
    assert tpipe.packed_dropped_count(got) == jpipe.packed_dropped_count(want)
    _, reverse = tpipe.load_bird_dict()
    got_sp, _ = tpipe.packed_to_species_dict(got, tcfg, reverse)
    want_sp, _ = jpipe.packed_to_species_dict(want, jcfg, reverse)
    assert list(got_sp) == list(want_sp)
    assert_same_detections(got_sp, want_sp)


def test_exported_equals_live_at_two_thresholds(setup):
    """min_score is an input of the artifact: a 3 s file (1 window, bucket
    2) at two thresholds, each packed array bit for bit the port's live
    bucketed program's at that threshold, with 2 * 1 + 1 NMS operator calls
    on both paths."""
    root, ckpt, art, model, tcfg, det = setup
    fe = SpectrogramFrontend(tcfg.frontend, device="cpu").process(pcm(3.0, 3))
    assert fe.n_windows == 1
    got, calls = {}, {}
    with CountOp() as count:
        got[0.0] = det.detect_file_packed(fe, 0.0)
    calls["exported"] = count.calls
    kept = got[0.0][:-1][got[0.0][:-1, 6] > 0.5]
    hi = float(kept[:, 4].median())
    got[hi] = det.detect_file_packed(fe, hi)
    assert 0 < int((got[hi][:-1, 6] > 0.5).sum()) < len(kept)
    for score in (0.0, hi):
        with CountOp() as count:
            want = tpipe.detect_file_packed(model, tcfg, fe, score, BATCH)
        calls["live"] = count.calls
        assert torch.equal(got[score], want)
    assert calls == {"exported": 3, "live": 3}


class StubWindowBatch:
    """A window-batch function of random detections (boxes in one 1,000 x
    100 px band, so that windows overlap), which counts its calls."""

    def __init__(self, r, seed=0):
        self.r, self.rng, self.calls = r, np.random.default_rng(seed), 0

    def __call__(self, spec, cols, min_score):
        self.calls += 1
        b, r = cols.shape[0], self.r
        x1 = self.rng.uniform(0, 900, (b, r))
        y1 = self.rng.uniform(0, 80, (b, r))
        boxes = np.stack([x1, y1, x1 + self.rng.uniform(5, 120, (b, r)),
                          y1 + self.rng.uniform(5, 20, (b, r))], -1)
        scores = self.rng.uniform(0, 1, (b, r))
        return (torch.from_numpy(boxes.astype(np.float32)),
                torch.from_numpy(scores.astype(np.float32)),
                torch.from_numpy(self.rng.integers(1, 7, (b, r)).astype(np.int32)),
                torch.from_numpy(scores > float(min_score)))


@pytest.mark.parametrize("n_windows,bs", [(5, 2), (9, 2), (3, 2), (17, 4)])
def test_padding_batches_are_skipped(n_windows, bs):
    """run_bucketed runs only the batches that hold a real window; the JAX
    package runs the whole bucket and the merge masks the rest. Both give
    the same kept rows and n_dropped (with a merge capacity that cuts the
    candidates, so that n_dropped > 0)."""
    cfg = NbmConfig()
    cfg.merge_nms_max_boxes = 24
    fe = cfg.frontend
    total = fe.w_pix + fe.hop_spectro * (n_windows - 1)
    fe_res = FrontendResult(spec=torch.zeros((fe.h_pix, total)),
                            window_cols=window_column_indices(total, fe.w_pix, fe.hop_spectro),
                            total_frames=total)
    assert fe_res.n_windows == n_windows
    n_bucket = tpipe.window_bucket(n_windows, bs)
    merge = tpipe.Merge(cfg)
    skipped = StubWindowBatch(r=16)
    got = tpipe.run_bucketed(skipped, merge, fe_res, 0.2, bs, n_bucket)
    assert skipped.calls == -(-n_windows // bs)
    # the whole bucket through a stub of the same seed: the batches with a
    # real window draw the same detections, the padding batches more
    whole = StubWindowBatch(r=16)
    cols = torch.zeros((n_bucket, fe.w_pix), dtype=torch.int64)
    outs = [whole(None, cols[i:i + bs], torch.tensor(0.2)) for i in range(0, n_bucket, bs)]
    want = merge(*(torch.cat(p) for p in zip(*outs)), torch.tensor(n_windows, dtype=torch.int32),
                 torch.tensor(float(total)))
    keep_got, keep_want = got[:-1, 6] > 0.5, want[:-1, 6] > 0.5
    assert int(keep_got.sum()) > 0
    assert torch.equal(got[:-1][keep_got], want[:-1][keep_want])
    assert torch.equal(got[-1], want[-1]) and got[-1, 0] > 0


def test_file_beyond_largest_bucket_raises(setup):
    root, ckpt, art, model, tcfg, det = setup
    fe = tcfg.frontend
    total = fe.w_pix + fe.hop_spectro * 10  # 11 windows: bucket 16 > 8
    fe_res = FrontendResult(spec=torch.zeros((fe.h_pix, total)),
                            window_cols=window_column_indices(total, fe.w_pix, fe.hop_spectro),
                            total_frames=total)
    with pytest.raises(ValueError, match="max_windows"):
        det.detect_file_packed(fe_res, 0.01)


def test_artifact_refused_on_another_device_or_format(setup, tmp_path):
    root, ckpt, art, model, tcfg, det = setup
    with open(art / "manifest.json") as f:
        manifest = json.load(f)
    for field, value, device, match in (("device", "cuda", "cpu", "exported for cuda"),
                                        ("format_version", 2, "cpu", "format_version")):
        d = tmp_path / field
        d.mkdir()
        shutil.copy(art / "args", d / "args")
        with open(d / "manifest.json", "w") as f:
            json.dump({**manifest, field: value}, f)
        with pytest.raises(ValueError, match=match):
            texport.ExportedDetector.load(str(d), device)
    with pytest.raises(ValueError, match="exported for cpu"):
        texport.ExportedDetector.load(str(art), "meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            texport.ExportedDetector.load(str(art))


def test_serve_exported_writes_the_live_service_txt(setup):
    """serve --exported (serve() with the ExportedDetector and its
    detect_fn) and the live service on copies of one folder: the same .txt
    files; ExportedDetector.stream gives the same detections."""
    root, ckpt, art, model, tcfg, det = setup
    live_dir, exp_dir = root / "serve" / "live", root / "serve" / "exported"
    live_dir.mkdir(parents=True)
    for i, sec in enumerate((2.5, 3.5)):
        write_wav(live_dir / f"rec{i}.wav", seconds=sec, seed=i)
    shutil.copytree(live_dir, exp_dir)
    live_stats = tserve.serve(model, tcfg, str(live_dir), batch=BATCH, min_score=0.01,
                              settle=0.0, once=True)
    assert tserve.main(["--exported", str(art), "--audio_dir", str(exp_dir), "--once",
                        "--settle", "0", "--min_score", "0.01", "--device", "cpu"]) == 0
    assert live_stats["files"] == 2 and live_stats["detections"] > 0
    for i in range(2):
        assert (exp_dir / f"rec{i}.txt").read_text() == (live_dir / f"rec{i}.txt").read_text()
    # ExportedDetector.stream: the same loop, the same detections
    (path, packed), = det.stream([str(exp_dir / "rec0.wav")], 0.01)
    _, reverse = tpipe.load_bird_dict()
    assert path == str(exp_dir / "rec0.wav")
    assert str(tpipe.packed_to_species_dict(packed, tcfg, reverse)[0]) == \
        (exp_dir / "rec0.txt").read_text()


@pytest.mark.parametrize("seconds", [3.0, 30.0, 120.0, 600.0, 3600.0])
def test_bucket_shapes_follow_jax_warm(seconds):
    """warm's (n_bucket, t_pad) for a duration, as the JAX package's warm
    computes it (infer/export.py:238-253 there), at batch 32 and 2."""
    fe = NbmConfig().frontend
    total = max(fe.w_pix, int(round(seconds * fe.sample_rate / fe.hop_length)))
    n_win = window_column_indices(total, fe.w_pix, fe.hop_spectro).shape[0]
    for bs in (32, 2):
        n_chunks = 1 << (max(1, -(-n_win // bs)) - 1).bit_length()
        assert tpipe.window_bucket(n_win, bs) == n_chunks * bs
        assert tpipe.frame_bucket(total) == -(-total // jpipe._FRAME_BUCKET) * jpipe._FRAME_BUCKET


def test_warm_returns_jax_pairs(setup):
    root, ckpt, art, model, tcfg, det = setup
    assert texport.warm(model, tcfg, BATCH, (3.0,), min_score=0.01) == [(2, 8192)]
