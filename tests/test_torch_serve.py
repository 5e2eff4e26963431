"""PyTorch port: the serving path held against the JAX package on the CPU.

The streamed loop (infer/pipeline.py:stream_detections) with the fakes of
tests/test_sweep.py, the watch-folder service (infer/serve.py) and the
dataset sweep (infer/sweep.py) against the JAX package's on copies of one
folder, and the CLI on a folder with a wav and an mp3. Tiny config of
tests/test_torch_pipeline.py; one checkpoint (args + params.npz) that
both packages load with their own load_model, which folds it. Recordings
of 2-4.5 s (4-8 windows of 256 columns), so the JAX package compiles one
whole-file program at batch 8.

Detections are held to the PERF.md section 2 bar (species, count and
order exact, boxes within 1 px, scores within 1e-4); stats, manifest rows
and record order must be equal.
"""

import ast
import concurrent.futures as cf
import json
import os
import shutil
import time

import numpy as np
import jax
import pytest
import torch

from birdsoundclassif_tpu.audio import mp3 as jmp3
from birdsoundclassif_tpu.audio.frontend import SpectrogramFrontend as JFrontend
from birdsoundclassif_tpu.config import NbmConfig as JConfig
from birdsoundclassif_tpu.infer import pipeline as jpipe
from birdsoundclassif_tpu.infer import serve as jserve
from birdsoundclassif_tpu.infer import sweep as jsweep
from birdsoundclassif_tpu_torch.audio.frontend import SpectrogramFrontend
from birdsoundclassif_tpu_torch.audio.wavio import load_audio_raw
from birdsoundclassif_tpu_torch.config import NbmConfig
from birdsoundclassif_tpu_torch.infer import pipeline as tpipe
from birdsoundclassif_tpu_torch.infer import serve as tserve
from birdsoundclassif_tpu_torch.infer import sweep as tsweep
from birdsoundclassif_tpu_torch.models import weights
from test_torch_fold import seeded_state_dict
from test_torch_pipeline import assert_same_detections, tiny, write_wav

BATCH = 8
has_mp3 = jmp3.mpg123_available() and jmp3.lame_available()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tier-1 runs 6 workers on 8 cores: torch's default pool of one thread
    a core in each of them oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    jcfg, tcfg = tiny(JConfig), tiny(NbmConfig)
    ckpt = root / "model_weights"
    ckpt.mkdir()
    jcfg.save(str(ckpt / "args"))
    np.savez(ckpt / "params.npz", **weights.state_dict_to_params(seeded_state_dict(tcfg), tcfg))
    params, jcfg = jpipe.load_model(str(ckpt))
    model, tcfg = tpipe.load_model(str(ckpt), "cpu")
    return root, ckpt, params, jcfg, model, tcfg


def make_folder(base, seconds=(2.0, 3.0, 2.5), mp3=False):
    """rec0, rec1, sub/rec2 (+ rec3.mp3), a corrupt and an empty wav, all
    with an mtime a minute old."""
    (base / "sub").mkdir(parents=True)
    names = ["rec0.wav", "rec1.wav", "sub/rec2.wav"]
    for i, (name, sec) in enumerate(zip(names, seconds)):
        write_wav(base / name, seconds=sec, seed=i)
    if mp3:
        from birdsoundclassif_tpu.audio.wavio import load_audio

        jmp3.encode_mp3(str(base / "rec3.mp3"), load_audio(str(base / "rec1.wav")), 44100)
    (base / "broken.wav").write_bytes(b"not a riff file")
    (base / "empty.wav").write_bytes(b"")
    old = time.time() - 60
    for dirpath, _, files in os.walk(base):
        for f in files:
            os.utime(os.path.join(dirpath, f), (old, old))


def twin_folders(root, name, **kw):
    a, b = root / name / "jax", root / name / "torch"
    make_folder(a, **kw)
    shutil.copytree(a, b, copy_function=shutil.copy2)
    return a, b


def read_txt(path):
    return ast.literal_eval(path.read_text())


def assert_same_outputs(got_dir, want_dir, names):
    for name in names:
        want = read_txt(want_dir / name)
        got = read_txt(got_dir / name)
        assert list(got) == list(want), name
        assert_same_detections(got, want)


def read_jsonl(path, base):
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    return [(os.path.relpath(r["file"], base), r) for r in recs]


def assert_same_records(got, want):
    assert [f for f, _ in got] == [f for f, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert sorted(g) == sorted(w)
        assert list(g["detections"]) == list(w["detections"])
        assert_same_detections(g["detections"], w["detections"])


def test_stream_detections_order_deferral_and_skip(monkeypatch):
    """Every source that decodes is yielded once, in order, one file late
    (file i is yielded only after file i+1's detector was enqueued), and
    decode failures are skipped (tests/test_sweep.py's fakes)."""
    sources = ["a", "b", "bad", "c"]
    dispatch_log = []

    class FakePrefetcher:
        def __init__(self, frontend, sample_rate):
            pass

        def submit(self, item):
            f = cf.Future()
            f.set_result(None if item == "bad" else f"fe:{item}")
            return f

        def close(self):
            pass

    def fake_detect(model, cfg, fe_res, min_score, batch):
        dispatch_log.append(fe_res)
        return f"packed:{fe_res}"

    monkeypatch.setattr(tpipe, "FilePrefetcher", FakePrefetcher)
    monkeypatch.setattr(tpipe, "detect_file", fake_detect)
    seen_frontend = []
    out = []
    for src, packed in tpipe.stream_detections(
            None, None, None, sources, 0.2, 4,
            on_frontend=lambda src, fe: seen_frontend.append((src, fe))):
        out.append((src, packed, list(dispatch_log)))
    assert [(s, p) for s, p, _ in out] == [("a", "packed:fe:a"), ("b", "packed:fe:b"),
                                           ("c", "packed:fe:c")]
    assert [d for _, _, d in out] == [["fe:a", "fe:b"], ["fe:a", "fe:b", "fe:c"],
                                      ["fe:a", "fe:b", "fe:c"]]
    assert seen_frontend == [("a", "fe:a"), ("b", "fe:b"), ("c", "fe:c")]
    # detect_fn takes the place of detect_file
    out = list(tpipe.stream_detections(None, None, None, ["a", "bad"], 0.2, 4,
                                       detect_fn=lambda fe: f"exported:{fe}"))
    assert out == [("a", "exported:fe:a")] and dispatch_log == ["fe:a", "fe:b", "fe:c"]


def test_prefetcher_skips_decode_failures_and_raises_the_rest(setup, tmp_path):
    root, _, _, _, _, tcfg = setup
    write_wav(tmp_path / "ok.wav", seconds=2.0)
    (tmp_path / "broken.wav").write_bytes(b"not a riff file")
    pf = tpipe.FilePrefetcher(SpectrogramFrontend(tcfg.frontend, device="cpu"))
    try:
        fe = pf.submit(str(tmp_path / "ok.wav")).result()
        assert fe.n_windows == 4 and fe.ready is None
        assert pf.submit(str(tmp_path / "broken.wav")).result() is None
        assert pf.submit(np.zeros(0, np.int16)).result() is None

        def fails(samples):
            raise RuntimeError("front-end fault")

        pf.frontend.process = fails  # not a decode failure: raised, not skipped
        with pytest.raises(RuntimeError, match="front-end fault"):
            pf.submit(str(tmp_path / "ok.wav")).result()
    finally:
        pf.close()


def test_serve_once_matches_jax(setup):
    """First pass (recursive, a corrupt and an empty wav), a restart that
    processes nothing, a changed file processed again, and settle gating,
    against the JAX package's service on a copy of the folder."""
    root, _, params, jcfg, model, tcfg = setup
    want_dir, got_dir = twin_folders(root, "serve")
    runs = {}
    for side, d in (("jax", want_dir), ("torch", got_dir)):
        runs[side] = dict(batch=BATCH, min_score=0.0, settle=0.0, once=True,
                          out_path=str(d.parent / f"{side}.jsonl"),
                          manifest_path=str(d.parent / f"{side}_manifest.jsonl"))

    def both():
        want = jserve.serve(params, jcfg, str(want_dir), **runs["jax"])
        got = tserve.serve(model, tcfg, str(got_dir), **runs["torch"])
        return got, want

    got, want = both()
    assert got == want and got["files"] == 3 and got["decode_failures"] == 2
    assert got["detections"] > 0
    assert_same_outputs(got_dir, want_dir, ["rec0.txt", "rec1.txt", "sub/rec2.txt"])
    assert not (got_dir / "broken.txt").exists()
    assert_same_records(read_jsonl(got_dir.parent / "torch.jsonl", got_dir),
                        read_jsonl(want_dir.parent / "jax.jsonl", want_dir))

    def rows(side, d):
        with open(runs[side]["manifest_path"]) as f:
            return [(os.path.relpath(r["file"], d), r["size"], r["mtime"], r["status"],
                     r["detections"]) for r in map(json.loads, f)]

    assert rows("torch", got_dir) == rows("jax", want_dir)
    assert sorted(r[3] for r in rows("torch", got_dir)) == ["decode_failed"] * 2 + ["ok"] * 3

    # a restart: the manifest makes the pass a no-op (failures not retried)
    got, want = both()
    assert got == want and got["files"] == 0 and got["decode_failures"] == 0

    # a file that changed after processing is processed again
    old = time.time() - 10
    for d in (want_dir, got_dir):
        write_wav(d / "rec0.wav", seconds=4.5, seed=7)
        os.utime(d / "rec0.wav", (old, old))
    got, want = both()
    assert got == want and got["files"] == 1
    assert_same_outputs(got_dir, want_dir, ["rec0.txt"])
    assert rows("torch", got_dir) == rows("jax", want_dir)

    # a torn last manifest line is skipped, and settle gating
    with open(runs["torch"]["manifest_path"], "a") as f:
        f.write('{"file": "torn')
    write_wav(got_dir / "hot.wav", seconds=2.0)
    m = tserve.Manifest(runs["torch"]["manifest_path"])
    assert tserve.scan_ready(str(got_dir), m, settle=3600.0) == []
    old = time.time() - 7200
    os.utime(got_dir / "hot.wav", (old, old))
    ready = tserve.scan_ready(str(got_dir), m, settle=3600.0)
    assert [os.path.basename(p) for p, _ in ready] == ["hot.wav"]


def test_sweep_matches_jax(setup, tmp_path, monkeypatch):
    """The sweep over wavs, an mp3 and two bad wavs against the JAX
    package's on one device: the same stats (but time), records and
    .txt files."""
    root, _, params, jcfg, model, tcfg = setup
    want_dir, got_dir = twin_folders(root, "sweep", mp3=has_mp3)
    monkeypatch.setattr(jax, "local_devices", lambda: jax.devices("cpu")[:1])
    want = jsweep.sweep(params, jcfg, str(want_dir), BATCH, 0.0, str(tmp_path / "jax.jsonl"))
    got = tsweep.sweep(model, tcfg, str(got_dir), BATCH, 0.0, str(tmp_path / "torch.jsonl"))
    timing = ("elapsed_seconds", "realtime_factor")
    assert {k: v for k, v in got.items() if k not in timing} == \
        {k: v for k, v in want.items() if k not in timing}
    assert got["files"] == 5 + has_mp3 and got["devices"] == 1 and got["process"] == 0
    recs = read_jsonl(tmp_path / "torch.jsonl", got_dir)
    assert len(recs) == 3 + has_mp3
    assert_same_records(recs, read_jsonl(tmp_path / "jax.jsonl", want_dir))
    assert_same_outputs(got_dir, want_dir,
                        ["rec0.txt", "rec1.txt", "sub/rec2.txt"] + ["rec3.txt"] * has_mp3)


def test_per_window_route_matches_jax(setup):
    """detect_from_frontend(whole_file=False), padded to the JAX package's
    window bucket, and detect_samples, against the JAX whole-file result."""
    root, _, params, jcfg, model, tcfg = setup
    write_wav(root / "route.wav", seconds=4.0, seed=3)
    samples = load_audio_raw(str(root / "route.wav"))
    fe_j = JFrontend(jcfg.frontend, wire_codec=False).process(samples)
    want = jpipe.packed_to_class_dict(
        np.asarray(jpipe.detect_file_packed(params, jcfg, fe_j, 0.0, BATCH)), jcfg)
    fe_t = SpectrogramFrontend(tcfg.frontend, device="cpu").process(samples)
    assert sum(len(v["scores"]) for v in want.values()) > 5
    assert_same_detections(tpipe.detect_from_frontend(model, tcfg, fe_t, 0.0, BATCH, False), want)
    assert_same_detections(tpipe.detect_samples(model, tcfg, samples, 0.0, BATCH), want)


@pytest.mark.skipif(not has_mp3, reason="libmpg123/libmp3lame not present")
def test_cli_reads_mp3_beside_wav_as_jax_cli(setup, monkeypatch):
    from birdsoundclassif_tpu.infer import cli as jcli
    from birdsoundclassif_tpu_torch.infer import cli as tcli

    root, ckpt, _, _, _, _ = setup
    want_dir, got_dir = root / "cli" / "jax", root / "cli" / "torch"
    for d in (want_dir, got_dir):
        d.mkdir(parents=True)
        write_wav(d / "a.wav", seconds=3.0, seed=5)
        jmp3.encode_mp3(str(d / "b.mp3"), load_audio_raw(str(d / "a.wav")), 44100)
    monkeypatch.chdir(root)
    common = ["--ckpt", str(ckpt), "--min_score", "0.0", "--batch", str(BATCH)]
    assert jcli.main(common + ["--audio_dir", str(want_dir)]) == 0
    assert tcli.main(common + ["--audio_dir", str(got_dir), "--device", "cpu"]) == 0
    assert_same_outputs(got_dir, want_dir, ["a.txt", "b.txt"])


def test_full_f32_keeps_tf32_off_across_threads():
    """The TF32 switches are process-wide and the streamed loop enters
    full_f32 from two threads. More threads than cores enter and leave it
    at a short switch interval: inside any block both switches must read
    off, and after the last block they must read as before (a save and
    restore per block lets one thread's exit turn TF32 back on under
    another thread's block)."""
    import sys
    import threading

    from birdsoundclassif_tpu_torch.device import full_f32

    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    before = tuple(f.allow_tf32 for f in flags)
    for f in flags:
        f.allow_tf32 = True
    seen_on, interval = [], sys.getswitchinterval()

    def worker():
        for _ in range(300):
            with full_f32():
                if any(f.allow_tf32 for f in flags):
                    seen_on.append(1)

    threads = [threading.Thread(target=worker) for _ in range(2 * (os.cpu_count() or 4))]
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not seen_on, f"TF32 read on inside full_f32 {len(seen_on)} times"
        assert all(f.allow_tf32 for f in flags)
    finally:
        sys.setswitchinterval(interval)
        for f, v in zip(flags, before):
            f.allow_tf32 = v


@pytest.mark.parametrize("module", [tserve, tsweep])
def test_entry_points_raise_without_gpu_unless_device_cpu(tmp_path, module):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the no-GPU error cannot occur")
    with pytest.raises(RuntimeError, match="--device cpu"):
        module.main(["--ckpt", str(tmp_path), "--audio_dir", str(tmp_path)])
