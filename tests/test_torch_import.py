"""PyTorch port: import isolation and the no-GPU behaviour of its CLI.

The port imports torch, numpy and scipy, never jax and nothing of the JAX
package, and its trainer needs no pandas, imageio or Pillow (the card's
machine has none of them). tests/conftest.py already imports jax into this process, so the
import check runs in a fresh interpreter.
"""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "birdsoundclassif_tpu_torch")


def test_import_loads_no_jax_and_no_jax_package():
    code = (
        "import sys\n"
        "import birdsoundclassif_tpu_torch\n"
        "import birdsoundclassif_tpu_torch.infer.cli\n"
        "import birdsoundclassif_tpu_torch.infer.pipeline\n"
        "import birdsoundclassif_tpu_torch.infer.serve\n"
        "import birdsoundclassif_tpu_torch.infer.sweep\n"
        "import birdsoundclassif_tpu_torch.infer.export\n"
        "import birdsoundclassif_tpu_torch.models.optimize\n"
        "import birdsoundclassif_tpu_torch.audio.mp3\n"
        "import birdsoundclassif_tpu_torch.train.driver\n"
        "import birdsoundclassif_tpu_torch.data.image_dataset\n"
        "import birdsoundclassif_tpu_torch.data.device_aug\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'birdsoundclassif_tpu' or m.startswith('birdsoundclassif_tpu.')\n"
        "       or m.split('.')[0] in ('pandas', 'imageio', 'PIL')]\n"
        "print(repr(bad))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_sources_import_nothing_of_jax():
    pattern = re.compile(r"^\s*(import jax|from jax|import birdsoundclassif_tpu\b(?!_)"
                         r"|from birdsoundclassif_tpu[ .])", re.M)
    scanned = set()
    for dirpath, _, files in os.walk(PORT):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    hits = pattern.findall(f.read())
                assert not hits, f"{name}: {hits}"
                scanned.add(os.path.relpath(os.path.join(dirpath, name), PORT))
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        assert not pattern.findall(f.read())
    assert len(scanned) >= 20
    assert {"models/optimize.py", "audio/mp3.py", "infer/serve.py", "infer/sweep.py",
            "infer/export.py", "data/device_aug.py"} <= scanned


def test_cli_raises_without_gpu_unless_device_cpu(tmp_path):
    import torch

    from birdsoundclassif_tpu_torch.infer import cli

    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the no-GPU error cannot occur")
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(["--ckpt", str(tmp_path), "--audio_dir", str(tmp_path)])
