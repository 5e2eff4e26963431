"""Exported whole-file detection programs, and warming the live ones.

Port of ``birdsoundclassif_tpu/infer/export.py``. The reference rebuilds
its model from Python source and a torch checkpoint on every start
(reference: run_detection.py:87-122). Here the bucketed whole-file program
of infer/pipeline.py (``detect_file_packed``) is written out with
``torch.export``:

* one window-batch program (``pipeline.WindowBatch``: window gather and
  detector, with the folded weights inside it) whose spectrogram time axis
  is symbolic, ``8192*k`` (the pipeline's _FRAME_BUCKET), so that one
  program serves any file duration;
* one merge program (``pipeline.Merge``) for each window bucket
  ``batch_size * 2**i`` up to ``max_windows``: the merge's capacity branch
  depends on the bucket, and the merge holds no weights;
* ``min_score`` is a 0-d tensor input, so a deployed threshold is chosen
  when the program runs; ``nms_thresh`` is fixed at export time, as in the
  JAX package (the reference hardcodes 0.3 at inference, nbm_model.py:66-80).

The programs reach the NMS kernel through the registered operator
``torch.ops.birdsoundclassif_tpu_torch.nms_in_order`` (ops/nms.py), which
is imported with this module, so a loaded program launches and counts the
kernel as the live path does. An artifact runs on the device type it was
exported on, as the JAX package's artifacts serve one platform.

The programs run eagerly, op by op, as the live model does. The switches
that keep float32 convolutions out of TF32 are process state that a graph
does not record, so ``ExportedDetector`` runs its programs inside
``device.full_f32()``.

``warm()`` runs the live bucketed program once for each expected file
duration, so that the kernels are built and cuDNN has chosen its
algorithms before traffic arrives.

CLI: ``python -m birdsoundclassif_tpu_torch.infer.export --ckpt DIR --out
DIR [--device cuda]``, or ``--warm --ckpt DIR``.
"""

from __future__ import annotations

import argparse
import json
import os
import warnings
from typing import Dict, List, Sequence, Tuple

import torch
from torch.export.graph_signature import InputKind, InputSpec, TensorArgument

from ..audio.frontend import FrontendResult, SpectrogramFrontend, window_column_indices
from ..config import NbmConfig
from ..device import full_f32, resolve_device
from ..utils.checkpoint import save_params
from .pipeline import (_FRAME_BUCKET, NMS_THRESH, Merge, WindowBatch, bucket_sizes,
                       detect_file_packed, frame_bucket, run_bucketed, stream_detections,
                       window_bucket)

_FORMAT_VERSION = 1
_MANIFEST = "manifest.json"
_WINDOW_BATCH = "window_batch.pt2"


def _merge_name(n_bucket: int) -> str:
    return f"merge_n{n_bucket}.pt2"


def _fold_constants(ep: torch.export.ExportedProgram) -> torch.export.ExportedProgram:
    """Compute once, at export, every node whose inputs are all constants
    of the program, and keep its result as a constant. The detector builds
    its anchors, resize and pool matrices and positional encodings from
    numpy in each forward; traced, each becomes a CPU constant and a copy
    to the device in every run. Folded, they are constants on the device.
    Parameters and buffers are not touched, and each folded constant has
    storage of its own."""
    g = ep.graph_module.graph
    specs = list(ep.graph_signature.input_specs)
    spec_of = {s.arg.name: s for s in specs}
    value: Dict[torch.fx.Node, torch.Tensor] = {}
    checks: List[torch.fx.Node] = []
    for node in g.nodes:
        if node.op == "placeholder" and spec_of[node.name].kind == InputKind.CONSTANT_TENSOR:
            value[node] = ep.constants[spec_of[node.name].target]
        elif (node.op == "call_function" and isinstance(node.target, torch._ops.OpOverload)
              and not node.target._schema.is_mutable and node.all_input_nodes
              and all(n in value for n in node.all_input_nodes)):
            args, kwargs = torch.fx.node.map_arg((node.args, node.kwargs), lambda n: value[n])
            out = node.target(*args, **kwargs)
            if isinstance(out, torch.Tensor):
                # an expand or a broadcast stays in the graph: its entries
                # overlap. A transpose is folded with its strides, which the
                # kernels that read it see as in the live model
                if torch.empty_like(out).stride() == out.stride():  # dense
                    value[node] = out
            elif out is None and not node.users:
                checks.append(node)  # an assert on constants: holds, and goes
    first_input = next(n for n in g.nodes
                       if n.op == "placeholder" and spec_of[n.name].kind == InputKind.USER_INPUT)
    at = specs.index(spec_of[first_input.name])
    for i, node in enumerate([n for n in value if n.op == "call_function"
                              and any(u not in value and u not in checks for u in n.users)]):
        with g.inserting_before(first_input):
            ph = g.placeholder(f"folded_constant_{i}")
        ph.meta.update(node.meta)
        target = f"folded_constant_{i}"
        ep.constants[target] = value[node].detach().clone()
        specs.insert(at, InputSpec(kind=InputKind.CONSTANT_TENSOR,
                                   arg=TensorArgument(name=ph.name), target=target))
        at += 1
        node.replace_all_uses_with(ph)
    for node in checks:
        g.erase_node(node)
    for node in reversed(list(g.nodes)):
        if node.op == "call_function" and node in value and not node.users:
            g.erase_node(node)
    spec_of = {s.arg.name: s for s in specs}
    for node in list(g.nodes):
        spec = spec_of.get(node.name)
        if node.op == "placeholder" and not node.users \
                and spec.kind == InputKind.CONSTANT_TENSOR:
            g.erase_node(node)
            specs.remove(spec)
            del ep.constants[spec.target]
    ep.graph_signature.input_specs[:] = specs
    ep.graph_module.recompile()
    return ep


def _check_on(ep: torch.export.ExportedProgram, device: torch.device, what: str) -> None:
    """Every weight and constant of the program lies on `device`, and no
    node copies a tensor from another device. A 0-d CPU tensor (min_score,
    n_real, the -1 written into the merge's metadata row) is a kernel
    argument, not a copy, and is let through."""
    held = list(ep.state_dict.items()) + list(ep.constants.items())
    off = [k for k, v in held if isinstance(v, torch.Tensor) and v.dim() > 0
           and v.device.type != device.type]
    copies = [n.name for n in ep.graph.nodes if n.op == "call_function"
              and isinstance(n.meta.get("val"), torch.Tensor)
              and n.meta["val"].device.type == device.type
              and any(isinstance(a.meta.get("val"), torch.Tensor) and a.meta["val"].dim() > 0
                      and a.meta["val"].device.type != device.type for a in n.all_input_nodes)]
    if off or copies:
        raise RuntimeError(f"exported {what}: tensors off {device.type} {off[:5]}, copies to "
                           f"{device.type} {copies[:5]}")


def export_detector(model, cfg: NbmConfig, out_dir: str, batch_size: int = 32,
                    max_windows: int = 512, nms_thresh: float = NMS_THRESH) -> dict:
    """Write the window-batch program, a merge program for each window
    bucket, the cfg JSON (``args``), the weights in the JAX layout
    (``params.npz``) and ``manifest.json`` into `out_dir`, for the device
    of `model`, which must be inference-folded (pipeline.load_model folds).
    Returns the manifest."""
    if not getattr(model, "inference_folded", False):
        raise ValueError("export_detector takes the folded model of pipeline.load_model")
    dev = next(model.parameters()).device
    os.makedirs(out_dir, exist_ok=True)
    fe = cfg.frontend
    # an example of 2 frame buckets: sizes 0 and 1 are specialised, so an
    # example k of 1 would fix the time axis at 8192 frames
    spec = torch.zeros((fe.h_pix, 2 * _FRAME_BUCKET), dtype=torch.float32, device=dev)
    cols = torch.zeros((batch_size, fe.w_pix), dtype=torch.int64, device=dev)
    score = torch.tensor(0.0, dtype=torch.float32)
    k = torch.export.Dim("k", min=1)
    with torch.no_grad(), full_f32():
        ep = torch.export.export(WindowBatch(model.eval(), nms_thresh), (spec, cols, score),
                                 dynamic_shapes=({1: _FRAME_BUCKET * k}, None, None),
                                 strict=False)
    ep = _fold_constants(ep)
    _check_on(ep, dev, "window batch")
    with warnings.catch_warnings():
        # a folded transpose is stored with its strides, which torch.export
        # warns of; it is loaded with them
        warnings.filterwarnings("ignore", "No complete tensor found")
        torch.export.save(ep, os.path.join(out_dir, _WINDOW_BATCH))
    slots = [a.meta["val"] for a in ep.graph.output_node().args[0]]
    r = slots[1].shape[1]
    buckets = bucket_sizes(batch_size, max_windows)
    programs = {}
    for n_bucket in buckets:
        example = (torch.zeros((n_bucket, r, 4), dtype=slots[0].dtype, device=dev),
                   torch.zeros((n_bucket, r), dtype=slots[1].dtype, device=dev),
                   torch.zeros((n_bucket, r), dtype=slots[2].dtype, device=dev),
                   torch.zeros((n_bucket, r), dtype=torch.bool, device=dev),
                   torch.tensor(1, dtype=torch.int32), torch.tensor(1.0, dtype=torch.float32))
        with torch.no_grad():
            merge = torch.export.export(Merge(cfg, nms_thresh), example, strict=False)
        _check_on(merge, dev, f"merge {n_bucket}")
        torch.export.save(merge, os.path.join(out_dir, _merge_name(n_bucket)))
        programs[str(n_bucket)] = _merge_name(n_bucket)

    cfg.save(os.path.join(out_dir, "args"))
    save_params(out_dir, model, cfg)
    manifest = {
        "format_version": _FORMAT_VERSION,
        "torch_version": torch.__version__,
        "batch_size": batch_size,
        "nms_thresh": nms_thresh,
        "frame_bucket": _FRAME_BUCKET,
        "device": dev.type,
        "n_buckets": buckets,
        "window_batch": _WINDOW_BATCH,
        "programs": programs,
    }
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


class ExportedDetector:
    """A loaded artifact: cfg, the window-batch program and the merge
    programs (each loaded at its first use). ``detect_file_packed`` has the
    calling convention of ``pipeline.detect_file_packed``, so it plugs into
    ``stream_detections(detect_fn=...)`` and the service."""

    def __init__(self, out_dir: str, manifest: dict, cfg: NbmConfig, device: torch.device):
        self.out_dir = out_dir
        self.manifest = manifest
        self.cfg = cfg
        self.device = device
        self.batch_size = int(manifest["batch_size"])
        self.nms_thresh = float(manifest["nms_thresh"])
        self._buckets = sorted(int(b) for b in manifest["programs"])
        self._window_batch = self._load(manifest["window_batch"])
        self._merges: Dict[int, torch.nn.Module] = {}

    @classmethod
    def load(cls, out_dir: str, device: torch.device | str = "cuda") -> "ExportedDetector":
        """Load an artifact to run on `device`, which must be of the device
        type it was exported on."""
        dev = resolve_device(device)
        with open(os.path.join(out_dir, _MANIFEST)) as f:
            manifest = json.load(f)
        if manifest.get("format_version") != _FORMAT_VERSION:
            raise ValueError(
                f"unsupported export format_version {manifest.get('format_version')} "
                f"(this build reads {_FORMAT_VERSION})"
            )
        if manifest["device"] != dev.type:
            raise ValueError(
                f"the artifact in {out_dir} was exported for {manifest['device']} and cannot "
                f"run on {dev.type}: export it again with --device {dev.type}"
            )
        cfg = NbmConfig.load(os.path.join(out_dir, "args"))
        return cls(out_dir, manifest, cfg, dev)

    def _load(self, name: str) -> torch.nn.Module:
        return torch.export.load(os.path.join(self.out_dir, name)).module()

    def _merge(self, n_bucket: int) -> torch.nn.Module:
        if n_bucket not in self._merges:
            self._merges[n_bucket] = self._load(self.manifest["programs"][str(n_bucket)])
        return self._merges[n_bucket]

    def detect_file_packed(self, fe_res: FrontendResult, min_score: float) -> torch.Tensor:
        """Run the programs over one file; returns the packed merge rows
        on the device, without waiting for them (the contract of
        pipeline.detect_file_packed)."""
        n = fe_res.n_windows
        n_bucket = window_bucket(n, self.batch_size)
        if n_bucket > self._buckets[-1]:
            raise ValueError(
                f"file needs a {n_bucket}-window bucket but the artifact was exported up to "
                f"{self._buckets[-1]} (see --max_windows); file has {n} windows"
            )
        with torch.inference_mode(), full_f32():
            return run_bucketed(self._window_batch, self._merge(n_bucket), fe_res, min_score,
                                self.batch_size, n_bucket)

    def stream(self, sources, min_score: float, sample_rate: int = 44_100, on_frontend=None):
        """stream_detections over this artifact (the same overlapped loop)."""
        return stream_detections(
            None, self.cfg, SpectrogramFrontend(self.cfg.frontend, device=self.device), sources,
            min_score, self.batch_size, sample_rate=sample_rate, on_frontend=on_frontend,
            detect_fn=lambda fe: self.detect_file_packed(fe, min_score),
        )


def warm(model, cfg: NbmConfig, batch_size: int = 32, seconds: Sequence[float] = (600.0,),
         min_score: float = 0.003, nms_thresh: float = NMS_THRESH) -> List[Tuple[int, int]]:
    """Run the live bucketed program once for each file duration in
    `seconds`, on a silent spectrogram on the model's device, and wait for
    it: the kernels are built and cuDNN's algorithms chosen before traffic
    arrives. Returns the (n_bucket, t_pad) pair of each duration, the
    shapes the JAX package's warm compiles."""
    fe = cfg.frontend
    dev = next(model.parameters()).device
    done = []
    for s in seconds:
        total_frames = max(fe.w_pix, int(round(s * fe.sample_rate / fe.hop_length)))
        fe_res = FrontendResult(
            spec=torch.zeros((fe.h_pix, total_frames), dtype=torch.float32, device=dev),
            window_cols=window_column_indices(total_frames, fe.w_pix, fe.hop_spectro),
            total_frames=total_frames,
        )
        detect_file_packed(model, cfg, fe_res, min_score, batch_size, nms_thresh).cpu()
        done.append((window_bucket(fe_res.n_windows, batch_size), frame_bucket(total_frames)))
    return done


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "Export the NBM detector as torch.export programs, or warm the live program "
        "for a deployment (PyTorch)"
    )
    p.add_argument("--ckpt", default="model_weights",
                   help="model checkpoint directory (args + params)")
    p.add_argument("--out", default=None, help="artifact output directory (required unless --warm)")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--max_windows", type=int, default=512,
                   help="largest window bucket to export; a 600 s file at the flagship "
                        "geometry needs 256")
    p.add_argument("--nms_thresh", type=float, default=NMS_THRESH)
    p.add_argument("--warm", action="store_true",
                   help="instead of exporting, run the live program once for each of the "
                        "--seconds file durations")
    p.add_argument("--seconds", default="600", help="comma-separated file durations for --warm")
    p.add_argument("--min_score", type=float, default=0.003)
    p.add_argument("--device", default="cuda",
                   help="Torch device to export for (default cuda; 'cpu' to run without a "
                        "GPU). One device type per artifact.")
    args = p.parse_args(argv)

    from .pipeline import load_model

    model, cfg = load_model(args.ckpt, resolve_device(args.device))
    if args.warm:
        shapes = warm(model, cfg, args.batch, [float(s) for s in args.seconds.split(",")],
                      args.min_score, args.nms_thresh)
        print(json.dumps({"warmed": shapes}))
        return 0
    if not args.out:
        p.error("--out is required unless --warm")
    manifest = export_detector(model, cfg, args.out, args.batch, args.max_windows,
                               args.nms_thresh)
    print(json.dumps(manifest))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
