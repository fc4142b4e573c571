"""Serving export: trace the eval forward once, serve it without model code
(counterpart of ``awsegbench/serving.py``).

The eval forward (normalize → ensemble forward → f32 logits [+ depth]) is
traced by ``torch.export`` at fixed spatial shapes, with the weights cast to
the compute dtype and saved beside the graph. The hand-written kernels on
that path, K1 (SR attention, ``csrc/sr_attention.cu``) and K2 (the eval seg
head, ``csrc/seg_head.cu``), are the custom ops ``awseg::sr_attention`` and
``awseg::seg_core`` (``ops/library.py``), so the graph holds them as nodes.
A serving host needs only torch and ``awsegbench_torch.ops``: no model code,
config or checkpoint. An artifact exported on the CPU can be moved to the
card at load (``move_to_device_pass``), where its ops launch the kernels;
a device the artifact does not list is refused at load, as JAX's artifact
checks the platform at dispatch.

Layout of an artifact directory:
    model.pt2    ``torch.export.save`` of the program (weights inside; the
                 platforms it may run on in its extra file platforms.json)
    meta.json    shapes, dtype policy, class count, checkpoint
"""

from __future__ import annotations

import copy
import io
import json
import logging
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Sequence

import torch
from torch import nn
from torch.export.passes import move_to_device_pass

from ._device import resolve_device
from .ops import library  # noqa: F401  (the awseg:: ops, before any load)

logger = logging.getLogger(__name__)

ARTIFACT = 'model.pt2'
_META = 'meta.json'
_PLATFORMS = 'platforms.json'
PLATFORMS = ('cuda', 'cpu')


class _ServingForward(nn.Module):
    """uint8 NHWC images → {'segmentation'[, 'depth']} in f32."""

    def __init__(self, model: nn.Module, compute_dtype: torch.dtype,
                 include_depth: bool) -> None:
        super().__init__()
        from .data.pipeline import normalize_imagenet
        self.model = model
        self.compute_dtype = compute_dtype
        self.include_depth = include_depth
        self._normalize = normalize_imagenet

    def forward(self, images_u8: torch.Tensor) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            x = self._normalize(images_u8).to(self.compute_dtype)
            out = self.model(x)
            res = {'segmentation': out['segmentation'].float()}
            if self.include_depth and 'depth' in out:
                res['depth'] = out['depth'].float()
        return res


def build_serving_fn(model: nn.Module, *, precision: str = 'bf16',
                     include_depth: bool = True) -> nn.Module:
    """The serving forward as a module: uint8 NHWC images → f32 logits dict.

    Matches the evaluator's eval path: the parameters and the BN statistics
    cast once to the policy's compute dtype (a copy; ``model`` is left as
    it is), frozen, eval mode, normalize on the model's device, logits
    returned in f32. No weather corruption: serving sees real images.
    The frozen weights keep the attention and the seg head on their
    custom ops (no gradient is asked for)."""
    from .core.precision import get_policy

    policy = get_policy(precision)
    with torch.no_grad():
        cast = {name: t.detach().clone() for name, t in
                policy.cast_to_compute(model, buffers=True).items()}
    served = copy.deepcopy(model).eval()
    served.load_state_dict(cast, assign=True)
    served.requires_grad_(False)
    return _ServingForward(served, policy.compute_dtype,
                           include_depth).eval()


def _platforms(platforms: Optional[Sequence[str]],
               model: nn.Module) -> tuple[str, ...]:
    if platforms is None:
        return (next(model.parameters()).device.type,)
    platforms = tuple(platforms)
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad or not platforms:
        raise ValueError(f'platforms must be a non-empty subset of '
                         f'{PLATFORMS}, got {platforms}')
    return platforms


def export_serving(model: nn.Module, image_hw: Sequence[int], *,
                   batch_size=1, precision: str = 'bf16',
                   include_depth: bool = True,
                   platforms: Optional[Sequence[str]] = None) -> bytes:
    """Trace and serialize the serving forward at static spatial shapes.

    ``batch_size`` is an int for a fixed-batch artifact, or ``'poly'``
    for a batch-polymorphic one (``torch.export.Dim``: one artifact serves
    any batch size; the spatial sizes stay static). ``platforms`` is a
    subset of ``('cuda', 'cpu')``: the export runs on the first, and
    :meth:`ServingModel.load` may move the program to any of them.
    ``None`` exports for the model's own device alone."""
    platforms = _platforms(platforms, model)
    dev = resolve_device(platforms[0])
    serve = build_serving_fn(model, precision=precision,
                             include_depth=include_depth).to(dev)
    h, w = int(image_hw[0]), int(image_hw[1])
    dynamic = None
    if batch_size == 'poly':
        batch_size = 2   # an example of 1 would specialise the batch
        dynamic = {'images_u8': {0: torch.export.Dim('b', min=1)}}
    example = torch.zeros((int(batch_size), h, w, 3), dtype=torch.uint8,
                          device=dev)
    program = torch.export.export(serve, (example,),
                                  dynamic_shapes=dynamic, strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf,
                      extra_files={_PLATFORMS: json.dumps(platforms)})
    return buf.getvalue()


def save_serving_artifact(out_dir, blob: bytes,
                          meta: Mapping[str, Any]) -> Path:
    """Write ``model.pt2`` + ``meta.json`` under ``out_dir``."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / ARTIFACT).write_bytes(blob)
    (out / _META).write_text(json.dumps(dict(meta), indent=2))
    logger.info(f'Serving artifact written to {out} '
                f'({len(blob) / 1e6:.1f} MB)')
    return out


class ServingModel:
    """A loaded serving artifact: ``predict(images_u8)`` → logits dict.

    Needs only torch and the port's ops at load time: no model code,
    config or checkpoint. Input shape and dtype are static (fixed at
    export); a mismatch fails loudly with the expected spec."""

    def __init__(self, program: torch.export.ExportedProgram,
                 meta: Dict[str, Any], platforms: Sequence[str],
                 device: torch.device) -> None:
        self._module = program.module()
        self.meta = meta
        self.input_spec = tuple(meta['input_shape'])
        self.platforms = tuple(platforms)
        self.device = device

    @classmethod
    def load(cls, artifact_dir, device=None) -> 'ServingModel':
        """Load ``artifact_dir`` onto ``device``. The default is the card
        when the artifact lists ``'cuda'`` (wherever it was exported), and
        the CPU only for an artifact that lists the CPU alone. A device the
        artifact does not list raises; ``'cuda'`` without a card raises."""
        d = Path(artifact_dir)
        dev = None if device is None else resolve_device(device)
        meta = json.loads((d / _META).read_text())
        extra = {_PLATFORMS: ''}
        program = torch.export.load(d / ARTIFACT, extra_files=extra)
        platforms = tuple(json.loads(extra[_PLATFORMS]))
        if dev is None:
            dev = resolve_device('cuda' if 'cuda' in platforms
                                 else platforms[0])
        if dev.type not in platforms:
            raise ValueError(f'the artifact was exported for {platforms}, '
                             f'not {dev.type!r}; re-export with '
                             f'platforms including it')
        if dev.type != platforms[0]:
            program = move_to_device_pass(program, dev)
        return cls(program, meta, platforms, dev)

    def predict(self, images_u8) -> Dict[str, torch.Tensor]:
        """uint8 [B, H, W, 3] (numpy or a tensor) → NHWC f32 tensors on the
        serving device (inference tensors: no autograd records them)."""
        x = torch.as_tensor(images_u8)
        spec_ok = (x.ndim == len(self.input_spec) and all(
            e == 'poly' or int(e) == s
            for e, s in zip(self.input_spec, x.shape)))
        if not spec_ok or x.dtype != torch.uint8:
            raise ValueError(
                f'expected uint8 input of shape {self.input_spec}, got '
                f'{x.dtype} {tuple(x.shape)} (shapes are static at export; '
                f're-export for other sizes)')
        with torch.inference_mode():
            return self._module(x.to(self.device))
