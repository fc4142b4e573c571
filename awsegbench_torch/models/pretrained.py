"""Pretrained encoder weights: find, load, check and graft them
(counterpart of ``awsegbench/models/pretrained.py``).

Weights are read from a local cache directory, never downloaded:

    ``$AWSEG_WEIGHTS_DIR`` (default ``~/.cache/awsegbench/weights``)

Recognised files (the first extension found wins, in ``_EXTS`` order):

* the SegFormer MiT encoder, ``segformer_<variant>.{npz,safetensors,pt,
  pth,bin}`` (``segformer_b0``, ...): a Hugging Face ``SegformerModel``
  state dict (a leading ``segformer.``, as
  ``SegformerForSemanticSegmentation`` saves it, is stripped);
* the ResNet-50 encoder, ``resnet50.{...}``: a torchvision-style state
  dict (``conv1/bn1/layer{1..4}``), BN running stats included.

``.safetensors`` is read by this module's own reader (no package needed);
the torch formats through ``torch.load(weights_only=True)``.

:func:`apply_pretrained` grafts each encoder into a model in place. Per
encoder, a missing or malformed file (unreadable, a key missing or extra,
a wrong shape) leaves that encoder at its random init and logs a warning;
the other encoder is grafted all the same. That is the JAX package's
contract about a weights file, not a fallback from a device or a kernel.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .convert import convert_hf_segformer_encoder, convert_torch_resnet_encoder
from .segformer import MIT_VARIANTS, mit_variant_name

logger = logging.getLogger(__name__)

_EXTS = ('.npz', '.safetensors', '.pt', '.pth', '.bin')
# safetensors dtype → numpy dtype of its little-endian bytes; BF16 is read
# as its 16 bits and widened to f32 through a torch bfloat16 view
_SAFETENSORS_DTYPES = {'F32': '<f4', 'F16': '<f2', 'BF16': '<i2'}


def resolve_weights_dir() -> Path:
    return Path(os.environ.get(
        'AWSEG_WEIGHTS_DIR',
        str(Path.home() / '.cache' / 'awsegbench' / 'weights')))


def find_weights_file(stem: str,
                      weights_dir: Optional[Path] = None) -> Optional[Path]:
    d = Path(weights_dir) if weights_dir is not None else resolve_weights_dir()
    if not d.is_dir():
        return None
    for ext in _EXTS:
        p = d / f'{stem}{ext}'
        if p.is_file():
            return p
    return None


def read_safetensors(path: Path) -> Dict[str, np.ndarray]:
    """A ``.safetensors`` file as ``{name: ndarray}``: an 8-byte
    little-endian header length, a JSON header of name → dtype, shape and
    data offsets, then the raw little-endian data. F32 and F16 stay as
    they are, BF16 becomes f32; any other dtype, or a tensor whose bytes
    the file does not hold, raises ``ValueError``."""
    with open(path, 'rb') as f:
        n = int.from_bytes(f.read(8), 'little')
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == '__metadata__':
            continue
        dt = _SAFETENSORS_DTYPES.get(info['dtype'])
        if dt is None:
            raise ValueError(f'{path}: {name} has dtype {info["dtype"]}, '
                             f'not one of {sorted(_SAFETENSORS_DTYPES)}')
        start, end = info['data_offsets']
        shape = tuple(info['shape'])
        if end - start != np.dtype(dt).itemsize * int(np.prod(shape)) \
                or end > len(data):
            raise ValueError(f'{path}: {name} wants bytes {start}:{end} of '
                             f'{len(data)} for shape {shape}')
        a = np.frombuffer(data, dt, (end - start) // np.dtype(dt).itemsize,
                          start).reshape(shape)
        if info['dtype'] == 'BF16':
            a = torch.from_numpy(a.copy()).view(torch.bfloat16).float().numpy()
        out[name] = a.copy()
    return out


def load_state_dict(path: Path) -> Dict[str, np.ndarray]:
    """Load a ``{name: ndarray}`` state dict from npz, safetensors or a
    torch pickle (``.pt``, ``.pth``, ``.bin``; a ``state_dict`` entry or
    method is unwrapped)."""
    path = Path(path)
    if path.suffix == '.npz':
        with np.load(path) as z:
            return {k: np.asarray(z[k]) for k in z.files}
    if path.suffix == '.safetensors':
        return read_safetensors(path)
    sd = torch.load(str(path), map_location='cpu', weights_only=True)
    if hasattr(sd, 'state_dict'):
        sd = sd.state_dict()
    if 'state_dict' in sd and isinstance(sd['state_dict'], dict):
        sd = sd['state_dict']
    return {k: (v.detach().float().numpy()
                if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16
                else np.asarray(v.numpy() if hasattr(v, 'numpy') else v))
            for k, v in sd.items()}


def _strip_prefix(sd: Mapping[str, np.ndarray],
                  marker: str) -> Dict[str, np.ndarray]:
    """Strip a uniform wrapping prefix (e.g. 'segformer.') if every key that
    contains ``marker`` is prefixed with it."""
    keys = [k for k in sd if marker in k]
    if keys and all(k.startswith(marker) for k in keys):
        n = len(marker)
        return {(k[n:] if k.startswith(marker) else k): v
                for k, v in sd.items()}
    return dict(sd)


def _check_shapes(new: Mapping[str, torch.Tensor],
                  existing: Mapping[str, torch.Tensor], what: str) -> None:
    """Every entry of ``existing`` must be in ``new`` with the same shape,
    and ``new`` must hold nothing else: the converted state dict is a
    drop-in replacement."""
    if new.keys() != existing.keys():
        missing = sorted(existing.keys() - new.keys())[:4]
        extra = sorted(new.keys() - existing.keys())[:4]
        raise ValueError(f'{what}: state dict mismatch '
                         f'(missing={missing}, extra={extra})')
    for k, t in existing.items():
        if tuple(new[k].shape) != tuple(t.shape):
            raise ValueError(f'{what}: shape mismatch at {k}: '
                             f'{tuple(new[k].shape)} vs {tuple(t.shape)}')


@torch.no_grad()
def _graft(encoder: nn.Module, converted: Mapping[str, torch.Tensor],
           what: str) -> None:
    """Copy ``converted`` into ``encoder``'s parameters and buffers, each
    keeping its own dtype and device; checked whole before any copy."""
    target = encoder.state_dict(keep_vars=True)
    _check_shapes(converted, target, what)
    for k, t in target.items():
        t.copy_(converted[k])


def _graft_segformer(model: nn.Module, encoder_path: str,
                     weights_dir: Optional[Path], variant: str = 'b0') -> bool:
    variant = mit_variant_name(variant)
    path = find_weights_file(f'segformer_{variant}', weights_dir)
    if path is None:
        logger.warning(
            f'Pretrained SegFormer ({variant}) weights not found in '
            f'{weights_dir or resolve_weights_dir()} — using random init '
            '(reference fallback contract, model.py:111-146)')
        return False
    sd = _strip_prefix(load_state_dict(path), 'segformer.')
    encoder = model.get_submodule(encoder_path)
    converted = convert_hf_segformer_encoder(sd,
                                             depths=MIT_VARIANTS[variant][1])
    _graft(encoder, converted, f'segformer encoder ({path.name})')
    logger.info(f'Loaded pretrained SegFormer encoder from {path}')
    return True


def _graft_resnet(model: nn.Module, encoder_path: str,
                  weights_dir: Optional[Path]) -> bool:
    path = find_weights_file('resnet50', weights_dir)
    if path is None:
        logger.warning(
            'Pretrained ResNet-50 weights not found in '
            f'{weights_dir or resolve_weights_dir()} — using random init '
            '(reference fallback contract, model.py:258-274)')
        return False
    encoder = model.get_submodule(encoder_path)
    converted = convert_torch_resnet_encoder(load_state_dict(path))
    _graft(encoder, converted, f'resnet50 encoder ({path.name})')
    logger.info(f'Loaded pretrained ResNet-50 encoder from {path}')
    return True


def apply_pretrained(model: nn.Module, model_config: Mapping[str, Any],
                     weights_dir: Optional[Path] = None) -> Dict[str, bool]:
    """Graft cached pretrained encoder weights into ``model`` in place
    (``model_config`` is the model section: its ``type`` picks the
    encoders, ``segformer_variant`` or else ``model_name`` the MiT
    variant). Returns which encoders were grafted, by kind ('segformer',
    'resnet'). A missing or malformed file leaves that encoder at random
    init and logs a warning."""
    model_type = model_config.get('type', 'ensemble')
    if model_type == 'segformer':
        targets = [('segformer', 'MiTEncoder_0')]
    elif model_type == 'deeplabv3plus':
        targets = [('resnet', 'ResNetEncoder_0')]
    elif model_type == 'mask2former':
        targets = [('resnet', 'backbone')]
    elif model_type == 'mask2former_swin':
        targets = []             # no Swin weights file is read
    else:                        # ensemble: under the members' module names
        targets = [('segformer', 'segformer.MiTEncoder_0'),
                   ('resnet', 'deeplabv3plus.ResNetEncoder_0')]

    variant = model_config.get('segformer_variant')
    if variant is None:
        variant = mit_variant_name(model_config.get('model_name', 'b0'),
                                   default='b0')
    grafted = {}
    for kind, encoder_path in targets:
        try:
            if kind == 'segformer':
                grafted[kind] = _graft_segformer(model, encoder_path,
                                                 weights_dir, variant=variant)
            else:
                grafted[kind] = _graft_resnet(model, encoder_path,
                                              weights_dir)
        except Exception as e:   # the weights file's contract: warn, go on
            logger.warning(f'Could not load pretrained {kind} weights: {e} '
                           '— using random init')
            grafted[kind] = False
    return grafted
