"""Export a trained checkpoint as a self-contained serving artifact
(counterpart of ``scripts/export_serving.py``, with the same flags).

    python -m awsegbench_torch.cli.export_serving <checkpoint> \
        --config cfg.yaml --out serving/ [--batch-size 1|poly] \
        [--platforms cuda,cpu] [--no-depth] [--device cpu]

Produces ``<out>/model.pt2`` (``torch.export``, weights inside) and
``<out>/meta.json``. Load it with
``awsegbench_torch.serving.ServingModel.load``: serving needs only torch
and ``awsegbench_torch.ops``. The checkpoint is loaded on the card unless
``--device cpu`` (or the config's ``device: cpu``) asks for the CPU; the
export runs on the first of ``--platforms`` (default: that device).
"""

from __future__ import annotations

import argparse
from typing import Any

import torch

from ..serving import ARTIFACT, export_serving, save_serving_artifact
from ..utils.config import (create_default_config, get_device_config,
                            setup_logging)
from .evaluate import load_model
from .train import load_cli_config


def main(argv=None) -> dict[str, Any]:
    """Run the CLI; returns the artifact's meta (for callers in the same
    process)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument('checkpoint', help='checkpoint dir (latest/best/epoch_N)')
    ap.add_argument('--config', default=None)
    ap.add_argument('--out', default='serving_artifact')
    ap.add_argument('--batch-size', default='1',
                    help="int, or 'poly' for a batch-polymorphic artifact")
    ap.add_argument('--height', type=int, default=None,
                    help='input height (default: config data.image_size)')
    ap.add_argument('--width', type=int, default=None)
    ap.add_argument('--platforms', default=None,
                    help="comma list of 'cuda' and 'cpu'; the export runs "
                         'on the first (default: --device only)')
    ap.add_argument('--precision', default=None,
                    help='override tpu.precision (bf16|fp32)')
    ap.add_argument('--no-depth', action='store_true')
    ap.add_argument('--device', default='auto',
                    help='device the checkpoint is loaded on (auto = the '
                         "config's device; cuda, cpu)")
    args = ap.parse_args(argv)

    config = (load_cli_config(args.config) if args.config
              else create_default_config())
    if args.device != 'auto':
        config.set('device', args.device)
    setup_logging(config)
    device = get_device_config(config.get('device', 'auto'))

    model = load_model(args.checkpoint, config, device)
    h, w = config.get('data.image_size', [512, 1024])
    h = args.height or h
    w = args.width or w
    precision = args.precision or config.get('tpu.precision', 'bf16')
    platforms = ([p.strip() for p in args.platforms.split(',') if p.strip()]
                 if args.platforms else [torch.device(device).type])
    include_depth = (not args.no_depth
                     and config.get('model.include_depth', True))

    batch = (args.batch_size if args.batch_size == 'poly'
             else int(args.batch_size))
    blob = export_serving(model, (h, w), batch_size=batch,
                          precision=precision, include_depth=include_depth,
                          platforms=platforms)
    meta = {
        'input_shape': [batch, h, w, 3],
        'input_dtype': 'uint8',
        'num_classes': config.get('model.num_classes', 19),
        'precision': precision,
        'include_depth': include_depth,
        'platforms': platforms,
        'model_type': config.get('model.type',
                                 config.get('model.model_type', 'ensemble')),
        'segformer_variant': config.get('model.segformer_variant', 'b0'),
        'checkpoint': str(args.checkpoint),
        'torch': torch.__version__,
        'artifact': ARTIFACT,
    }
    out = save_serving_artifact(args.out, blob, meta)
    print(f'serving artifact: {out} ({len(blob) / 1e6:.1f} MB)')
    return meta


if __name__ == '__main__':
    main()
