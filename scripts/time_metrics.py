#!/usr/bin/env python3
"""Time the robustness sweep's metrics (``Evaluator.accumulate``) on one
GPU, piece by piece, for the checkout at ROOT.

Run on a machine with an NVIDIA H100 and the CUDA toolkit:
``python3 scripts/time_metrics.py ROOT``, where ROOT holds a checkout of the
repository (its ``chip_smoke.py`` and ``awsegbench_torch/``). It runs the
eval model of ``chip_smoke.py`` (the faithful ensemble with depth heads,
seeded weights, bf16) on one seeded batch of 8 at 512×1024 with weather ids
0–4 mixed, then prints the card's ``nvidia-smi`` name and power limit and
one JSON line: the median time by CUDA events of ``accumulate`` and of each
metric it calls on those outputs (the per-weather confusion matrices, the
eval step's overall one, the per-weather ECE bins, the disagreement map
with the members' mean softmax, the ensemble's errors from it, the AUROC
histogram), and device time by kernel over
one profiled ``accumulate``. To compare two commits, unpack one with ``git archive``
into a directory that ``.gitignore`` lists and run the two in turns in one
call.
"""

import sys
from pathlib import Path


def main(argv) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    root = Path(argv[0]).resolve()
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke as cs
    from awsegbench_torch import _build
    from awsegbench_torch.eval.evaluator import (AUROC_BINS, AUROC_RANGE,
                                                 Evaluator)
    from awsegbench_torch.metrics.calibration import \
        ece_bin_update_per_weather
    from awsegbench_torch.metrics.disagreement import (
        auroc_histogram_update, disagreement_and_mean_probs)
    from awsegbench_torch.metrics.iou import (
        confusion_matrix_from_logits, confusion_matrix_per_weather_from_logits)
    from awsegbench_torch.models import create_model

    if not torch.cuda.is_available():
        print('time_metrics: no CUDA device', file=sys.stderr)
        return 1
    if not Path(_build.__file__).is_relative_to(root):
        print(f'time_metrics: imported {_build.__file__}, not {root}',
              file=sys.stderr)
        return 1
    print(cs.nvidia_smi(), flush=True)
    dev = torch.device('cuda', 0)
    g = torch.Generator(device=dev).manual_seed(7)
    batch = cs.sweep_loader(dev, g, 1, cs.B, cs.H, cs.W)[0]
    ev = Evaluator(create_model(cs.MODEL_CFG, device=dev, seed=0),
                   {'model': cs.MODEL_CFG, 'tpu': {'precision': 'bf16'}},
                   device=dev)
    labels, wids = batch['label'], batch['weather_id']
    out = ev.forward(batch['image'], labels, wids, g)
    acc = ev.init_acc()
    members = [out['segformer_seg'], out['deeplabv3plus_seg']]
    with torch.inference_mode():
        dis, mean_probs = disagreement_and_mean_probs(members, -1)
        dis = dis.reshape(-1)
        errors = (mean_probs.argmax(-1) != labels).reshape(-1)
        valid = (labels != 255).reshape(-1)
    pieces = {
        'accumulate': lambda: ev.accumulate(acc, out, labels, wids),
        'confusion_matrix': lambda: confusion_matrix_from_logits(
            out['segmentation'], labels, 19),
        'confusion_matrix_per_weather': lambda:
            confusion_matrix_per_weather_from_logits(
                out['segmentation'], labels, 19, wids, 5),
        'ece_bins_per_weather': lambda: ece_bin_update_per_weather(
            out['segmentation'], labels, wids, 5, 15),
        'disagreement_and_mean_probs': lambda: disagreement_and_mean_probs(
            members, -1),
        'errors': lambda: mean_probs.argmax(-1) != labels,
        'auroc_histogram': lambda: auroc_histogram_update(
            dis, errors, AUROC_BINS, *AUROC_RANGE, weights=valid,
            log_scale=True)}
    with torch.inference_mode():
        ms = {k: cs.time_ms(fn, reps=10) for k, fn in pieces.items()}
        prof = cs.profile_step(pieces['accumulate'])
    cs.emit({'root': str(root), 'batch': cs.B, 'hw': [cs.H, cs.W],
             'ms': ms, 'accumulate_profile': prof})
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
