"""The robustness benchmark sweep (counterpart of
``awsegbench/eval/evaluator.py``).

Every metric accumulates on the device, batch by batch, and one transfer
to the host happens at the end of the sweep:

* per-weather confusion matrices [5, C, C] (int64) → mIoU overall and per
  weather;
* per-weather ECE bins [5, num_bins, 3] (float64: int64 counts, the f32
  sums of each batch added in f64) → ECE overall and per weather;
* a [2^20, 2] int64 histogram of the two members' disagreement (mutual
  information, log-spaced bins), positives being the pixels the ensemble
  gets wrong → the disagreement AUROC, within about 1e-4 of the exact one.
  ``auroc_mode='exact'`` also keeps every score and error in a device
  buffer sized from ``len(loader)`` (5 bytes a pixel) and sorts it once at
  the end; ``'exact_host'`` collects them on the host.

The JAX package kept these counts in f32, exact only up to 2^24 per cell;
here they stay exact at any sweep size. The result keys are the JAX
package's, key for key.

The corruption's draws come from a ``torch.Generator`` on the device,
seeded from ``seed``: the JAX package's per-sample ``jax.random`` streams
cannot be reproduced in torch. A caller (a test) can give each batch's
draws instead.

Across devices (``core/mesh.py``: one process per device) every rank
reads the same global batches and draws the same corruption. Each batch
is padded to a multiple of the mesh's size by repeating its last row, and
each rank takes its rows; the padded rows leave every metric through a
sample mask. The accumulators are summed over the ranks once, at the
sweep's end (``psum_tree``; the int64 counts stay exact), and ``'exact'``
mode's AUROC is :func:`~awsegbench_torch.metrics.disagreement.
auroc_exact_sharded` of every rank's buffer. With spatial tiling
(``evaluation.spatial_tiling``) one image's tiles are spread over the
ranks instead (``parallel.collectives.tiled_forward``); each rank then
accumulates its rows of the stitched outputs. On a mesh with a model axis
(``core.mesh.TPMesh``) the model's weights are full on every rank, as in
the JAX sweep, and the rows, the tiles and the sums go over the data axis
(``mesh.data``): the ranks of one model group sweep the same rows, and a
sum over the world would count each row once per model rank.
"""

from __future__ import annotations

import inspect
import json
import logging
import time
from pathlib import Path
from typing import Any, Iterable, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
from ..core.precision import get_policy
from ..core.mesh import Mesh, create_mesh, mesh_rows
from ..data.pipeline import prepare_batch
from ..metrics.calibration import ece_bin_update_per_weather, ece_from_bins
from ..metrics.disagreement import (auroc_exact_sharded,
                                    auroc_from_histogram,
                                    auroc_histogram_update,
                                    disagreement_and_mean_probs)
from ..metrics.iou import (confusion_matrix_per_weather_from_logits,
                           iou_from_confusion)
from ..metrics.robustness import ADVERSE_WEATHERS, RobustnessMetrics
from ..parallel.collectives import choose_tile_grid, psum_tree, tiled_forward
from ..utils.config import check_tpu_section
from ..weather.corruption import WEATHER_CONDITIONS, draw_corruption

logger = logging.getLogger(__name__)

AUROC_BINS = 1 << 20   # log-spaced bins of (positive, negative) counts
# the mutual information of a 2-member ensemble lies in [~0, ln 2]; the
# 1e-8 inside its logs can push it a hair below 0
AUROC_RANGE = (-0.01, 0.75)
AUROC_MODES = ('histogram', 'exact', 'exact_host')


class Evaluator:
    """The sweep: ``Evaluator(model, config).run(loader)``.

    ``config`` is the repository's config (a mapping or a
    ``utils.config.Config``; its ``tpu`` section is checked by
    ``check_tpu_section``): ``model.num_classes``,
    ``evaluation.auroc_mode`` (``'histogram'``, ``'exact'``,
    ``'exact_host'``; ``collect_exact_auroc`` asks for ``'exact_host'``),
    ``evaluation.exact_auroc_max_bytes`` (above it ``'exact'`` falls back to
    the histogram, with a warning), ``evaluation.spatial_tiling``
    (``'on'``, ``'off'``, or ``'auto'``: tile images of at least 2048×1024
    pixels when the mesh has more than one rank), ``evaluation.tile_size``
    (``'auto'``: ``choose_tile_grid`` over the mesh's size, or [h, w]),
    ``evaluation.tile_halo`` (default 128), ``tpu.mesh_shape`` (the mesh,
    unless ``mesh`` is given) and ``tpu.precision`` (``'bf16'`` or
    ``'fp32'``: the model's weights are cast once to its compute dtype; the
    metrics stay f32). The model runs on ``device`` ('cuda' unless the
    caller asks for 'cpu'; raises when there is no card)."""

    def __init__(self, model: nn.Module, config: Mapping | None = None,
                 num_bins: int = 15, collect_exact_auroc: bool = False,
                 auroc_mode: str | None = None,
                 device: str | torch.device = 'cuda',
                 mesh: Mesh | None = None) -> None:
        cfg = (config.to_dict() if hasattr(config, 'to_dict')
               else dict(config or {}))
        check_tpu_section(cfg)
        self.config = cfg
        self.num_classes = (cfg.get('model') or {}).get('num_classes', 19)
        self.num_bins = num_bins
        eval_cfg = cfg.get('evaluation') or {}
        if auroc_mode is None:
            auroc_mode = eval_cfg.get('auroc_mode', 'exact_host'
                                      if collect_exact_auroc else 'histogram')
        if auroc_mode not in AUROC_MODES:
            raise ValueError(f'Unknown auroc_mode: {auroc_mode!r}')
        self.auroc_mode = auroc_mode
        self.collect_exact_auroc = auroc_mode == 'exact_host'
        tpu_cfg = cfg.get('tpu') or {}
        self.mesh = mesh if mesh is not None else create_mesh(
            mesh_shape=tpu_cfg.get('mesh_shape', 'auto'))
        self.spatial_tiling = eval_cfg.get('spatial_tiling', 'auto')
        if self.spatial_tiling not in ('on', 'off', 'auto'):
            raise ValueError('evaluation.spatial_tiling must be on, off or '
                             f'auto, not {self.spatial_tiling!r}')
        self.tile_size = eval_cfg.get('tile_size', 'auto')
        self.tile_halo = int(eval_cfg.get('tile_halo', 128))
        self.device = resolve_device(device)
        self.policy = get_policy(tpu_cfg.get('precision', 'bf16'))
        self.dtype = self.policy.compute_dtype
        self.model = model.to(device=self.device, dtype=self.dtype).eval()
        self.last_acc: dict[str, torch.Tensor] | None = None

    def use_tiling(self, height: int, width: int) -> bool:
        """Whether an image of ``height`` × ``width`` is tiled."""
        if self.spatial_tiling == 'on':
            return True
        if self.spatial_tiling == 'auto':
            return height * width >= 2048 * 1024 and self.mesh.data.size > 1
        return False

    def tiles(self, height: int, width: int) -> tuple[int, int]:
        """The tile size for an image of ``height`` × ``width``."""
        if self.tile_size == 'auto':
            return choose_tile_grid(height, width, self.mesh.data.size)
        return tuple(self.tile_size)

    def init_acc(self, capacity: int = 0) -> dict[str, Any]:
        """Zeroed accumulators on the device; ``capacity`` pixels of score
        buffer in ``'exact'`` mode."""
        nw, c, dev = len(WEATHER_CONDITIONS), self.num_classes, self.device
        acc = {'cm': torch.zeros((nw, c, c), dtype=torch.int64, device=dev),
               'ece': torch.zeros((nw, self.num_bins, 3), dtype=torch.float64,
                                  device=dev),
               'auroc_hist': torch.zeros((AUROC_BINS, 2), dtype=torch.int64,
                                         device=dev)}
        if self.auroc_mode == 'exact':
            acc['scores'] = torch.zeros(capacity, dtype=torch.float32,
                                        device=dev)
            acc['errors'] = torch.full((capacity,), -1, dtype=torch.int8,
                                       device=dev)
            acc['offset'] = 0
        elif self.auroc_mode == 'exact_host':
            acc['host_scores'], acc['host_errors'] = [], []
        return acc

    @torch.inference_mode()
    def forward(self, images: torch.Tensor, labels: torch.Tensor,
                weather_ids: torch.Tensor,
                generator: torch.Generator | None = None,
                draws: Mapping[str, torch.Tensor] | None = None
                ) -> dict[str, torch.Tensor]:
        """Corrupt (draws from ``generator`` or given), normalise and run
        the model in the compute dtype; returns its outputs. An image that
        :meth:`use_tiling` picks runs through ``tiled_forward``, its tiles
        spread over the mesh's ranks (each rank returns every image's
        stitched outputs); a model whose forward takes ``tile_info`` runs
        the tiles exactly (the halo resynced, SR attention and ASPP on the
        full map)."""
        prep = prepare_batch(images, labels, weather_ids, generator=generator,
                             draws=draws, train=False, include_depth=False)
        x = prep['image'].to(self.dtype)
        h, w = x.shape[1], x.shape[2]
        if not self.use_tiling(h, w):
            return self.model(x)
        th, tw = self.tiles(h, w)
        exact = 'tile_info' in inspect.signature(
            type(self.model).forward).parameters

        def apply(_, tiles, *info):
            return (self.model(tiles, tile_info=info[0]) if exact
                    else self.model(tiles))
        outs = [tiled_forward(apply, None, img, th, tw, self.tile_halo,
                              mesh=self.mesh.data, with_tile_info=exact)
                for img in x]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    @torch.inference_mode()
    def accumulate(self, acc: dict[str, Any],
                   outputs: Mapping[str, torch.Tensor], labels: torch.Tensor,
                   weather_ids: torch.Tensor,
                   sample_mask: torch.Tensor | None = None) -> None:
        """Adds one batch's metrics into ``acc``: the per-weather confusion
        matrices from the model-dtype logits, the per-weather ECE bins from
        their f32 softmax and, for an ensemble, the disagreement of its two
        members against the errors of their mean softmax's argmax (not the
        ensemble's ``segmentation``) over the non-ignored pixels.
        ``sample_mask`` ([B] 0/1) leaves rows out (padded ones)."""
        nw = len(WEATHER_CONDITIONS)
        seg = outputs['segmentation']
        acc['cm'] += confusion_matrix_per_weather_from_logits(
            seg, labels, self.num_classes, weather_ids, nw,
            sample_mask=sample_mask)
        acc['ece'] += ece_bin_update_per_weather(
            seg, labels, weather_ids, nw, self.num_bins,
            sample_mask=sample_mask, class_axis=-1)
        if 'segformer_seg' not in outputs:
            return
        dis, mean_probs = disagreement_and_mean_probs(
            [outputs['segformer_seg'], outputs['deeplabv3plus_seg']],
            class_axis=-1)
        dis = dis.reshape(-1)
        errors = (mean_probs.argmax(dim=-1) != labels).reshape(-1)
        valid = labels != 255
        if sample_mask is not None:
            valid &= sample_mask.bool().reshape((-1,) + (1,) * (
                labels.ndim - 1))
        valid = valid.reshape(-1)
        acc['auroc_hist'] += auroc_histogram_update(
            dis, errors, AUROC_BINS, *AUROC_RANGE, weights=valid,
            log_scale=True)
        if self.auroc_mode == 'exact_host':
            acc['host_scores'].append(dis.cpu())
            acc['host_errors'].append(
                torch.where(valid, errors.to(torch.int8), -1).cpu())
        elif self.auroc_mode == 'exact':
            off, n = acc['offset'], dis.numel()
            acc['scores'][off:off + n] = dis
            acc['errors'][off:off + n] = torch.where(
                valid, errors.to(torch.int8), -1)
            acc['offset'] = off + n

    def _exact_capacity(self, test_loader, rows_shape) -> int:
        """The score buffer's pixels for ``'exact'`` mode (``rows_shape``:
        the rows this rank keeps of a batch, with their height and width);
        falls back to the histogram (warning) when it would pass
        ``evaluation.exact_auroc_max_bytes`` (default 4 GiB)."""
        try:
            n_batches = len(test_loader)
        except TypeError:
            raise ValueError("auroc_mode='exact' needs a sized loader; use "
                             "'exact_host' or 'histogram' for unsized "
                             'streams') from None
        capacity = n_batches * int(np.prod(rows_shape))
        budget = int((self.config.get('evaluation') or {}).get(
            'exact_auroc_max_bytes', 4 << 30))
        if capacity * 5 > budget:
            logger.warning(
                "auroc_mode='exact' would need %.1f GB for the score buffer "
                '(budget %.1f GB, evaluation.exact_auroc_max_bytes); falling '
                'back to the 2^20-bin histogram estimator',
                capacity * 5 / 2 ** 30, budget / 2 ** 30)
            self.auroc_mode = 'histogram'
            return 0
        return capacity

    def _rows(self, images, labels, wids, draws, generator):
        """The batch and its draws padded to a multiple of the mesh's size
        by repeating the last row (the draws are the real rows', drawn now
        when not given, so the generator advances as on one device), with
        the sample mask: ones, then zeros on the padded rows."""
        b, h, w = images.shape[:3]
        if draws is None:
            draws = draw_corruption(wids, h, w, generator)
        pad = (-b) % self.mesh.data.size

        def edge(t):
            return torch.cat([t, t[-1:].expand(pad, *t.shape[1:])]) if pad \
                else t
        mask = torch.ones(b + pad, device=self.device)
        mask[b:] = 0.0
        return (edge(images), edge(labels), edge(wids),
                {k: edge(v) for k, v in draws.items()}, mask)

    def run(self, test_loader: Iterable[Mapping[str, Any]], seed: int = 42,
            draws: Sequence[Mapping[str, torch.Tensor]] | None = None
            ) -> dict[str, Any]:
        """The sweep over ``test_loader``'s batches (dicts with ``image``
        [B, H, W, 3] uint8, ``label`` [B, H, W], ``weather_id`` [B] and
        ``sample_id`` [B], as numpy arrays or tensors; ``sample_id`` keys
        the JAX package's draws and is not read here). Across devices every
        rank reads the same global batches. The corruption draws come from
        a generator seeded with ``seed``, or from ``draws``, one mapping
        per batch. Returns the JAX package's result schema."""
        dev = self.device
        generator = torch.Generator(device=dev).manual_seed(seed)
        acc = None
        n_images = 0
        t0 = time.time()
        for i, batch in enumerate(test_loader):
            images = torch.as_tensor(batch['image']).to(dev)
            labels = torch.as_tensor(batch['label']).to(dev)
            wids = torch.as_tensor(batch['weather_id']).to(dev)
            n_images += images.shape[0]
            d = None if draws is None else {k: v.to(dev)
                                            for k, v in draws[i].items()}
            images, labels, wids, d, mask = self._rows(images, labels, wids,
                                                       d, generator)
            rows = mesh_rows(self.mesh, images.shape[0])
            if self.use_tiling(*images.shape[1:3]):
                out = self.forward(images, labels, wids, draws=d)
                out = {k: v[rows] for k, v in out.items()}
            else:
                out = self.forward(images[rows], labels[rows], wids[rows],
                                   draws={k: v[rows] for k, v in d.items()})
            images, labels, wids, mask = (t[rows] for t in (images, labels,
                                                            wids, mask))
            if acc is None:
                capacity = (self._exact_capacity(test_loader,
                                                 images.shape[:3])
                            if self.auroc_mode == 'exact' else 0)
                acc = self.init_acc(capacity)
            self.accumulate(acc, out, labels, wids,
                            mask if self.mesh.data.size > 1 else None)
        if acc is None:
            acc = self.init_acc()
        exact_auroc = None
        if self.auroc_mode == 'exact':
            n = acc['offset']
            errors = acc['errors'][:n]
            valid = errors >= 0
            exact_auroc = float(auroc_exact_sharded(
                acc['scores'][:n], errors.float() * valid, valid.float(),
                self.mesh.data))
        elif self.auroc_mode == 'exact_host' and acc['host_scores']:
            s = torch.cat(acc['host_scores'])
            e = torch.cat(acc['host_errors'])
            keep = e >= 0
            exact_auroc = float(auroc_exact_sharded(s[keep], e[keep], None,
                                                    self.mesh.data))
        totals = psum_tree({k: acc[k] for k in ('cm', 'ece', 'auroc_hist')},
                           self.mesh.data)
        cms, ece, hist = (totals[k].cpu() for k in ('cm', 'ece',
                                                    'auroc_hist'))
        elapsed = time.time() - t0
        self.last_acc = {'cm': cms, 'ece': ece, 'auroc_hist': hist}
        return _results(cms, ece, hist, exact_auroc, self.num_classes) | {
            '_throughput_images_per_sec': n_images / max(elapsed, 1e-9),
            '_eval_seconds': elapsed, '_num_images': n_images}


def _results(cms, ece, hist, exact_auroc, num_classes) -> dict[str, Any]:
    """The result schema from the per-weather accumulators on the host."""
    results: dict[str, Any] = {}
    results['overall_miou'] = float(
        iou_from_confusion(cms.sum(0))['mean_iou'])
    weather_mious: dict[str, float] = {}
    for wid, weather in enumerate(WEATHER_CONDITIONS):
        if cms[wid].sum() > 0:
            weather_mious[weather] = results[f'miou_{weather}'] = float(
                iou_from_confusion(cms[wid])['mean_iou'])
    results['expected_calibration_error'] = float(ece_from_bins(ece.sum(0)))
    for wid, weather in enumerate(WEATHER_CONDITIONS):
        if ece[wid, :, 0].sum() > 0:
            results[f'ece_{weather}'] = float(ece_from_bins(ece[wid]))
    if hist.sum() > 0:
        hist_auroc = float(auroc_from_histogram(hist))
        if exact_auroc is not None:
            results['ensemble_disagreement_auroc'] = exact_auroc
            results['_auroc_histogram_estimate'] = hist_auroc
        else:
            results['ensemble_disagreement_auroc'] = hist_auroc
    if 'clean' in weather_mious:
        rm = RobustnessMetrics(num_classes)
        degradations = []
        for weather in ADVERSE_WEATHERS:
            if weather in weather_mious:
                d = rm.compute_robustness_degradation_ratio(
                    weather_mious['clean'], weather_mious[weather])
                results[f'robustness_degradation_{weather}'] = d
                degradations.append(d)
        if degradations:
            results['robustness_degradation_ratio'] = float(
                np.mean(degradations))
    return results


def generate_evaluation_report(results: Mapping[str, Any], output_dir,
                               target_metrics: Mapping[str, float] | None
                               = None) -> None:
    """Write ``evaluation_results.json`` and ``evaluation_report.md``, with
    the reference's targets table."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    with open(output_dir / 'evaluation_results.json', 'w') as f:
        json.dump(dict(results), f, indent=2, default=float)
    if target_metrics is None:
        target_metrics = {
            'miou_clean': 0.78, 'miou_fog': 0.65, 'miou_rain': 0.62,
            'robustness_degradation_ratio': 0.18,
            'expected_calibration_error': 0.05,
            'ensemble_disagreement_auroc': 0.85}
    lines = ['# Adverse Weather Semantic Segmentation Evaluation Report', '',
             '## Summary Metrics', '',
             '| Metric | Target | Actual | Status |',
             '|--------|--------|--------|--------|']
    for metric, target in target_metrics.items():
        actual = results.get(metric, 0.0)
        status = '✓' if actual >= target else '✗'
        lines.append(f'| {metric} | {target:.3f} | {actual:.3f} | {status} |')
    lines += ['', '## Weather-Specific Performance', '']
    for weather in WEATHER_CONDITIONS:
        key = f'miou_{weather}'
        if key in results:
            lines.append(f'- **{weather.title()}**: mIoU = {results[key]:.3f}')
    lines += ['', '## Robustness Analysis', '']
    if 'robustness_degradation_ratio' in results:
        lines.append('- **Overall Degradation Ratio**: '
                     f"{results['robustness_degradation_ratio']:.3f}")
    for weather in ADVERSE_WEATHERS:
        key = f'robustness_degradation_{weather}'
        if key in results:
            lines.append(f'- **{weather.title()} Degradation**: '
                         f'{results[key]:.3f}')
    if 'expected_calibration_error' in results:
        lines += ['', '## Confidence Calibration', '',
                  '- **Expected Calibration Error**: '
                  f"{results['expected_calibration_error']:.3f}"]
    if 'ensemble_disagreement_auroc' in results:
        lines += ['', '## Ensemble Performance', '',
                  '- **Disagreement AUROC**: '
                  f"{results['ensemble_disagreement_auroc']:.3f}"]
    with open(output_dir / 'evaluation_report.md', 'w') as f:
        f.write('\n'.join(lines))
    logger.info(f'Evaluation report saved to {output_dir}')
