"""A served camera frame: ``ServingModel.predict`` on one uint8 frame at a
time, one client in a closed loop.

Set-up makes the weights (bf16, as served) from the seed, exports the
port's serving program (``export_serving``: ``torch.export`` of the eval
forward at 512×1024, batch 1, K1 and K2 as custom ops) into a temporary
directory, loads it back with ``ServingModel.load`` (as a serving host
does) and serves a few frames. The weights follow the seed, so every run
exports anew; the export's seconds are noted. The window sends a pool of
host frames round and round, timing each request on the host clock from
the call until its outputs are on the card (synchronised); the 95th
percentile of all the window's requests is the end-to-end metric.

The check: a sample of the window's requests, drawn from the seed before
the window, keeps its outputs (the ensemble's f32 logits and depth); the
plain reference computes the same frames in f32 (TF32 off) afterwards.
The number compared is the widest relative L2 distance of a sampled
request's logits from the reference's.
"""

from __future__ import annotations

import shutil
import statistics
import tempfile
import time
from pathlib import Path
from typing import Any, Mapping

import torch

from ..common import port, weights
from ..common import traffic as gen
from ..common.clock import Clock
from ..common.trace import set_span
from .sweep import no_tf32, nothing

KERNELS = ('sr_attention', 'seg_head')
FAULTS = ('altered',)


class Driver:
    unit = 'requests'

    def __init__(self, config: Mapping[str, Any], traffic: Mapping[str, Any],
                 seed: int, device: str, traced: bool) -> None:
        if config['model']['type'] != 'ensemble':
            raise ValueError('the serve driver runs the ensemble only, not '
                             f"model type {config['model']['type']!r}")
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.traced = seed, torch.device(device), traced
        self.attempted = self.failed = 0
        self.notes: list[str] = []

    def sync(self) -> None:
        if self.device.type == 'cuda':
            torch.cuda.synchronize()

    def inputs(self) -> None:
        self.shapes = weights.shapes_of(port.skeleton(self.config))
        t = dict(self.traffic, batch=1)
        self.frames = [b['image'] for b in gen.host_pool(
            self.seed, t, self.config['model']['num_classes'],
            pin=self.device.type == 'cuda')]
        g = torch.Generator().manual_seed(self.seed ^ 0x5A3)
        # a traced window serves trace_iterations requests
        span = t['trace_iterations'] if self.traced else t['sample_from']
        self.sample = sorted(torch.randperm(
            span, generator=g)[:t['sample']].tolist())

    def setup(self) -> None:
        from awsegbench_torch.serving import (ServingModel, export_serving,
                                              save_serving_artifact)
        if self.device.type == 'cuda':
            from awsegbench_torch import _build
            _build.build_all(KERNELS)
        t = self.traffic
        clock = Clock(self.notes, self.sync)
        self.inputs()
        state = weights.make_state(self.shapes, self.seed, self.device,
                                   torch.bfloat16)
        model = port.build(self.config, state)
        del state
        clock('weights and model')
        blob = export_serving(model, (t['height'], t['width']), batch_size=1,
                              precision=t['precision'], include_depth=True,
                              platforms=(self.device.type,))
        del model
        clock('export')
        tmp = Path(tempfile.mkdtemp(prefix='portbench-serve-'))
        try:
            save_serving_artifact(tmp, blob, {
                'input_shape': [1, t['height'], t['width'], 3],
                'input_dtype': 'uint8', 'precision': t['precision'],
                'include_depth': True, 'platforms': [self.device.type]})
            self.notes.append(f'artifact: {len(blob)} bytes')
            del blob
            self.served = ServingModel.load(tmp, device=self.device)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        clock('save and load')
        if self.traced:
            set_span(self.served, 'predict', 'serve.predict')
        for i in range(t['warmup']):
            self.served.predict(self.frames[i % len(self.frames)])
        clock('warm-up')

    def window(self, seconds: float | None = None,
               iterations: int | None = None) -> dict[str, float]:
        n, keep = len(self.frames), set(self.sample)
        self.kept, lat = {}, []
        t0 = time.perf_counter()
        i = 0
        while (time.perf_counter() < t0 + (seconds or 0.0)
               if iterations is None else i < iterations):
            s = time.perf_counter()
            out = self.served.predict(self.frames[i % n])
            self.sync()
            lat.append(time.perf_counter() - s)
            if i in keep:
                self.kept[i] = out
            i += 1
        self.window_s = time.perf_counter() - t0
        self.attempted = i
        self.latencies = lat
        self.notes.append(f'requests: {i} in {self.window_s!r} s; median '
                          f'{statistics.median(lat) * 1e3!r} ms')
        p95 = statistics.quantiles(lat, n=20)[18] if len(lat) > 1 else lat[0]
        return {'serve_p95_ms': p95 * 1e3}

    def trace_context(self, trace) -> dict[str, Any]:
        return {'trace': trace, 'config': self.config,
                'traffic': self.traffic, 'units': self.attempted}

    def reference(self, indices, fp8: bool = False) -> dict[int, dict]:
        """The reference's f32 outputs for the requests ``indices``
        (``fp8``: the control's)."""
        from ..reference import model as ref_model
        from ..reference.data import normalize_imagenet
        from ..reference.lowp import Fp8Operands
        dev = self.device
        state = weights.make_state(self.shapes, self.seed, dev,
                                   torch.bfloat16)
        model = ref_model.build(self.config, state, dev)
        del state
        out = {}
        with torch.inference_mode(), no_tf32():
            for i in indices:
                x = normalize_imagenet(
                    self.frames[i % len(self.frames)].to(dev))
                with Fp8Operands() if fp8 else nothing():
                    o = model(x)
                out[i] = {'segmentation': o['segmentation'],
                          'depth': o['depth']}
        return out

    @staticmethod
    def compare(got: Mapping[int, Mapping], want: Mapping[int, Mapping]
                ) -> dict[str, float]:
        """seg_rel, depth_rel: the widest ‖got − want‖ / ‖want‖ over the
        sampled requests, of the logits and of the depth (not compared: the
        program's bf16 rounding of a sigmoid near 0.5 and the control's
        readings overlap, ``PERF.md``)."""
        def rel(a, b):
            a, b = a.double(), b.double()
            return float((a - b).norm() / b.norm().clamp(min=1e-30))
        return {f'{k}_rel': max(rel(got[i][name], want[i][name])
                                for i in want)
                for k, name in (('seg', 'segmentation'), ('depth', 'depth'))}

    def control(self) -> dict[str, float]:
        self.inputs()
        idx = self.sample
        return self.compare(self.reference(idx, fp8=True),
                            self.reference(idx))

    def check(self, limits: Mapping[str, float]) -> dict[str, tuple]:
        del self.served
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()
        clock = Clock(self.notes, self.sync)
        if not self.kept:
            self.failed = self.attempted
            return {k: (float('nan'), v) for k, v in limits.items()}
        want = self.reference(sorted(self.kept))
        clock('reference')
        got = {i: {k: v.float() for k, v in o.items()}
               for i, o in self.kept.items()}
        nums = self.compare(got, want)
        self.notes.append('not compared: ' + str(
            {k: v for k, v in nums.items() if k not in limits}))
        return {k: (nums[k], limits[k]) for k in limits}
