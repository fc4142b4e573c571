"""Fine-tuning: ``TrainStep`` (forward, fog-density-aware loss, backward,
clip, AdamW) over a closed loop of host batches.

Set-up makes the f32 master weights and a pool of host batches with every
draw of a step (corruption, augmentation, fog uniforms, the heads' dropout
seeds, ASPP's keep mask) from the seed, builds the port's ensemble and one
``TrainStep`` (bench.py's optimiser: clip 1.0, AdamW lr 1e-3, decay 1e-4;
bf16 compute), and drives it through its first three steps on pool
batches 0, 1, 2 (rows that all differ), through the window's own call.
Those steps are the warm-up; the same object then runs the window, round
and round the pool, until the window's seconds have passed, ending in a
synchronise. Images per second are the window's steps × batch over its
seconds.

The check follows the first three steps with the plain reference in f32
(TF32 off), from the same weights and draws: each step's total loss, the
first gradient as AdamW got it (its first moment after one step over
1 − β1), and each leaf's change over the three steps. Leaves are judged by
norms, the gap between the program's and the reference's, over the
reference's norm of that leaf or of the median leaf, whichever is larger;
the change leaves out leaves whose reference gradient is under a
thousandth of the median leaf's (they move by round-off under AdamW).
"""

from __future__ import annotations

import time
from typing import Any, Mapping

import torch

from ..common import port, weights
from ..common import traffic as gen
from ..common.clock import Clock
from ..common.trace import set_span
from .sweep import no_tf32, nothing

KERNELS = ('sr_attention', 'sr_attention_bwd', 'seg_head', 'seg_head_train',
           'depth_stage1_train', 'pp_adjoint', 'splat')
FAULTS = ('unchanged', 'half_batch', 'altered')
CHECK_STEPS = 3
BETA1 = 0.9
LR, WEIGHT_DECAY, CLIP = 1e-3, 1e-4, 1.0


def step_draws(seed: int, pool: list[dict], device) -> list[dict]:
    """Every draw of a train step for each pool batch, on ``device``."""
    from ..reference.data import draw_augment
    from ..reference.weather.corruption import draw_corruption
    g = torch.Generator(device=device).manual_seed(seed ^ 0x7A1)
    out = []
    for batch in pool:
        b, h, w, _ = batch['image'].shape
        wid = batch['weather_id'].to(device)

        def seed32():
            return torch.randint(-2 ** 31, 2 ** 31, (), generator=g,
                                 device=device,
                                 dtype=torch.int64).to(torch.int32)
        out.append({
            'corruption': draw_corruption(wid, h, w, g),
            'augment': draw_augment(b, g, device),
            'fog_u': torch.rand((b, h, w), generator=g, device=device),
            'seed': seed32(), 'segformer_depth_seed': seed32(),
            'deeplab_depth_seed': seed32(),
            'aspp_mask': torch.rand((b, -(-h // 16), -(-w // 16), 256),
                                    generator=g, device=device) < 0.5})
    return out


def leaf_gaps(got: Mapping[str, float], want: Mapping[str, float],
              keep=None) -> dict[str, float]:
    """Each leaf's |got − want| / max(want, the median of want)."""
    names = [k for k in want if keep is None or k in keep]
    vals = sorted(want[k] for k in names)
    median = vals[len(vals) // 2]
    return {k: abs(got[k] - want[k]) / max(want[k], median, 1e-30)
            for k in names}


def worst(gaps: Mapping[str, float], n: int = 3) -> list:
    return sorted(gaps.items(), key=lambda kv: -kv[1])[:n]


class Driver:
    unit = 'images'

    def __init__(self, config: Mapping[str, Any], traffic: Mapping[str, Any],
                 seed: int, device: str, traced: bool) -> None:
        if config['model']['type'] != 'ensemble':
            raise ValueError('the train driver runs the ensemble only, not '
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
        self.pool = gen.host_pool(self.seed, self.traffic,
                                  self.config['model']['num_classes'],
                                  pin=self.device.type == 'cuda')
        self.draws = step_draws(self.seed, self.pool, self.device)

    def call(self, i: int) -> dict:
        batch = self.pool[i % len(self.pool)]
        return self.step(batch['image'], batch['label'], batch['weather_id'],
                         draws=self.draws[i % len(self.draws)])

    def setup(self) -> None:
        from awsegbench_torch.train.step import TrainStep
        if self.device.type == 'cuda':
            from awsegbench_torch import _build
            _build.build_all(KERNELS)
        clock = Clock(self.notes, self.sync)
        self.inputs()
        state = weights.make_state(self.shapes, self.seed, self.device)
        model = port.build(self.config, state)
        names = [n for n, _ in model.named_parameters()]
        theta0 = {n: state[n].clone() for n in names}
        del state
        self.step = TrainStep(model, precision=self.traffic['precision'],
                              device=self.device)
        clock('weights, model, pool and draws')
        params = dict(self.step.model.named_parameters())
        self.losses = [self.call(i)['total_loss'] for i in range(1)]
        inner = self.step.optimizer.inner
        # a step that moved nothing leaves no moment: its gradient reads 0
        self.first_grad = {n: float(inner.state[p]['exp_avg'].norm()
                                    / (1 - BETA1))
                           if 'exp_avg' in inner.state.get(p, {}) else 0.0
                           for n, p in params.items()}
        self.losses += [self.call(i)['total_loss']
                        for i in range(1, CHECK_STEPS)]
        self.change = {n: float((p.detach() - theta0[n]).norm())
                       for n, p in params.items()}
        self.losses = [float(v) for v in self.losses]
        del theta0
        clock('three checked steps')
        if self.traced:
            set_span(self.step.optimizer, 'step', 'train.optim')
            m = self.step.model
            set_span(m.segformer, 'forward', 'train.segformer')
            set_span(m.deeplabv3plus, 'forward', 'train.deeplab')
        self.next = CHECK_STEPS
        for _ in range(self.traffic['warmup']):
            self.call(self.next)
            self.next += 1
        clock('warm-up')

    def window(self, seconds: float | None = None,
               iterations: int | None = None) -> dict[str, float]:
        t0 = time.perf_counter()
        steps = 0
        while (time.perf_counter() < t0 + (seconds or 0.0)
               if iterations is None else steps < iterations):
            self.call(self.next)
            self.next += 1
            steps += 1
        self.sync()
        self.window_s = time.perf_counter() - t0
        self.steps = steps
        self.attempted = steps * self.traffic['batch']
        return {'train_images_per_s': self.attempted / self.window_s}

    def trace_context(self, trace) -> dict[str, Any]:
        from ..counts.flops import train_flops
        t = self.traffic
        return {'trace': trace, 'config': self.config, 'traffic': t,
                'units': self.attempted,
                'flops_per_unit': train_flops(self.config, t['height'],
                                              t['width'])}

    def reference(self, fp8: bool = False) -> dict[str, Any]:
        """The reference's three steps: losses, first gradient and change
        norms per leaf (``fp8``: the control's, products fed e4m3)."""
        from ..reference import model as ref_model
        from ..reference import train as ref_train
        from ..reference.lowp import Fp8Operands
        dev = self.device
        state = weights.make_state(self.shapes, self.seed, dev)
        model = ref_model.build(self.config, state, dev).train()
        del state
        named = dict(model.named_parameters())
        theta0 = {n: p.detach().clone() for n, p in named.items()}
        opt = ref_train.AdamW(list(named.values()), LR, WEIGHT_DECAY,
                              clip=CLIP)
        losses = []
        with no_tf32():
            for i in range(CHECK_STEPS):
                b = self.pool[i]
                losses.append(ref_train.step(
                    model, opt, b['image'].to(dev), b['label'].to(dev),
                    b['weather_id'].to(dev), self.draws[i],
                    Fp8Operands if fp8 else nothing)['total_loss'])
                if i == 0:
                    first = {n: float(g.norm()) for n, g in
                             zip(named, opt.first_grads)}
        change = {n: float((p.detach() - theta0[n]).norm())
                  for n, p in named.items()}
        return {'losses': losses, 'first_grad': first, 'change': change}

    def compare(self, got: Mapping, want: Mapping) -> dict[str, float]:
        """loss_gap: the largest relative gap of a step's total loss;
        grad_gap, update_gap: the worst leaf's norm gap (``leaf_gaps``) of
        the first gradient and of the change over three steps;
        grad_gap_median, update_gap_median: the median leaf's."""
        grads = want['first_grad']
        median = sorted(grads.values())[len(grads) // 2]
        moving = {n for n, v in grads.items() if v >= 1e-3 * median}
        g = leaf_gaps(got['first_grad'], grads)
        u = leaf_gaps(got['change'], want['change'], moving)
        self.notes.append(f'worst leaves: gradient {worst(g)}; change '
                          f'{worst(u)}; {len(grads) - len(moving)} leaves '
                          f'left out of the change')

        def mid(d):
            return sorted(d.values())[len(d) // 2]

        def mean(d):
            return sum(d.values()) / len(d)
        losses = [abs(a - b) / abs(b) for a, b in zip(got['losses'],
                                                      want['losses'])]
        return {'loss_gap': max(losses), 'loss1_gap': losses[0],
                'grad_gap': max(g.values()), 'grad_gap_median': mid(g),
                'grad_gap_mean': mean(g), 'update_gap': max(u.values()),
                'update_gap_median': mid(u), 'update_gap_mean': mean(u)}

    def control(self) -> dict[str, float]:
        self.inputs()
        return self.compare(self.reference(fp8=True), self.reference())

    def check(self, limits: Mapping[str, float]) -> dict[str, tuple]:
        del self.step
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()
        clock = Clock(self.notes, self.sync)
        want = self.reference()
        clock('reference')
        self.notes.append(f'window: {self.steps} steps, {self.attempted} '
                          f'images in {self.window_s!r} s')
        got = {'losses': self.losses, 'first_grad': self.first_grad,
               'change': self.change}
        nums = self.compare(got, want)
        self.notes.append('not compared: ' + str(
            {k: v for k, v in nums.items() if k not in limits}))
        return {k: (nums[k], limits[k]) for k in limits}
