"""The robustness sweep: ``Evaluator.run`` over a closed loop of host
batches.

Set-up makes the weights (bf16, as the sweep runs them) and a pool of host
batches with their corruption draws from the seed, builds the port's model
(any type with an adapter, ``portbench/models/``) and ``Evaluator``
(``auroc_mode`` from the traffic) and sweeps the pool's first batches
(every shape and kernel built). The window is one ``Evaluator.run`` over
the pool, round and round, until the window's seconds have passed; it
ends after the run's final reduction and a synchronise. Images per second
are the images swept over the window's seconds.

The check, of what the window produced:

* ``logits_rel``: for a sample of the window's batches drawn from the
  seed, the adapter's ``OUTPUTS`` (the ensemble's and both members'
  logits; a single model's) as ``accumulate`` received them (copied aside
  in the window into buffers laid out alike) against the plain reference's
  f32 forward of the same uint8 batch and draws (TF32 off, in blocks of
  rows): the widest relative L2 distance. Corruption, the model (K1, K2
  and the library convs) and the ensemble's combination are in it.
* ``metrics_exact``: for the same batches, what ``accumulate`` added to the
  accumulators (confusion matrices, ECE bin counts and accuracy sums, and
  with the adapter's two ``MEMBERS`` the disagreement histogram) against
  the reference's metric code on the logits the program produced: the
  count of values that differ (exact).
* ``counts_exact``: over the whole window, the pixels each accumulator
  (the histogram only with members) counted against the valid pixels of
  the batches swept (exact).

The accumulated sums are not compared against the reference's own forward:
with random weights the logits are nearly tied, and the sums the program's
bf16 moves overlap those that the fp8 control moves (``PERF.md``).
"""

from __future__ import annotations

import time
from typing import Any, Mapping

import torch

from ..common import port, weights
from ..common import traffic as gen
from ..common.clock import Clock
from ..common.trace import set_span
from ..models import adapter

KERNELS = ('sr_attention', 'seg_head', 'splat')
FAULTS = ('unchanged', 'half_batch', 'altered')
# the sweep's disagreement histogram: 2^20 log-spaced bins of the mutual
# information over [-0.01, 0.75)
AUROC_BINS, AUROC_RANGE, N_ECE_BINS = 1 << 20, (-0.01, 0.75), 15


class Driver:
    unit = 'images'

    def __init__(self, config: Mapping[str, Any], traffic: Mapping[str, Any],
                 seed: int, device: str, traced: bool) -> None:
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.traced = seed, torch.device(device), traced
        self.attempted = self.failed = 0
        self.notes: list[str] = []
        self.adapter = adapter(config)
        self.members = self.adapter.MEMBERS
        # the accumulators one batch adds to: the histogram only with members
        self.accs = ('cm', 'ece') + (('auroc_hist',) if self.members else ())

    @property
    def num_classes(self) -> int:
        return self.config['model']['num_classes']

    def sync(self) -> None:
        if self.device.type == 'cuda':
            torch.cuda.synchronize()

    def inputs(self) -> None:
        """The weights' leaves, the host pool, its draws and the sample of
        window batches kept for the check, all from the seed."""
        t = self.traffic
        self.shapes = weights.shapes_of(port.skeleton(self.config))
        self.pool = gen.host_pool(self.seed, t, self.num_classes,
                                  pin=self.device.type == 'cuda')
        self.draws = gen.corruption_draws(self.seed, self.pool, self.device)
        g = torch.Generator().manual_seed(self.seed ^ 0x5A3)
        self.sample = sorted(torch.randperm(len(self.pool), generator=g)
                             [:t['sample']].tolist())

    # -- set-up --------------------------------------------------------
    def setup(self) -> None:
        from awsegbench_torch.eval.evaluator import Evaluator
        if self.device.type == 'cuda':
            from awsegbench_torch import _build
            _build.build_all(KERNELS)
        t = self.traffic
        clock = Clock(self.notes, self.sync)
        self.inputs()
        clock('pool and draws')
        state = weights.make_state(self.shapes, self.seed, self.device,
                                   torch.bfloat16)
        self.model = port.build(self.config, state)
        del state
        self.ev = Evaluator(self.model, {'model': dict(self.config['model']),
                                         'tpu': {'precision': t['precision']}},
                            auroc_mode=t['auroc_mode'], device=self.device)
        clock('weights and model')
        self.keep: dict[int, dict] = {}
        self.calls = -1                 # no batch of the window yet
        self._keep_aside(self.ev)
        if self.traced:
            set_span(self.ev, 'accumulate', 'sweep.accumulate')
            for obj, attr, name in self.adapter.spans(self.ev.model):
                set_span(obj, attr, name)
        for i in range(t['warmup']):
            self.ev.run(self.pool[i:i + 1], seed=0,
                        draws=self.draws[i:i + 1])
            clock(f'warm-up batch {i}')

    def _keep_aside(self, ev) -> None:
        """Wraps the instance's ``accumulate``: for the window's sampled
        batches, its logits are copied into buffers of the same layout
        (made at the first call, in the warm-up) and what it added to the
        accumulators is kept."""
        accumulate = ev.accumulate

        def kept(acc, outputs, labels, weather_ids, sample_mask=None):
            if not hasattr(self, 'buffers'):
                self.buffers = {i: {k: torch.empty_strided(
                    outputs[k].size(), outputs[k].stride(),
                    dtype=outputs[k].dtype, device=outputs[k].device)
                    for k in self.adapter.OUTPUTS} for i in self.sample}
            i = self.calls
            if i in self.buffers:
                before = {k: acc[k].clone() for k in self.accs}
                for k in self.adapter.OUTPUTS:
                    self.buffers[i][k].copy_(outputs[k])
            out = accumulate(acc, outputs, labels, weather_ids, sample_mask)
            if i in self.buffers:
                self.keep[i] = {k: acc[k] - before[k] for k in self.accs}
            if i >= 0:
                self.calls += 1
            return out
        ev.accumulate = kept

    # -- the window ----------------------------------------------------
    def window(self, seconds: float | None = None,
               iterations: int | None = None) -> dict[str, float]:
        n = len(self.pool)
        self.counts = [0] * n
        self.calls = 0

        def loader():
            i = 0
            while (time.perf_counter() < deadline if iterations is None
                   else i < iterations):
                self.counts[i % n] += 1
                yield self.pool[i % n]
                i += 1
        t0 = time.perf_counter()
        deadline = t0 + (seconds or 0.0)
        self.ev.run(loader(), seed=0, draws=gen.Cycle(self.draws))
        self.sync()
        dt = time.perf_counter() - t0
        self.window_s = dt
        self.attempted = sum(self.counts) * self.traffic['batch']
        self.acc = dict(self.ev.last_acc)
        return {'sweep_images_per_s': self.attempted / dt}

    def trace_context(self, trace) -> dict[str, Any]:
        from ..counts.flops import forward_flops
        t = self.traffic
        return {'trace': trace, 'config': self.config, 'traffic': t,
                'units': self.attempted,
                'flops_per_unit': forward_flops(self.config, t['height'],
                                                t['width'])}

    # -- the check -----------------------------------------------------
    def reference_logits(self, k: int, fp8: bool = False
                         ) -> dict[str, torch.Tensor]:
        """The reference's f32 logits of pool batch ``k`` (``fp8``: the
        control's, its products fed e4m3 operands)."""
        from ..reference import model as ref_model
        from ..reference.data import prepare_batch
        from ..reference.lowp import Fp8Operands
        dev = self.device
        if getattr(self, '_ref', None) is None:
            state = weights.make_state(self.shapes, self.seed, dev,
                                       torch.bfloat16)
            self._ref = ref_model.build(self.config, state, dev)
            del state
        rows = self.traffic['reference_rows']
        batch, draws = self.pool[k], self.draws[k]
        parts = []
        with torch.inference_mode(), no_tf32():
            for r0 in range(0, batch['image'].shape[0], rows):
                sl = slice(r0, r0 + rows)
                prep = prepare_batch(
                    batch['image'][sl].to(dev), batch['label'][sl].to(dev),
                    batch['weather_id'][sl].to(dev),
                    {n: v[sl] for n, v in draws.items()})
                with Fp8Operands() if fp8 else nothing():
                    out = self._ref(prep['image'])
                parts.append({n: out[n] for n in self.adapter.OUTPUTS})
        return {n: torch.cat([p[n] for p in parts])
                for n in self.adapter.OUTPUTS}

    def check(self, limits: Mapping[str, float]) -> dict[str, tuple]:
        del self.ev, self.model
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()
        clock = Clock(self.notes, self.sync)
        n = len(self.pool)
        missing = [i for i in self.sample if i not in self.keep]
        self.failed = len(missing) * self.traffic['batch']
        rel, exact = 0.0, 0
        for i in sorted(self.keep):
            k = i % n
            got = self.buffers[i]
            rel = max(rel, logits_rel(got, self.reference_logits(k)))
            exact += metrics_mismatch(self.keep[i], got, self.members,
                                      self.pool[k], self.device,
                                      self.num_classes)
        clock('reference')
        valid = [int((b['label'] != 255).sum()) for b in self.pool]
        want = sum(c * v for c, v in zip(self.counts, valid))
        counted = [int(self.acc['cm'].sum()),
                   int(self.acc['ece'][..., 0].sum())]
        if self.members:
            counted.append(int(self.acc['auroc_hist'].sum()))
        self.notes.append(f'window: {sum(self.counts)} batches, '
                          f'{self.attempted} images in {self.window_s!r} s; '
                          f'sampled batches {sorted(self.keep)}, missing '
                          f'{missing}')
        nums = {'logits_rel': rel if self.keep else float('nan'),
                'metrics_exact': float(exact),
                'counts_exact': float(sum(abs(c - want) for c in counted))}
        return {k: (v, limits[k]) for k, v in nums.items()}

    def control(self) -> dict[str, float]:
        """The control's number: the reference fed fp8 operands in the
        program's place, on the sampled pool batches, against the f32
        reference. Needs no set-up of the program."""
        self.inputs()
        return {'logits_rel': max(
            logits_rel(self.reference_logits(k, fp8=True),
                       self.reference_logits(k)) for k in self.sample)}


def logits_rel(got: Mapping[str, torch.Tensor],
               want: Mapping[str, torch.Tensor]) -> float:
    """The widest ‖got − want‖ / ‖want‖ over the logits in ``want``."""
    return max(float((got[k].double() - want[k].double()).norm()
                     / want[k].double().norm()) for k in want)


def metrics_mismatch(added: Mapping[str, torch.Tensor],
                     logits: Mapping[str, torch.Tensor], members,
                     batch: Mapping[str, torch.Tensor], device,
                     num_classes: int) -> int:
    """How many of the integer values that ``accumulate`` added for one
    batch (confusion matrices, ECE bin counts and accuracy sums, and the
    histogram of the ``members``' logits where there are two) differ from
    the reference's metric code on the same logits."""
    from ..reference.metrics import accumulators
    want = accumulators(logits['segmentation'], batch['label'].to(device),
                        batch['weather_id'].to(device), num_classes,
                        gen.N_WEATHERS, N_ECE_BINS, AUROC_BINS, AUROC_RANGE,
                        members=[logits[k] for k in members])
    pairs = [(added['cm'], want['cm']),
             (added['ece'][..., 0], want['ece'][..., 0]),
             (added['ece'][..., 2], want['ece'][..., 2])]
    if members:
        pairs.append((added['auroc_hist'], want['hist']))
    return int(sum(int((a.double().to(device) - b.double()).abs().sum())
                   for a, b in pairs))


class nothing:
    """A context that does nothing."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class no_tf32:
    """f32 products and convolutions in f32 (TF32 off) while entered."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved
        return False
