#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``awsegbench_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit: ``python3 chip_smoke.py``. It needs no network and no weights (the
model is the port's seeded init) and fails, printing no result, when no
card is present or the port's package is not beside it.

Phases, each printing one JSON line:

1. device: the card's name and power limit; every kernel in
   ``awsegbench_torch/csrc`` is built with nvcc (in parallel) and timed.
2. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the eval path's shapes, in f32 and bf16 (K3 has no bf16
   mode and must match bit for bit, at the path's shape and at the ragged
   ``SPLAT_RAGGED`` cases, where K4 and K5 must match too; K1's bf16
   output must also lie within 2^-7·Σ p|v| of f32 math on its inputs),
   plus K1 and K2 at a few ragged shapes off the path, and K11 (the
   multi-scale deformable sampling of Mask2Former's pixel decoder) in f32
   and bf16 at ragged shapes and in bf16 at the Mask2Former sweep cell's
   shape (1024×2048, batch 4: 43,008 queries, 8 heads of 32, 3 levels,
   4 points; f32 to a few ulps, bf16 within one bf16 step, and faster
   than its plain version), and K12 (eval BN with its residual add and
   ReLU in one pass) in f32 and bf16 at ragged shapes in both layouts and
   in bf16 at Mask2Former-R50's stem (channels-last [4, 64, 512, 1024])
   and at a layer-1 block's last BN with its residual ([4, 256, 256,
   512]), where it must beat its plain version, the old composition; and
   K15 (Swin's shifted-window attention with its relative position bias)
   in f32 and bf16 at ragged shapes (``K15_RAGGED``) and at the Swin-L
   cell's stage-1 and stage-3 launches (1024×2048, batch 4: padded maps
   264×516 with 6 heads and 72×132 with 24, shifted by 6), timed there
   beside its plain version, the published composition in bf16 (which it
   must beat), SDPA's memory-efficient kernel on the materialised bias and
   mask, and its bound (``portbench/counts/swin.py``);
   median times of the
   kernel, the plain version and, for attention,
   ``F.scaled_dot_product_attention``, for K12 the library's eval
   ``F.batch_norm`` with an in-place add and ReLU (yardsticks only; the
   port calls neither). K1 and K6 also get the exponential floor
   (``exp_bound_ms``: one ex2 per score on the special-function unit) and
   device times by the profiler, theirs and SDPA's (``device_ms``,
   ``library_device_ms``: ``ms`` less the host's time to launch them);
   K3–K5 get the device time of every device op of one call.
3. main path: the faithful SegFormer-B0 + DeepLabV3+ (ResNet-50) ensemble
   eval step at 512×1024, bf16, batch 8, mixed weather 0–4: 2 warm-up and
   5 timed batches; images/s, and each kernel's launch count in that run
   (every count must be > 0, K12 exactly 66 a step, and K1's bf16 calls
   must have gone through its tensor-core design); the confusion-matrix total must equal the
   count of non-ignored pixels and the depth sum must be finite. The
   host cost of the custom ops (``ops/library.py``) the step calls K1 and
   K2 through: one step's nine calls through the ops against the bare
   launches (``op_dispatch``, µs per step, host clock).
   Then where a step's time goes: each layer (corruption, the two
   members, the confusion matrix) timed alone, and device time by kernel
   over one profiled step.
4. parity: at batch 1 in f32, the corruption and the ensemble forward on
   the card (through the kernels) against the same on the CPU (where every
   op takes its plain version): uint8 images within one step with
   99.9% exact, logits within 2e-3.
5. train kernels: K6 (the attention backward, through ``autograd.grad``
   of the op ``awseg::sr_attention``), K7 and K8 (the train seg head's
   core, K8 also through the op's gradient), K9 and K10 (the train depth head's
   stage-1 core, K10 likewise) against their plain versions on the card at
   the train path's shapes and at ragged shapes off it (every r class, odd
   h/w), timed beside their plain versions, their bounds and, for K6, the
   backward of ``F.scaled_dot_product_attention`` (a yardstick only); K6
   called twice on the same inputs must give bit-equal gradients (no float
   atomics). K7 also gets its hash floor, counted in the SASS of the
   library this run built (``scripts/seg_head_sass.py``); K8 and K10 the
   same floor and the bound of their tensor-core products. bf16 K9's d1 is
   ≥ 99.9% bit-equal to its plain version, the rest within one bf16 step.
   The bf16 backwards take the forwards' ReLU decisions, counted exactly
   (``relu_decisions``), and the scatter of dpp back to P
   (``neighbor_pp_adjoint``) is bit-equal to its plain version. K13 and
   K14 (train BN with its residual add and ReLU, and its gradient) against
   their plain versions in f64 at ragged shapes in both layouts and
   dtypes, and timed in bf16 at the ResNet-50's stem and the SegFormer
   depth head's BN at full resolution beside their bound, their plain
   versions and the library's train ``F.batch_norm`` then ``relu_`` (its
   backward by autograd; a yardstick only).
6. train path: ``TrainStep`` on bench.py's train configuration, the
   faithful ensemble with depth heads, at 512×1024, bf16 compute, batch 8,
   mixed weather 0–4, clip 1.0 and AdamW(1e-3, decay 1e-4): 2 warm-up and
   5 timed steps; images/s, peak memory, the launches of K1, K3, K6–K10,
   K13 and K14 in that run (each must be > 0, K1's and K6's through their
   tensor-core design, K13 and K14 exactly 65 a step); the losses (the depth loss included)
   must be finite, every parameter must move but those listed in
   ``STILL_BY_CONSTRUCTION`` with their reasons, and every BN running stat
   must move. Then each layer's forward+backward timed alone and device
   time by kernel over one profiled step.
7. train parity: one f32 step at 128×256, batch 2, with the same draws
   (made on the CPU) on the card (kernels) and on the CPU (plain versions):
   total and depth loss within 1e-4 relative, BN running stats within
   1e-4, the gradients of the SegFormer member and the ensemble's own
   parameters within rtol 2e-3 and 2e-3 of each leaf's largest value. The
   DeepLab member has only library convs; in f32 its gradients are
   ill-conditioned at batch 2 (tests/test_torch_train_step.py), so each of
   its leaves is held within 0.1 relative L2 error.
8. single image: ``apply_weather_effect`` for rain and snow at 512×1024
   (K4), 1024×2048 (Cityscapes' height and width) and 2048×1024 (K5),
   counted (K4 and K5 must launch); the uint8 images card vs CPU within one
   step and 99.9% exact; K4 and K5 against their plain version bit for
   bit, timed (events and device time) beside it and their bounds, K5 at
   both of its shapes.
9. evaluator: the robustness sweep (``Evaluator``) on the main path's
   model at 512×1024, batch 8, bf16, over 10 synthetic batches (weather
   ids ``(i + j) % 5``, random labels, the first rows ignored), in
   ``histogram`` mode (counted: K1–K3 must launch) and in ``exact`` mode:
   every result key present and finite, each weather's confusion matrix
   holding that weather's non-ignored pixels, the ECE bins and the AUROC
   histogram every one of them, the exact AUROC within 1e-3 of the
   histogram's; images/s, ms per batch and the metrics alone per batch.
   Then card against CPU: an f32 sweep of 2 batches of 5 at 128×256 with
   the same draws, confusion matrices within 0.1% of each weather's
   pixels and mIoU, ECE and AUROC within 2e-3 of the CPU's.
10. mask2former: the same sweep on Mask2Former-R50 (``type:
    mask2former``) as the benchmark's ``sweep-m2fr50-cityscapes`` cell
    runs it, 1024×2048, batch 4, bf16, over 6 batches: counted from zero
    (K11 exactly 6 launches a batch, one a pixel-decoder layer; K12
    exactly 53, one a BN of the ResNet-50; K3 must launch), the same count checks (no disagreement: the AUROC histogram
    stays empty and the result has no AUROC), images/s, ms per batch,
    peak memory and K11's device time in one batch. Then card against
    CPU in f32 from the same weights: the forward at 128×256, batch 2
    (semantic scores within 1e-4 relative L2, argmax 99.9% equal) and a
    sweep of 2 batches of 2 with the same draws, held as the evaluator
    phase holds the ensemble's.
10b. mask2former_swin: the same sweep on Mask2Former-Swin-L (``type:
    mask2former_swin``) as the ``sweep-m2fswinl-cityscapes`` cell runs
    it, 1024×2048, batch 4, bf16, over 3 batches: counted from zero (K15
    exactly 24 launches a batch, one a Swin block, all on the tensor
    cores; K11 6; K12 none; K3 must launch), the count checks, images/s,
    ms per batch, peak memory and K15's device time in one batch. Then
    card against CPU in f32 from the same weights: the forward at
    128×256, batch 1, and a sweep of 2 batches of 1, held as the R50's.
11. cli: the train CLI (``awsegbench_torch.cli.train.main``) in this
    process on ``configs/default.yaml`` with an empty data root (the
    synthetic 100 train and 20 val/test images), 512×1024, batch 8, one
    epoch, bf16: the default config's full-width ensemble with depth heads
    and faithful heads. Counted: K1, K3, K6–K10 and the scatter must
    launch (K1 and K6 through their tensor-core design);
    ``training_results.json`` must hold one epoch of finite losses over 96
    train samples (12 steps, ``drop_last``) and 20 val samples, and
    ``checkpoints/latest`` and ``best`` must exist. The latest checkpoint,
    loaded into a fresh model on the card, must equal the trainer's final
    state dict bit for bit, BN buffers included. Then the evaluate CLI on
    it (counted: K1–K3 must launch): ``evaluation_results.json`` with the
    overall and per-weather mIoU and ECE and the disagreement AUROC, all
    finite, and ``evaluation_report.md``. Times: the train epoch, its
    images/s, validation, the checkpoint saves and bytes, each CLI's
    wall time and the sweep's images/s, and the loader alone (one epoch
    of the train split onto the card), beside the card's name and power
    limit.
12. pretrained: synthetic state dicts (an HF MiT-B0 as ``.npz``, a
    torchvision ResNet-50 as ``.pt``, the same MiT as a hand-written
    ``.safetensors``; He-scaled weights, running variances near 1) in a
    temporary ``$AWSEG_WEIGHTS_DIR``, grafted through the trainer's path
    (``model.pretrained: true``) into the default ensemble on the card:
    every grafted leaf equal to its source bit for bit, every other leaf
    unmoved, ``apply_pretrained`` alone (from ``.npz`` or
    ``.safetensors``) the same. Then ``EvalStep`` in f32 at batch 8,
    512×1024, card against CPU (in calls of 2 there): logits within 2e-3,
    confusion matrices within 1e-4 of the pixels; in bf16 at batch 8
    over 7 mixed-weather batches, counted (K1–K3 must launch) and timed;
    and a truncated ``resnet50.npz`` must leave DeepLab at random init
    with a warning while MiT is grafted. Files' bytes, load + graft
    seconds, eval images/s.
13. remat: ``TrainStep`` on the train path's configuration with remat off
    and then on, from the same weights: one step on the same batch and
    draws, counted (K1 8 launches with remat off, 16 with it on), its
    gradients held against each other at the train parity phase's
    tolerances and its updated parameters within 2·lr; then, per setting,
    5 timed steps (step ms, peak memory after
    ``reset_peak_memory_stats``) and one profiled step (device busy ms).
14. weather_extras: on the card against the CPU, ``fog_density_map`` at
    1024×2048 (within 1e-5, the same synthetic depth), ``estimate_depth``
    (1e-5), a label map's ``resize_nearest`` (bit for bit), and
    ``WeatherAugmentationPipeline`` for each weather at 512×1024 and
    1024×2048, counted (K4 and K5 must launch), its output against the
    CPU's from the same draws (uint8 within 2 steps, 99.9% exact); max
    |Δ| and times.
15. serving: ``awsegbench_torch.serving`` with the main path's model. A
    batch-polymorphic bf16 artifact at 512×1024 exported on the card
    (``torch.export``; K1 and K2 are the custom ops ``awseg::sr_attention``
    and ``awseg::seg_core``), saved and loaded back by
    ``ServingModel.load``: one batch-1 request counted (K1 8 launches, K2
    1, K3 none, K12 66), its batch-8 outputs against the in-process
    ``build_serving_fn`` forward (within one bf16 step of the logits'
    scale; 0 expected), a wrong shape and a wrong dtype refused; images/s
    at batch 8 and p50/p90 latency at batch 1 (host clock, synchronised),
    the same for the in-process forward, one profiled batch-8 request. A
    batch-1 artifact at 1024×2048 and its latency. An f32 artifact exported
    on the card for ('cuda', 'cpu') against itself loaded on the CPU
    (within 2e-3), and an f32 artifact exported on the CPU, moved to the
    card at load: counted (K1 8, K2 1, both ``simt_f32``) and equal to the
    card-exported one. Export and load seconds and artifact MB.
16. parallel: the data mesh and spatial tiling. The main path's ensemble
    at 1024×2048 in 512×1024 tiles with a 128-pixel halo against its
    monolithic forward (f32 within rtol 2e-4 and atol 2e-5, argmax
    equal; bf16 argmax against f32 no more than 0.1% below the
    monolithic bf16's; a tiled forward counted: K1 8, K2 1, K12 66; ms
    and peak memory of both), the ``Evaluator`` with ``spatial_tiling='on'``
    against the monolithic sweep (mIoU and ECE within 1e-4, counted), and
    two ranks on the one card over gloo: ``TrainStep`` at 512×1024 with a
    global batch of 8 split 4 + 4 against one process (bf16, counted and
    timed, and f32; ``phase_parallel`` states the tolerances), and the
    tiled forward with its tiles split 2 + 2 against one rank's.
17. tensor_parallel: the mesh's model axis (``parallel/tensor.py``) with
    gloo ranks sharing the card. On ``{data: 1, model: 2}`` the main
    path's ensemble at full width sharded at ``tp_min_features`` 64: the
    eval forward at 512×1024, batch 8, against one process (f32 within
    rtol 2e-4 and atol 2e-5, argmax equal; bf16 against bf16's own error;
    counted: K1 8, K2 1, K12 66 a rank); ``TrainStep`` on the train cell in bf16
    (batch 8, counted: K1 8, K3 1, K6 8, K7–K10 1 each, the scatter 2,
    K13 and K14 65 each a rank) and f32 (batch 4) against one process (``phase_tensor_parallel``
    states the tolerances); each rank's bytes of parameters, gradients
    and AdamW moments (at most 0.51 of one process's), peak memory, the
    model axis's collectives by kind and the convolutions' and matmuls'
    device time. On ``{data: 2, model: 2}`` (four ranks) one f32 step at
    128×256, batch 4, against one process.

TF32 is switched off for matmuls and cuDNN convs throughout, so the f32
comparisons compare f32 arithmetic. Before the last line it prints the
``{"kernels": [...]}`` summary of all sixteen kernels (the ten TPU
kernels' counterparts, the scatter, K11, K12, K13, K14 and K15; each kernel's
``launches`` from the path it serves: K1–K3 and K12 from the eval path,
K6–K10, the scatter, K13 and K14 from the train path, K4 and K5 from the
single-image path, K11 from the Mask2Former sweep, K15 from the Swin
one, which alone launches it, every path's counts (the evaluator's, the
two Mask2Former sweeps', the two CLIs', the pretrained eval's, the remat steps',
the augmentation pipeline's, one serving request's, the parallel
phase's tiled forward, tiled sweep and each rank's step, and the
tensor_parallel phase's eval forward and train step on each rank too) under
``launches_by_path``; the
kernels with two designs add their ``design`` per dtype and their
per-design counts per path) and the card's ``nvidia-smi`` name and power
limit; the last line
is ``{"ok": true, "device": {...}}``. Any failed check raises, and the
script exits non-zero.
"""

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H, W, B = 512, 1024, 8
BF16_PEAK, F32_PEAK, HBM_BW = 989e12, 67e12, 3.35e12   # H100 SXM data sheet
# ex2 per second on the special-function unit: 16 per SM per clock, 132 SMs,
# 1.83 GHz boost clock
EX2_RATE = 3.9e12
MODEL_CFG = {'type': 'ensemble', 'num_classes': 19, 'include_depth': True,
             'head_mode': 'faithful'}
TRAIN_CFG = MODEL_CFG             # bench.py:337's train configuration
# Mask2Former-R50 as the sweep cell runs it: 1024×2048, batch 4; its
# deformable attention's levels (res5, res4, res3: H, W pairs)
M2F_CFG = {'type': 'mask2former', 'num_classes': 19}
M2F_H, M2F_W, M2F_B = 1024, 2048, 4
M2F_LEVELS = (32, 64, 64, 128, 128, 256)
# Mask2Former-Swin-L as the sweep cell sweep-m2fswinl-cityscapes runs it
# (the same sizes and batch); K15 launches a forward, one a Swin block
M2F_SWIN_CFG = {'type': 'mask2former_swin', 'num_classes': 19}
M2F_SWIN_BLOCKS = 24
# Parameters that a train step leaves where they were, each with its reason.
STILL_BY_CONSTRUCTION = {
    'segformer.SegmentationHead_0.Conv_0.bias':
        'the fused seg head adds conv1\'s bias only to BN\'s batch mean, '
        'which the normalisation subtracts: its gradient is zero by '
        'construction, it starts at zero, and the decay keeps it there',
    'segformer.DepthEstimationHead_0.Conv_0.bias':
        'the fused depth stage 1 adds conv1\'s bias only to BN1\'s batch '
        'mean, as the seg head does: zero gradient, zero start, zero decay',
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def device_ms(fn, names, reps: int = 5) -> float:
    """Device time of one call of ``fn`` in ms, by torch.profiler: the
    kernels whose names hold one of ``names``, over ``reps`` calls after a
    warm-up. Unlike ``time_ms`` it leaves out the host's time to launch
    them. The profile can miss a launch's record (one of five K7 launches
    in some runs), so each kernel name's mean over the records it has is
    scaled by the launches of that name a call makes, and the names are
    summed (a long kernel and its short reduce are not averaged together)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # A profile now and then comes back with no device records at all (seen
    # on SDPA's forward between K6's profiles): profiled again, up to three
    # times, before it counts as a failure.
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us: dict[str, list] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and any(name in e.name
                                                        for name in names):
                us.setdefault(e.name, []).append(e.time_range.elapsed_us())
        if us:
            return sum(sum(v) / len(v) * max(1, round(len(v) / reps))
                       for v in us.values()) / 1e3
    raise AssertionError(f'no kernel named like {names} in three profiles')


def bound(flops: float, nbytes: float, peak: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / peak, nbytes / HBM_BW
    return max(t_ops, t_bytes) * 1e3, ('operations' if t_ops >= t_bytes
                                       else 'bytes')


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def check_close(name, got, want, tol, atol=None):
    import torch
    atol = tol if atol is None else atol
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=atol):
        raise AssertionError(f'{name}: kernel and plain version differ, max '
                             f'abs err {max_err(got, want)} (rtol {tol}, '
                             f'atol {atol})')


def bf16_step(x):
    """One bf16 step (unit in the last place) of each value; 0 at 0."""
    import torch
    _, e = torch.frexp(x.float())
    return torch.where(x == 0, 0.0,
                       torch.ldexp(torch.ones_like(x.float()), e - 8))


def check_scaled(name, got, want, tol):
    """|got − want| ≤ tol · max|want| (for gradients, whose scale the
    shapes set)."""
    scale = want.float().abs().max().item()
    err = max_err(got, want)
    if not err <= tol * scale:
        raise AssertionError(f'{name}: kernel and plain version differ, max '
                             f'abs err {err} > {tol} × scale {scale}')
    return err / scale if scale else 0.0


# The seg-head forward kernels (K2, K7) against their plain versions: f32
# within 1e-4; bf16 within 6e-2 (the plain versions round as the kernels,
# and the sums run in another order: a hidden value on a rounding boundary
# may flip by one bf16 step). Off the path's shapes: ragged h/w, every r
# class (4, 8, 32) and the class counts 5 and 7 (one and two n-tiles).
SEG_TOLS = {'float32': 1e-4, 'bfloat16': 6e-2}
SEG_RAGGED = (((1, 3, 5, 9, 32), 32, 5), ((2, 3, 5, 9, 48), 8, 7),
              ((1, 5, 3, 9, 16), 4, 19), ((2, 2, 3, 9, 32), 32, 7))
# The seg-head forward designs by the dtype they take (ops/headkernels.py).
SEG_DESIGNS = {'bfloat16': 'mma_bf16', 'float32': 'simt_f32'}


def hash_floor(elements: int) -> tuple[float, dict]:
    """K7's hash floor in ms for ``elements`` hidden elements, from the
    library this run built: the counter hash's integer instructions per
    element on the busier of the two integer pipes (IMAD on the FMA pipe,
    the rest on the ALU pipe; scripts/seg_head_sass.py counts them in the
    SASS), at 64 lanes per SM per clock, the card's SMs and its boost clock
    (``nvidia-smi clocks.max.sm``). Returns it with the per-pipe counts,
    the SMs and the clock."""
    import importlib.util
    import torch
    from awsegbench_torch import _build
    spec = importlib.util.spec_from_file_location(
        'seg_head_sass', ROOT / 'scripts' / 'seg_head_sass.py')
    sass = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sass)
    counts = sass.hash_counts(_build._build('seg_head_train'))
    mhz = float(subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.max.sm',
         '--format=csv,noheader,nounits'], capture_output=True, text=True,
        check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rate = sass.INT_LANES_PER_SM_CLOCK * sms * mhz * 1e6
    print(f'--- K7 dropout SASS ---\n{json.dumps(counts)}', file=sys.stderr)
    per_pipe = counts['int_ops_per_element']
    return (elements * max(per_pipe.values()) / rate * 1e3,
            dict(per_pipe, sms=sms, boost_mhz=mhz))


def seg_core_inputs(randn, shape, nc, dt):
    """P [b, h, w, 9, C] and wp [C, nc] in ``dt``; a1, c1, bp in f32."""
    cc = shape[-1]
    return ((randn(*shape) * 0.5).to(dt), 1.0 + 0.1 * randn(cc),
            0.1 * randn(cc), (randn(cc, nc) / 16).to(dt), 0.1 * randn(nc))


def check_nc_limit(fn, randn, *extra):
    """The seg-head wrapper ``fn`` raises, before any launch, for a CUDA
    tensor with one class more than the kernels take (``NC_MAX``)."""
    import torch
    from awsegbench_torch.ops.headkernels import NC_MAX
    args = seg_core_inputs(randn, (1, 2, 2, 9, 16), NC_MAX + 1,
                           torch.bfloat16)
    try:
        fn(*args, *extra)
    except ValueError as e:
        if f'1 to {NC_MAX} classes' in str(e):
            return
        raise
    raise AssertionError(f'{fn.__name__} took {NC_MAX + 1} classes')


def seg_bounds(b, h, w, c, nc, r):
    """(bound ms, what bounds it, the kron design's operation bound ms) of
    the seg-head forward at P [b, h, w, 9, C] → [b, h·r, w·r, nc] in bf16:
    the factorised passes' operations or the bytes (P and wp read, the
    logits written), and the kron GEMM with K = 96 and 8·⌈nc/8⌉ classes."""
    pix = b * h * r * w * r
    flops = pix * (2 * 9 * 9 * c / r + 2 * 9 * c + 2 * c * nc)
    nbytes = b * h * w * 9 * c * 2 + c * nc * 2 + pix * nc * 2
    kron = pix * 2 * (96 * c + c * 8 * -(-nc // 8))
    return (*bound(flops, nbytes, BF16_PEAK), kron / BF16_PEAK * 1e3)


RADII = (0.5, 1.5, 1.0, 4.0)        # rain streaks' and snow flakes' radii
# (images, H, W, drop slots, valid share, integer coordinates) of the splat
# checks off the paths' shapes: ragged sizes, 1×W and H×1, one and three
# images, no slot, no valid slot, more slots than one cull round (512)
SPLAT_RAGGED = ((3, 37, 101, 40, 0.7, True), (1, 37, 101, 40, 0.7, False),
                (1, 1, 300, 20, 1.0, True), (3, 300, 1, 20, 1.0, False),
                (3, 64, 256, 0, 1.0, True), (2, 64, 256, 16, 0.0, True),
                (3, 200, 700, 600, 0.8, True))


def splat_mixed_batch(dev, g):
    """K3's params at the eval path's shape: 8 images at 512×1024, rain
    and snow alternating, with full drop counts (500 rain drops, 200 of
    the 500 snow slots valid)."""
    import torch
    from awsegbench_torch.ops import splat
    from awsegbench_torch.weather.corruption import draw_corruption

    wid = torch.tensor([2, 3] * (B // 2), device=dev)
    dr = draw_corruption(wid, H, W, g)
    rain = (wid == 2)[:, None]
    return splat.pack_params(
        torch.where(rain, dr['rain_ax'], dr['snow_x']),
        torch.where(rain, dr['rain_ay'], dr['snow_y']),
        torch.where(rain, dr['rain_bx'], dr['snow_x']),
        torch.where(rain, dr['rain_by'], dr['snow_y']),
        torch.where(rain, dr['rain_radius'], dr['snow_radius']),
        torch.where(rain, True, torch.arange(500, device=dev)[None] < 200))


def check_splat(name, got, want, covered=True):
    import torch
    torch.cuda.synchronize()
    if not torch.equal(got, want) or (covered and not got.any()):
        raise AssertionError(f'{name}: masks differ in '
                             f'{int((got != want).sum())} pixels')


def splat_bound(params, h, w) -> dict:
    """The splat kernels' bound: the mask written once and the params read
    once, against 20 flops per hit test the data needs (each valid drop's
    inflated box, clipped to the image)."""
    from awsegbench_torch.ops import splat
    x0, x1, y0, y1 = splat.drop_boxes(params).unbind(-1)
    area = ((x1.clamp(max=w - 1) - x0.clamp(min=0) + 1).clamp(min=0)
            * (y1.clamp(max=h - 1) - y0.clamp(min=0) + 1).clamp(min=0))
    n_tests = float((area * (params[..., 5] > 0)).sum())
    images = params.shape[0] if params.ndim == 3 else 1
    ms, by = bound(20 * n_tests, images * h * w * 4 + params.numel() * 4,
                   F32_PEAK)
    return {'bound_ms': ms, 'bound_by': by}


def splat_ragged(dev, g) -> int:
    """K3 (batched), K4 (each image alone) and K5 against the plain mask,
    bit for bit, at ``SPLAT_RAGGED``: drops anywhere within 5 px of the
    image (so boxes cross tile and image borders), 30% zero-length, the
    four production radii. Returns the number of cases."""
    import torch
    from awsegbench_torch.ops import splat
    for b, h, w, n, share, integer in SPLAT_RAGGED:
        def u(lo, hi):
            v = lo + (hi - lo) * torch.rand((b, n), generator=g, device=dev)
            return v.round() if integer else v
        ax, ay = u(-5, w + 5), u(-5, h + 5)
        circle = torch.rand((b, n), generator=g, device=dev) < 0.3
        bx = torch.where(circle, ax, ax + u(-20, 20))
        by = torch.where(circle, ay, ay + u(-20, 20))
        r = torch.tensor(RADII, device=dev)[
            torch.randint(0, 4, (b, n), generator=g, device=dev)]
        valid = torch.rand((b, n), generator=g, device=dev) < share
        params = splat.pack_params(ax, ay, bx, by, r, valid)
        want = splat.splat_coverage_plain(params, h, w)
        what = f'{b}x{h}x{w}, {n} slots'
        check_splat(f'splat_coverage_batched {what}',
                    splat.splat_coverage_batched(params, h, w), want, False)
        for i in range(b):
            for fn in (splat.splat_coverage_windowed,
                       splat.splat_coverage_tiled):
                check_splat(f'{fn.__name__} {what}', fn(params[i], h, w),
                            want[i], False)
    return len(SPLAT_RAGGED)


def phase_kernels(dev):
    """K1–K3, K11, K12 and K15 against their plain versions; returns the
    kernels' records."""
    import torch
    import torch.nn.functional as F
    from awsegbench_torch.ops import attention, splat

    g = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    recs = {}

    # K1: the four MiT-B0 stage shapes (heads 1/2/5/8 at strides 4–32, K/V
    # reduced to H·W/1024 tokens by the sr ratios 8/4/2/1), two blocks each
    stages = [(B * heads, (H >> (i + 2)) * (W >> (i + 2)))
              for i, heads in enumerate((1, 2, 5, 8))]
    m, d = H * W // 1024, 32
    # rtol, atol as tests/test_attention.py holds the TPU kernel
    k1_tols = {torch.float32: (1e-5, 1e-6), torch.bfloat16: (3e-2, 3e-2)}

    def check_k1(gg, n, mm, dd):
        """K1 against its plain version at one shape, f32 and bf16; returns
        the max abs errors."""
        q32, k32, v32 = randn(gg, n, dd), randn(gg, mm, dd), randn(gg, mm, dd)
        errs = {}
        for dt, (rtol, atol) in k1_tols.items():
            q, k, v = (t.to(dt) for t in (q32, k32, v32))
            got = attention.sr_attention(q, k, v, dd ** -0.5)
            want = attention.sr_attention_plain(q, k, v, dd ** -0.5)
            check_close(f'sr_attention {dt} {gg}x{n}x{mm}x{dd}', got, want,
                        rtol, atol)
            errs[dt] = max_err(got, want)
        # Against f32 math on the same bf16 inputs. The kernel rounds P to
        # bf16 before the AV product, as the TPU kernel does, so each term
        # p_j·v_j may move by 2^-9 of itself and the output by up to
        # 2^-9·Σ_j p_j|v_j| (plus the bf16 store's half step). An output
        # near zero is a sum of cancelling terms, so an elementwise 2^-7 of
        # the output is no limit there; checked at 2^-7·Σ_j p_j|v_j| + 1e-5.
        q, k, v = q.float(), k.float(), v.float()
        want = attention.sr_attention_plain(q, k, v, dd ** -0.5)
        room = attention.sr_attention_plain(q, k, v.abs(), dd ** -0.5)
        err = (got.float() - want).abs()
        if not bool((err <= 2 ** -7 * room + 1e-5).all()):
            raise AssertionError(
                f'sr_attention bf16 vs f32 math {gg}x{n}x{mm}x{dd}: max '
                f'excess {(err - 2 ** -7 * room).max().item()}')
        return q32, k32, v32, errs

    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    ms = plain_ms = lib_ms = bound_ms = dev_ms = lib_dev_ms = 0.0
    flops_all = bytes_all = scores = 0.0
    for gg, n in stages:
        q32, k32, v32, e = check_k1(gg, n, m, d)
        errs = {dt: max(errs[dt], e[dt]) for dt in errs}
        q, k, v = (t.bfloat16() for t in (q32, k32, v32))
        ms += 2 * time_ms(lambda: attention.sr_attention(q, k, v, d ** -0.5))
        dev_ms += 2 * device_ms(
            lambda: attention.sr_attention(q, k, v, d ** -0.5),
            ('sr_attention_mma',))
        plain_ms += 2 * time_ms(
            lambda: attention.sr_attention_plain(q, k, v, d ** -0.5), reps=5)
        q4, k4, v4 = q[None], k[None], v[None]
        lib_ms += 2 * time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, scale=d ** -0.5))
        lib_dev_ms += 2 * device_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, scale=d ** -0.5), ('',))
        flops, nbytes = 4.0 * gg * n * m * d, 2.0 * (2 * gg * n * d + 2 * gg * m * d)
        bound_ms += 2 * bound(flops, nbytes, BF16_PEAK)[0]
        flops_all += 2 * flops
        bytes_all += 2 * nbytes
        scores += 2.0 * gg * n * m
    recs['sr_attention'] = dict(
        name='sr_attention', route='cuda',
        source='awsegbench_torch/csrc/sr_attention.cu',
        replaces='awsegbench/ops/attention.py:36',
        max_abs_err=errs[torch.bfloat16], ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound(flops_all, bytes_all, BF16_PEAK)[1],
        library_ms=lib_ms, max_abs_err_f32=errs[torch.float32],
        design=ATTENTION_DESIGNS, device_ms=dev_ms,
        library_device_ms=lib_dev_ms,
        exp_bound_ms=scores / EX2_RATE * 1e3, scores=scores)

    # K1 off the main path's shapes: ragged q, K/V tiles and key chunks,
    # and head_dim 64 (MiT-b1..b5)
    for shape in ((3, 130, 70, 64), (2, 100, 33, 32)):
        check_k1(*shape)

    recs['seg_core'] = seg_head_kernel(dev, g)

    # K3: 8 mixed rain/snow images at 512×1024 with full drop counts
    params = splat_mixed_batch(dev, g)
    got = splat.splat_coverage_batched(params, H, W)
    check_splat('splat_coverage_batched', got,
                splat.splat_coverage_plain(params, H, W))
    recs['splat_coverage_batched'] = dict(
        name='splat_coverage_batched', route='cuda',
        source='awsegbench_torch/csrc/splat.cu',
        replaces='awsegbench/ops/splat.py:216', max_abs_err=0.0,
        ms=time_ms(lambda: splat.splat_coverage_batched(params, H, W)),
        device_ms=device_ms(
            lambda: splat.splat_coverage_batched(params, H, W), ('',)),
        plain_ms=time_ms(lambda: splat.splat_coverage_plain(params, H, W),
                         reps=3, warmup=1),
        **splat_bound(params, H, W), library_ms=None,
        covered=float(got.mean()), ragged_cases=splat_ragged(dev, g))

    recs['ms_deform_attn'] = deform_kernel(dev, g)
    recs['bn_act'] = bn_act_kernel(dev, g)
    recs['window_attention'] = window_kernel(dev, g)
    return recs


def seg_head_kernel(dev, g):
    """K2, the seg head core at f [b, H/32, W/32, 256] → [b, H, W, 19], in
    both designs against its plain version, at the path's shapes and at
    SEG_RAGGED (SEG_TOLS); returns its record."""
    import torch
    from awsegbench_torch.ops import headkernels

    randn = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    h, w, c, nc, r = H // 32, W // 32, 256, 19, 32
    errs = dict.fromkeys(SEG_TOLS, 0.0)
    for name, tol in SEG_TOLS.items():
        dt = getattr(torch, name)
        for shape, rr, ncc in (((2, h, w, 9, c), r, nc),) + SEG_RAGGED:
            args = seg_core_inputs(randn, shape, ncc, dt)
            got = headkernels.seg_core(*args, rr)
            want = headkernels.seg_core_plain(*args, rr)
            torch.cuda.synchronize()
            if got.shape != (shape[0], shape[1] * rr, shape[2] * rr, ncc):
                raise AssertionError(f'seg_core shape {tuple(got.shape)}')
            check_close(f'seg_core {name} {shape} r{rr} nc{ncc}', got, want,
                        tol)
            errs[name] = max(errs[name], max_err(got, want))
    check_nc_limit(headkernels.seg_core, randn, r)
    args = seg_core_inputs(randn, (B, h, w, 9, c), nc, torch.bfloat16)
    check_close('seg_core bf16 b8', headkernels.seg_core(*args, r),
                headkernels.seg_core_plain(*args, r), SEG_TOLS['bfloat16'])
    bms, by, kron_ms = seg_bounds(B, h, w, c, nc, r)
    rec = dict(
        name='seg_core', route='cuda', source='awsegbench_torch/csrc/seg_head.cu',
        replaces='awsegbench/ops/headkernels.py:156',
        max_abs_err=errs['bfloat16'],
        ms=time_ms(lambda: headkernels.seg_core(*args, r)),
        plain_ms=time_ms(lambda: headkernels.seg_core_plain(*args, r), reps=3,
                         warmup=1),
        bound_ms=bms, bound_by=by, library_ms=None,
        max_abs_err_f32=errs['float32'], design=SEG_DESIGNS,
        device_ms=device_ms(lambda: headkernels.seg_core(*args, r),
                            ('seg_head_mma',)),
        kron_bound_ms=kron_ms)
    del args
    torch.cuda.empty_cache()
    return rec


# K11's tolerances, as its card test holds it
# (tests/test_torch_ms_deform_attn_card.py): f32 to a few ulps of the plain
# version (the two sum 4·L·P products in other orders), bf16 within one
# bf16 step (each side rounds its f32 sum once). Off the cell's shape: odd
# maps, 1 to 4 levels, 2 to 8 heads of 8 to 32 channels, 2 to 4 points.
K11_TOLS = {'float32': (1e-5, 2e-5), 'bfloat16': (2 ** -7, 2e-5)}
K11_RAGGED = (((3, 5, 7, 2), 2, 8, 3), ((1, 1, 4, 6, 2, 9), 8, 32, 4),
              ((5, 3, 8, 8, 2, 2, 1, 1), 4, 16, 2))


def deform_operands(g, b, shapes, m, d, points, dtype):
    """K11's operands over every level's pixels as queries: values, f32
    locations (a query's reference point plus offsets of up to 5 pixels of
    each level, about 1 in 8 of them past the map's edge, some exactly on
    an edge) and f32 weights softmaxed over the levels and points."""
    import torch
    from awsegbench_torch.ops import ms_deform_attn as msda
    dev = g.device
    sizes = msda.level_sizes(shapes)
    lq = s = sum(h * w for h, w in sizes)
    value = torch.randn(b, s, m, d, generator=g, device=dev).to(dtype)
    ref = torch.rand(b, lq, 1, 1, 1, 2, generator=g, device=dev)
    wh = torch.tensor([[w, h] for h, w in sizes], dtype=torch.float32,
                      device=dev).view(1, 1, 1, len(sizes), 1, 2)
    off = (torch.rand(b, lq, m, len(sizes), points, 2, generator=g,
                      device=dev) - 0.5) * 10.0
    loc = ref + off / wh
    loc[:, ::7, :, :, 0, 0] = 0.0                  # on the left edge
    loc[:, ::11, :, :, -1, 1] = 1.0                # on the bottom edge
    attn = torch.softmax(torch.randn(b, lq, m, len(sizes) * points,
                                     generator=g, device=dev), -1)
    return value, loc, attn.view(b, lq, m, len(sizes), points)


def deform_kernel(dev, g):
    """K11 against its plain version (``ms_deform_attn_plain``, F.grid_sample
    per level) in f32 and bf16 at ``K11_RAGGED`` and, in bf16, at the
    Mask2Former cell's shape (``M2F_LEVELS``, batch ``M2F_B``, 8 heads of
    32, 4 points), where it is timed beside the plain version and its
    bound (``portbench/counts/mask2former.py``); returns its record."""
    import torch
    from awsegbench_torch.ops import ms_deform_attn as msda
    from portbench.counts.mask2former import k11_counts

    errs = dict.fromkeys(K11_TOLS, 0.0)
    for name, (rtol, atol) in K11_TOLS.items():
        dt = getattr(torch, name)
        for shapes, m, d, points in K11_RAGGED:
            args = deform_operands(g, 2, shapes, m, d, points, dt)
            got = msda.ms_deform_attn(args[0], shapes, *args[1:])
            want = msda.ms_deform_attn_plain(args[0], shapes, *args[1:])
            check_close(f'ms_deform_attn {name} {shapes} m{m} d{d} '
                        f'p{points}', got, want, rtol, atol)
            errs[name] = max(errs[name], max_err(got, want))
    m, d, points = 8, 32, 4
    value, loc, attn = deform_operands(g, M2F_B, M2F_LEVELS, m, d, points,
                                       torch.bfloat16)
    lq = value.shape[1]

    def k11():
        return msda.ms_deform_attn(value, M2F_LEVELS, loc, attn)

    def plain():
        return msda.ms_deform_attn_plain(value, M2F_LEVELS, loc, attn)

    got, want = k11(), plain()
    check_close('ms_deform_attn bfloat16 at the cell', got, want,
                *K11_TOLS['bfloat16'])
    cell_err = max_err(got, want)
    del got, want
    flops, nbytes = k11_counts(M2F_B, lq, lq, m, d, len(M2F_LEVELS) // 2,
                               points)
    bms, by = bound(flops, nbytes, F32_PEAK)
    rec = dict(
        name='ms_deform_attn', route='cuda',
        source='awsegbench_torch/csrc/ms_deform_attn.cu', replaces=None,
        max_abs_err=max(errs['bfloat16'], cell_err), ms=time_ms(k11),
        plain_ms=time_ms(plain, reps=5, warmup=1), bound_ms=bms, bound_by=by,
        library_ms=None, max_abs_err_f32=errs['float32'],
        device_ms=device_ms(k11, ('ms_deform_attn',)),
        ragged_cases=len(K11_RAGGED))
    if not rec['ms'] < rec['plain_ms']:
        raise AssertionError(f'ms_deform_attn: {rec["ms"]} ms, not below '
                             f'the plain version\'s {rec["plain_ms"]} ms')
    del value, loc, attn
    torch.cuda.empty_cache()
    return rec


# K15 against its plain version (the published composition in f32): f32
# within a few ulps (the sums run in other orders), bf16 within 2^-7 and
# 8e-3 (the kernel rounds its probabilities to bf16 for the product, 2^-9
# of each term; both round the output once). Cases off the cell
# (b, hp, wp, heads, window, shift): a window of 7 (the last row tile
# ragged), blocks of 3 heads and of 1, one window a side, a window of 5.
K15_TOLS = {'float32': (1e-5, 1e-5), 'bfloat16': (2 ** -7, 8e-3)}
K15_RAGGED = ((2, 14, 21, 3, 7, 3), (1, 7, 7, 5, 7, 0), (2, 24, 36, 2, 12, 6),
              (1, 12, 24, 1, 12, 0), (3, 10, 15, 4, 5, 2))


def k15_stages():
    """The cell's stage-1 and stage-3 launches (b, hp, wp, heads), from
    ``portbench/counts/swin.py``: the padded maps of a 1024×2048 image."""
    import json
    from portbench.counts.swin import k15_launches
    config = json.loads((ROOT / 'portbench' / 'configs'
                         / 'mask2former-swin-l.json').read_text())
    launches = k15_launches(config, M2F_B, M2F_H, M2F_W)
    return [launches[0][:4], launches[4][:4]]


def window_sdpa(qkv, table, heads, window, shift, scale, bias):
    """The published composition with SDPA's memory-efficient kernel in
    place of the scores, the softmax and the product, ``bias`` the table's
    gather plus the shift mask materialised, [B·nW, heads, N, N] (a
    yardstick: the port never calls it)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from awsegbench_torch.ops import window_attention as wa
    b, hp, wp, c3 = qkv.shape
    c, n = c3 // 3, window * window
    x = torch.roll(qkv, (-shift, -shift), (1, 2)) if shift else qkv
    x = wa.partition(x, window).reshape(-1, n, 3, heads, c // heads)
    q, k, v = x.permute(2, 0, 3, 1, 4).unbind(0)
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                             scale=scale)
    out = wa.unpartition(out.transpose(1, 2).reshape(-1, window, window, c),
                         window, hp, wp)
    return torch.roll(out, (shift, shift), (1, 2)) if shift else out


def window_kernel(dev, g):
    """K15 against its plain version in f32 and bf16 at ``K15_RAGGED`` and
    at the Mask2Former-Swin-L cell's stage-1 and stage-3 launches
    (``k15_stages``, shifted by 6), where it is timed (events and device
    time) beside the plain version, the published composition in bf16,
    SDPA's memory-efficient kernel on the materialised bias and mask
    (``library_ms``, with the partition and the rolls) and its bound
    (``portbench/counts/swin.py``), and must beat the published
    composition; returns its record."""
    import torch
    from awsegbench_torch.ops import window_attention as wa
    from portbench.counts.swin import k15_counts

    scale = 32 ** -0.5

    def operands(b, hp, wp, heads, window, dt):
        qkv = torch.randn(b, hp, wp, 3 * heads * 32, generator=g, device=dev)
        table = torch.randn((2 * window - 1) ** 2, heads, generator=g,
                            device=dev)
        return qkv.to(dt), table.to(dt)

    errs = dict.fromkeys(K15_TOLS, 0.0)
    for name, (rtol, atol) in K15_TOLS.items():
        dt = getattr(torch, name)
        for b, hp, wp, heads, window, shift in K15_RAGGED:
            qkv, table = operands(b, hp, wp, heads, window, dt)
            got = wa.window_attention(qkv, table, heads, window, shift, scale)
            want = wa.window_attention_plain(qkv, table, heads, window, shift,
                                             scale)
            check_close(f'window_attention {name} {b}x{hp}x{wp} h{heads} '
                        f'w{window} s{shift}', got, want, rtol, atol)
            errs[name] = max(errs[name], max_err(got, want))
    by_stage = []
    for b, hp, wp, heads in k15_stages():
        for name, (rtol, atol) in K15_TOLS.items():
            qkv, table = operands(b, hp, wp, heads, 12,
                                  getattr(torch, name))
            got = wa.window_attention(qkv, table, heads, 12, 6, scale)
            want = wa.window_attention_plain(qkv, table, heads, 12, 6, scale)
            check_close(f'window_attention {name} at the cell {hp}x{wp}',
                        got, want, rtol, atol)
            errs[name] = max(errs[name], max_err(got, want))
            del got
        want32 = want.float()           # the bf16 operands' plain output
        del want
        index = wa.relative_position_index(12).to(dev)
        bias = (table[index.view(-1)].view(144, 144, heads).permute(2, 0, 1)
                .unsqueeze(0) + wa.shift_mask(hp, wp, 12, 6).to(
                    dev, qkv.dtype).unsqueeze(1)).repeat(b, 1, 1, 1)

        def k15():
            return wa.window_attention(qkv, table, heads, 12, 6, scale)

        def published():
            return wa.window_attention_published(qkv, table, heads, 12, 6,
                                                 scale)

        # the yardstick computes the same function: bf16 scores and
        # probabilities put it within 1% (relative L2) of the plain version
        lib_rel = float((window_sdpa(qkv, table, heads, 12, 6, scale, bias)
                         .float() - want32).norm() / want32.norm())
        if not lib_rel <= 1e-2:
            raise AssertionError(f'window_attention SDPA yardstick at '
                                 f'{hp}x{wp}: relative L2 {lib_rel}')
        del want32
        flops, nbytes = k15_counts(b, hp, wp, heads, 12)
        bms, by = bound(flops, nbytes, BF16_PEAK)
        rec = dict(
            shape=[b, hp, wp, heads], ms=time_ms(k15),
            device_ms=device_ms(k15, ('window_attention',)),
            plain_ms=time_ms(lambda: wa.window_attention_plain(
                qkv, table, heads, 12, 6, scale), reps=5, warmup=1),
            published_ms=time_ms(published, reps=5, warmup=1),
            library_ms=time_ms(lambda: window_sdpa(qkv, table, heads, 12, 6,
                                                   scale, bias), reps=5,
                               warmup=1),
            library_rel=lib_rel, bound_ms=bms, bound_by=by)
        if not rec['ms'] < rec['published_ms']:
            raise AssertionError(f'window_attention at {hp}x{wp}: '
                                 f'{rec["ms"]} ms, not below the published '
                                 f'composition\'s {rec["published_ms"]} ms')
        by_stage.append(rec)
        del qkv, table, bias
        torch.cuda.empty_cache()
    total = {k: sum(r[k] for r in by_stage)
             for k in ('ms', 'device_ms', 'plain_ms', 'published_ms',
                       'library_ms', 'bound_ms')}
    return dict(
        name='window_attention', route='cuda',
        source='awsegbench_torch/csrc/window_attention.cu', replaces=None,
        max_abs_err=errs['bfloat16'], max_abs_err_f32=errs['float32'],
        bound_by=by_stage[0]['bound_by'], design=ATTENTION_DESIGNS,
        by_stage=by_stage, ragged_cases=len(K15_RAGGED), **total)


# K12's cases off the cells' shapes (shape, residual, ReLU), each in both
# layouts (channel-major takes the scalar kernel): a ragged C (the scalar
# kernel), 8 and 6 channel groups, 256 groups, a C above the vector path's,
# 1×1 maps.
K12_RAGGED = (((2, 20, 7, 9), True, True), ((2, 64, 5, 8), False, True),
              ((3, 48, 4, 4), True, False), ((1, 2048, 3, 5), True, True),
              ((2, 4096, 2, 2), False, False), ((2, 16, 1, 1), True, True))
K12_STEM = (M2F_B, 64, M2F_H // 2, M2F_W // 2)
# a layer-1 block's last BN, with its residual, at Mask2Former-R50's shape
K12_BLOCK = (M2F_B, 256, M2F_H // 4, M2F_W // 4)


def bn_act_operands(g, shape, dtype, lay, residual):
    """K12's operands: x (and the residual) in layout ``lay``; mean, var
    (positive), weight, bias."""
    import torch
    dev, c = g.device, shape[1]
    fmt = (torch.channels_last if lay == 'nhwc'
           else torch.contiguous_format)

    def randn(*s):
        return torch.randn(s, generator=g, device=dev)

    x = randn(*shape).to(dtype).contiguous(memory_format=fmt)
    res = (randn(*shape).to(dtype).contiguous(memory_format=fmt)
           if residual else None)
    var = torch.rand(c, generator=g, device=dev) + 0.1
    return (x, (randn(c) * 0.5).to(dtype), var.to(dtype), randn(c).to(dtype),
            (randn(c) * 0.5).to(dtype), res)


def bn_act_held(ops, relu) -> float:
    """K12 on ``ops`` against its plain version as its card test holds it
    (``tests/test_torch_bn_act_card.py``): f32 within 1e-6 of the terms'
    size |x − mean|·|mul| + |bias| + |residual|; bf16 equal to the plain
    version's function in f32 rounded once, or one bf16 step beside it.
    Returns the max abs difference from the plain version."""
    import torch
    from awsegbench_torch.ops import bn_act as bna
    x, mean, var, weight, bias, res = ops
    got = bna.bn_act(x, mean, var, weight, bias, 1e-5, res, relu)
    f = [None if t is None else t.float() for t in ops]
    want = bna.bn_act_plain(*f[:5], 1e-5, f[5], relu)
    shape = (1, -1, 1, 1)
    size = ((f[0] - f[1].view(shape)).abs()
            * (torch.rsqrt(f[2] + 1e-5) * f[3]).abs().view(shape)
            + f[4].abs().view(shape) + (0.0 if res is None else f[5].abs()))
    if x.dtype == torch.float32:
        room = 1e-6 * size
    else:
        room = bf16_step(want.bfloat16()) + 1e-6 * size
        want = want.bfloat16()
    err = (got.float() - want.float()).abs()
    if got.stride() != x.stride() or not bool((err <= room).all()):
        raise AssertionError(f'bn_act {x.dtype} {tuple(x.shape)} '
                             f'strides {x.stride()}: off by '
                             f'{float((err - room).max())} beyond its room')
    return max_err(got, bna.bn_act_plain(*ops[:5], 1e-5, res, relu))


def bn_act_kernel(dev, g):
    """K12 against its plain version (``bn_act_plain``, the composition the
    models ran before it) in f32 and bf16 at ``K12_RAGGED`` in both
    layouts and, in bf16 with the ReLU, at Mask2Former-R50's stem
    (``K12_STEM``, channels-last), where it is timed beside the plain
    version, its bound (x read once, y written once) and the library's
    eval BN (``F.batch_norm`` with f32 statistics, then an in-place ReLU);
    the same three again at a layer-1 block's last BN with its residual
    (``K12_BLOCK``; the library adds it in place before the ReLU). Returns
    its record."""
    import torch
    import torch.nn.functional as F
    from awsegbench_torch.ops import bn_act as bna

    errs = {'float32': 0.0, 'bfloat16': 0.0}
    for name in errs:
        for shape, residual, relu in K12_RAGGED:
            for lay in ('nhwc', 'nchw'):
                ops = bn_act_operands(g, shape, getattr(torch, name), lay,
                                      residual)
                errs[name] = max(errs[name], bn_act_held(ops, relu))

    def timed(shape, residual):
        ops = bn_act_operands(g, shape, torch.bfloat16, 'nhwc', residual)
        x, mean, var, weight, bias, res = ops
        err = bn_act_held(ops, True)
        stats = [t.float() for t in (mean, var, weight, bias)]

        def k12():
            return bna.bn_act(x, mean, var, weight, bias, 1e-5, res, True)

        def plain():
            return bna.bn_act_plain(x, mean, var, weight, bias, 1e-5, res,
                                    True)

        def library():
            y = F.batch_norm(x, stats[0], stats[1], stats[2], stats[3],
                             training=False, eps=1e-5)
            return (y if res is None else y.add_(res)).relu_()

        nbytes = (3.0 if residual else 2.0) * x.numel() * x.element_size()
        bms, by = bound(0.0, nbytes, BF16_PEAK)
        out = dict(shape=list(shape), residual=residual, max_abs_err=err,
                   ms=time_ms(k12), plain_ms=time_ms(plain),
                   library_ms=time_ms(library), bound_ms=bms, bound_by=by,
                   device_ms=device_ms(k12, ('bn_act',)),
                   library_max_abs_err=max_err(library(), plain()))
        del x, mean, var, weight, bias, res, ops
        torch.cuda.empty_cache()
        return out

    stem, block = timed(K12_STEM, False), timed(K12_BLOCK, True)
    rec = dict(
        name='bn_act', route='cuda', source='awsegbench_torch/csrc/bn_act.cu',
        replaces=None, max_abs_err=max(errs['bfloat16'], stem['max_abs_err'],
                                       block['max_abs_err']),
        ms=stem['ms'], plain_ms=stem['plain_ms'], bound_ms=stem['bound_ms'],
        bound_by=stem['bound_by'], library_ms=stem['library_ms'],
        max_abs_err_f32=errs['float32'], device_ms=stem['device_ms'],
        ragged_cases=2 * len(K12_RAGGED), stem=stem, block=block)
    for case in (stem, block):
        if not case['ms'] < case['plain_ms']:
            raise AssertionError(f'bn_act {case["shape"]}: {case["ms"]} ms, '
                                 f'not below the plain version\'s '
                                 f'{case["plain_ms"]} ms')
    return rec


def phase_main_path(dev):
    import torch
    from awsegbench_torch.eval.step import EvalStep
    from awsegbench_torch.models import count_parameters, create_model

    model = create_model(MODEL_CFG, device=dev, seed=0, dtype=torch.bfloat16)
    step = EvalStep(model, 19, device=dev, dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(1)
    batches = []
    for i in range(7):
        images = torch.randint(0, 256, (B, H, W, 3), generator=g, device=dev,
                               dtype=torch.uint8)
        labels = torch.randint(0, 19, (B, H, W), generator=g, device=dev)
        labels[:, :16] = 255                               # ignored rows
        wids = (torch.arange(B, device=dev) + i) % 5       # mixed 0–4
        batches.append((images, labels, wids))
    torch.cuda.reset_peak_memory_stats()

    def run():
        for batch in batches[:2]:
            step(*batch, generator=g)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in batches[2:]:
            step(*batch, generator=g)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    dt, launches = run_counted(run, EVAL_COUNTERS, 'eval')
    if launches['bn_act'] != ENSEMBLE_BNS * len(batches):
        raise AssertionError(f'eval: {launches["bn_act"]} K12 launches, not '
                             f'{ENSEMBLE_BNS} a step')
    n_valid = sum(int((lab != 255).sum()) for _, lab, _ in batches)
    cm_total = int(step.cm.sum())
    if cm_total != n_valid:
        raise AssertionError(f'confusion matrix holds {cm_total} pixels, '
                             f'expected {n_valid}')
    dsum = float(step.dsum)
    if not torch.isfinite(step.dsum):
        raise AssertionError(f'depth sum is not finite: {dsum}')
    dispatch = op_dispatch_us(dev)
    dispatch['added_share_of_step'] = dispatch['added_us_per_step'] / (
        dt / 5 * 1e6)
    emit({'phase': 'main_path', 'images_per_s': 5 * B / dt,
          'step_ms': dt / 5 * 1e3, 'batch': B, 'hw': [H, W],
          'dtype': 'bfloat16', 'params': count_parameters(step.model),
          'launches': launches, 'cm_total': cm_total, 'depth_sum': dsum,
          'peak_mem_gib': torch.cuda.max_memory_allocated() / 2 ** 30,
          'op_dispatch': dispatch})
    phase_layers(step, batches[0], g)
    del step, model
    torch.cuda.empty_cache()
    return launches


def op_dispatch_us(dev, steps: int = 20, rounds: int = 5) -> dict:
    """Host cost of the custom ops on the eval step's path: one step's nine
    kernel calls (K1 twice at each MiT stage's shape, K2 once, bf16) through
    ``torch.ops.awseg.*``, as the step makes them, and through the bare
    ctypes launches that the ops' CUDA kernels are, under inference mode, on
    the host clock. ``steps`` steps' calls are enqueued before one
    synchronise (far fewer launches than the card's queue holds, so the
    loop times the host's enqueue, not the card); the two are timed in
    turn, ``rounds`` times each. Microseconds per step, the medians."""
    import torch
    from awsegbench_torch.ops import attention, headkernels

    g = torch.Generator(device=dev).manual_seed(3)
    randn = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    m, d = H * W // 1024, 32
    k1 = [tuple(randn(B * heads, n, d).bfloat16() for n in
                ((H >> (i + 2)) * (W >> (i + 2)), m, m))
          for i, heads in enumerate((1, 2, 5, 8))]
    k2 = seg_core_inputs(randn, (B, H // 32, W // 32, 9, 256), 19,
                         torch.bfloat16)
    ways = {'op': (torch.ops.awseg.sr_attention, torch.ops.awseg.seg_core),
            'launch': (attention._launch, headkernels._launch)}

    def one_step(sr, seg):
        for q, k, v in k1:
            sr(q, k, v, d ** -0.5)
            sr(q, k, v, d ** -0.5)
        seg(*k2, 32)

    us = {way: [] for way in ways}
    with torch.inference_mode():
        for fns in ways.values():
            one_step(*fns)
        for _ in range(rounds):
            for way, fns in ways.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(steps):
                    one_step(*fns)
                us[way].append((time.perf_counter() - t0) / steps * 1e6)
                torch.cuda.synchronize()
    out = {f'{way}_us_per_step': statistics.median(t) for way, t in us.items()}
    out['added_us_per_step'] = out['op_us_per_step'] - out[
        'launch_us_per_step']
    out['rounds_us'] = us
    del k1, k2
    return out


def phase_layers(step, batch, g):
    """Where a main-path step's time goes: each layer timed alone by CUDA
    events, and device time by kernel over one whole step (torch.profiler)
    with the device's busy share of that step's wall time."""
    import torch
    from awsegbench_torch.data.pipeline import prepare_batch
    from awsegbench_torch.metrics.iou import confusion_matrix_from_logits

    images, labels, wids = batch
    model = step.model
    with torch.inference_mode():
        x = prepare_batch(images, labels, wids, generator=g,
                          include_depth=False)['image'].to(step.dtype)
        seg = model(x)['segmentation']
        layers = {
            'prepare_batch': lambda: prepare_batch(
                images, labels, wids, generator=g, include_depth=False),
            'segformer_b0': lambda: model.segformer(x),
            'deeplabv3plus_r50': lambda: model.deeplabv3plus(x),
            'confusion_matrix': lambda: confusion_matrix_from_logits(
                seg, labels, 19)}
        layer_ms = {k: time_ms(fn, reps=5, warmup=1)
                    for k, fn in layers.items()}
    emit({'phase': 'layers', 'batch': B, 'dtype': str(step.dtype),
          'layer_ms': layer_ms,
          **profile_step(lambda: step(*batch, generator=g))})


def phase_parity(dev):
    """Batch 1, f32: the corruption and the ensemble forward on the card
    (through the kernels) against the same on the CPU, where every op
    takes its plain version."""
    import torch
    from awsegbench_torch.data.pipeline import normalize_imagenet
    from awsegbench_torch.models import create_model
    from awsegbench_torch.weather.corruption import (apply_corruption,
                                                     draw_corruption)

    g = torch.Generator(device=dev).manual_seed(2)
    images = torch.randint(0, 256, (2, H, W, 3), generator=g, device=dev,
                           dtype=torch.uint8)
    wids = torch.tensor([2, 3], device=dev)                    # rain, snow
    draws = draw_corruption(wids, H, W, g)
    u8 = {str(where): apply_corruption(
        images.to(where), wids.to(where),
        {k: v.to(where) for k, v in draws.items()}).cpu()
        for where in (dev, 'cpu')}
    # The two sides' exp and blur sums may differ in the last bit, which
    # the truncating uint8 quantisation can turn into one step.
    diff = (u8[str(dev)].int() - u8['cpu'].int()).abs()
    u8_exact = float((diff == 0).float().mean())
    if int(diff.max()) > 1 or u8_exact < 0.999:
        raise AssertionError(f'corruption: card and CPU differ (max '
                             f'{int(diff.max())}, {u8_exact:.5f} exact)')

    x = normalize_imagenet(u8[str(dev)][:1])        # the rain image
    outs = {}
    for where in (dev, 'cpu'):
        model = create_model(MODEL_CFG, device=where, seed=0)
        t0 = time.perf_counter()
        with torch.inference_mode():
            out = model(x.to(where))
        outs[str(where)] = ({k: v.float().cpu() for k, v in out.items()},
                            time.perf_counter() - t0)
        del model
    (gpu, _), (cpu, cpu_s) = outs[str(dev)], outs['cpu']
    errs = {k: max_err(gpu[k], cpu[k]) for k in gpu}
    emit({'phase': 'parity', 'batch': 1, 'dtype': 'float32',
          'corruption_u8_exact': u8_exact, 'max_abs_err': errs,
          'logit_scale': gpu['segmentation'].abs().max().item(),
          'cpu_seconds': cpu_s})
    for k in ('segmentation', 'segformer_seg', 'deeplabv3plus_seg'):
        if not errs[k] <= 2e-3:
            raise AssertionError(f'{k}: card and plain path differ by {errs[k]}')


def phase_train_kernels(dev):
    """K6–K10 against their plain versions; returns the kernels' records."""
    import torch
    import torch.nn.functional as F
    from awsegbench_torch.ops import attention

    g = torch.Generator(device=dev).manual_seed(3)
    randn = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    recs = {}

    # K6 through autograd.grad of the op awseg::sr_attention, against plain
    # autograd; f32 at the JAX test's rtol 2e-4 / atol 2e-5, bf16 within
    # 6e-2 of each gradient's scale (the two round P, dS and dP to bf16 at
    # different points).
    def k6_grads(fn, q, k, v, do, s):
        qkv = [t.detach().requires_grad_() for t in (q, k, v)]
        return torch.autograd.grad(fn(*qkv, s), qkv, do)

    def check_k6(gg, n, mm, dd, dtypes=(torch.float32, torch.bfloat16)):
        q32, k32, v32, do32 = (randn(gg, n, dd), randn(gg, mm, dd),
                               randn(gg, mm, dd), randn(gg, n, dd))
        errs = {}
        for dt in dtypes:
            args = [t.to(dt) for t in (q32, k32, v32, do32)] + [dd ** -0.5]
            got = k6_grads(attention.sr_attention, *args)
            want = k6_grads(attention.sr_attention_plain, *args)
            # no float atomics: a second run gives bit-equal gradients
            again = attention.sr_attention_backward(*args)
            torch.cuda.synchronize()
            if not all(map(torch.equal, got, again)):
                raise AssertionError(f'sr_attention_backward {dt} '
                                     f'{gg}x{n}x{mm}x{dd}: two runs differ')
            rel = 0.0
            for name, a, b in zip('qkv', got, want):
                tag = f'sr_attention_backward {dt} d{name} {gg}x{n}x{mm}x{dd}'
                if dt == torch.float32:
                    check_close(tag, a, b, 2e-4, 2e-5)
                    rel = max(rel, max_err(a, b))
                else:
                    rel = max(rel, check_scaled(tag, a, b, 6e-2))
            errs[dt] = rel
        return errs

    stages = [(B * heads, (H >> (i + 2)) * (W >> (i + 2)))
              for i, heads in enumerate((1, 2, 5, 8))]
    m, d = H * W // 1024, 32
    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    ms = plain_ms = lib_ms = bound_ms = flops_all = bytes_all = scores = 0.0
    dev_ms = lib_dev_ms = 0.0
    for gg, n in stages:
        e = check_k6(gg, n, m, d, (torch.bfloat16,) if gg * n > 2 ** 20
                     else (torch.float32, torch.bfloat16))
        errs = {dt: max(errs[dt], e.get(dt, 0.0)) for dt in errs}
        q, k, v, do = (randn(gg, n, d).bfloat16(), randn(gg, m, d).bfloat16(),
                       randn(gg, m, d).bfloat16(), randn(gg, n, d).bfloat16())
        s = d ** -0.5
        ms += 2 * time_ms(lambda: attention.sr_attention_backward(q, k, v, do, s))
        dev_ms += 2 * device_ms(
            lambda: attention.sr_attention_backward(q, k, v, do, s),
            ('attn_bwd_',))
        qkv = [t.requires_grad_() for t in (q.clone(), k.clone(), v.clone())]
        plain_ms += 2 * (time_ms(lambda: torch.autograd.grad(
            attention.sr_attention_plain(*qkv, s), qkv, do), reps=5)
            - time_ms(lambda: attention.sr_attention_plain(*qkv, s), reps=5))
        q4, k4, v4 = (t[None].detach().requires_grad_() for t in qkv)
        sdpa_grad = lambda: torch.autograd.grad(  # noqa: E731
            F.scaled_dot_product_attention(q4, k4, v4, scale=s), (q4, k4, v4),
            do[None])
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q4, k4, v4, scale=s)
        lib_ms += 2 * (time_ms(sdpa_grad) - time_ms(sdpa))
        lib_dev_ms += 2 * (device_ms(sdpa_grad, ('',))
                           - device_ms(sdpa, ('',)))
        flops, nbytes = 10.0 * gg * n * m * d, 2.0 * (3 * gg * n * d + 4 * gg * m * d)
        bound_ms += 2 * bound(flops, nbytes, BF16_PEAK)[0]
        flops_all += 2 * flops
        bytes_all += 2 * nbytes
        scores += 2.0 * gg * n * m
    # off the main path: head_dim 64, ragged tiles, N over one split
    for shape in ((3, 130, 70, 64), (2, 100, 33, 32), (2, 2500, 40, 32)):
        e = check_k6(*shape)
        errs = {dt: max(errs[dt], e[dt]) for dt in errs}
    recs['sr_attention_backward'] = dict(
        name='sr_attention_backward', route='cuda',
        source='awsegbench_torch/csrc/sr_attention_bwd.cu',
        replaces='awsegbench/ops/attention.py:88',
        max_abs_err=errs[torch.bfloat16], ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound(flops_all, bytes_all, BF16_PEAK)[1],
        library_ms=lib_ms, max_abs_err_f32=errs[torch.float32],
        err_bf16_is='relative to each gradient\'s scale',
        gflop=flops_all / 1e9, design=ATTENTION_DESIGNS, device_ms=dev_ms,
        library_device_ms=lib_dev_ms,
        # pass 1 and pass 2 of the dq kernel and the dk/dv kernel each take
        # one exponential per score
        exp_bound_ms=3 * scores / EX2_RATE * 1e3, scores=scores)

    torch.cuda.empty_cache()
    recs.update(seg_train_kernels(dev, g))
    recs.update(depth_kernels(dev, g))
    relu_decisions(dev, g)
    recs['neighbor_pp_adjoint'] = pp_adjoint_kernel(dev, g)
    recs.update(bn_train_kernels(dev, g))
    return recs


# K13/K14's shapes in the train cell (bf16, channels-last, ReLU): the
# ResNet-50's stem, and the SegFormer depth head's BN after K9 at full
# resolution; then cases off them (shape, residual, ReLU), each in both
# layouts: a ragged C, 6 groups, 256 groups, a C above the vector path's,
# 1×1 maps.
K13_STEM = (B, 64, H // 2, W // 2)
K13_DEPTH = (B, 64, H, W)
K13_RAGGED = (((2, 20, 7, 9), True, True), ((3, 48, 4, 4), True, False),
              ((1, 2048, 3, 5), True, True), ((2, 4096, 2, 2), False, False),
              ((8, 256, 1, 1), False, True))


def bn_train_held(x, w, b, res, dy, relu):
    """K13 and K14 against their plain versions in f64 on the same
    operands: the largest difference over the largest value of y, dx,
    dweight and dbias; raises beyond 1e-5 (f32) or 2^-7 (bf16, one step of
    the largest value). Returns (error, y, stats)."""
    import torch
    from awsegbench_torch.ops import bn_train as bnt
    y, stats = bnt.bn_train(x, w, b, 1e-5, res, relu)
    dx, _, dwb = torch.ops.awseg.bn_train_backward(
        dy, x, y if relu else None, stats, w, False)
    d = [None if t is None else t.double() for t in (x, w, b, res, dy)]
    y64, st64 = bnt.bn_train_plain(d[0], d[1], d[2], 1e-5, d[3], relu)
    gx, _, gwb = bnt.bn_train_backward_plain(
        d[4], d[0], y.double() if relu else None, st64, d[1], False)
    err = max(float((a.double() - want).abs().max()
                    / want.abs().max().clamp_min(1e-30))
              for a, want in ((y, y64), (dx, gx), (dwb[0], gwb[0]),
                              (dwb[1], gwb[1])))
    if not err <= (1e-5 if x.dtype == torch.float32 else 2 ** -7):
        raise AssertionError(f'bn_train {x.dtype} {tuple(x.shape)} strides '
                             f'{x.stride()}: off by {err} of the largest '
                             'value')
    return err, y, stats


def bn_train_kernels(dev, g):
    """K13 (``bn_train``) and K14 (``bn_train_backward``) against their
    plain versions in f64 at ``K13_RAGGED`` in both layouts and dtypes, and
    in bf16 with the ReLU at the stem (``K13_STEM``) and the SegFormer depth
    BN (``K13_DEPTH``), where each is timed beside its bound (the two
    passes' bytes: x read twice and y written, forward; dy, x and y read
    twice and dx written, backward), the plain version (the old
    composition, and its gradient's formula) and the library's train
    ``F.batch_norm`` then ``relu_`` (its backward by autograd), a yardstick
    only. Returns their records."""
    import torch
    import torch.nn.functional as F
    from awsegbench_torch.ops import bn_train as bnt

    def operands(shape, dtype, lay, residual):
        fmt = (torch.channels_last if lay == 'nhwc'
               else torch.contiguous_format)

        def t(scale=1.0, shift=0.0):
            return (torch.randn(shape, generator=g, device=dev) * scale
                    + shift).to(dtype).contiguous(memory_format=fmt)
        c = shape[1]
        return (t(1.5, 0.3),
                (torch.randn(c, generator=g, device=dev) * 0.5 + 1).to(dtype),
                (torch.randn(c, generator=g, device=dev) * 0.5).to(dtype),
                t() if residual else None, t())

    errs = {'float32': 0.0, 'bfloat16': 0.0}
    for name in errs:
        for shape, residual, relu in K13_RAGGED:
            for lay in ('nhwc', 'nchw'):
                ops = operands(shape, getattr(torch, name), lay, residual)
                errs[name] = max(errs[name], bn_train_held(*ops, relu)[0])

    def timed(shape):
        x, w, b, _, dy = operands(shape, torch.bfloat16, 'nhwc', False)
        err, y, stats = bn_train_held(x, w, b, None, dy, True)
        n, es = x.numel(), x.element_size()
        xl = x.detach().requires_grad_()
        wl, bl = w.float().requires_grad_(), b.float().requires_grad_()
        ylib = F.batch_norm(xl, None, None, wl, bl, training=True,
                            eps=1e-5).relu_()

        def lib_fwd():
            return F.batch_norm(x, None, None, wl, bl, training=True,
                                eps=1e-5).relu_()

        def lib_bwd():
            return torch.autograd.grad(ylib, (xl, wl, bl), dy,
                                       retain_graph=True)

        fwd, bwd = {}, {}
        fwd['bound_ms'], fwd['bound_by'] = bound(0.0, 3.0 * n * es,
                                                 BF16_PEAK)
        bwd['bound_ms'], bwd['bound_by'] = bound(0.0, 7.0 * n * es,
                                                 BF16_PEAK)
        # each input read once, each output written once
        fwd['single_read_bound_ms'] = 2.0 * n * es / HBM_BW * 1e3
        bwd['single_read_bound_ms'] = 4.0 * n * es / HBM_BW * 1e3
        fwd.update(
            ms=time_ms(lambda: bnt.bn_train(x, w, b, 1e-5, None, True)),
            device_ms=device_ms(lambda: bnt.bn_train(x, w, b, 1e-5, None,
                                                     True),
                                ('reduce_nhwc8', 'finish', 'apply_nhwc8')),
            plain_ms=time_ms(lambda: bnt.bn_train_plain(x, w, b, 1e-5,
                                                        None, True), reps=5),
            library_ms=time_ms(lib_fwd))

        def k14():
            return torch.ops.awseg.bn_train_backward(dy, x, y, stats, w,
                                                     False)
        bwd.update(
            ms=time_ms(k14),
            device_ms=device_ms(k14, ('reduce_nhwc8', 'finish',
                                      'grad_nhwc8')),
            plain_ms=time_ms(lambda: bnt.bn_train_backward_plain(
                dy, x, y, stats, w, False), reps=5),
            library_ms=time_ms(lib_bwd, reps=5))
        for rec in (fwd, bwd):
            rec.update(shape=list(shape), max_abs_err=err,
                       roofline=rec['bound_ms'] / rec['device_ms'])
        del x, w, b, dy, y, stats, xl, ylib
        torch.cuda.empty_cache()
        return fwd, bwd

    (stem_f, stem_b), (depth_f, depth_b) = timed(K13_STEM), timed(K13_DEPTH)
    recs = {}
    for name, stem, depth in (('bn_train', stem_f, depth_f),
                              ('bn_train_backward', stem_b, depth_b)):
        recs[name] = dict(
            name=name, route='cuda',
            source='awsegbench_torch/csrc/bn_train.cu', replaces=None,
            max_abs_err=max(errs['bfloat16'], stem['max_abs_err']),
            max_abs_err_f32=errs['float32'], ms=stem['ms'],
            plain_ms=stem['plain_ms'], bound_ms=stem['bound_ms'],
            bound_by=stem['bound_by'], library_ms=stem['library_ms'],
            device_ms=stem['device_ms'], ragged_cases=2 * len(K13_RAGGED),
            stem=stem, segformer_depth_bn=depth)
        for case in (stem, depth):
            if not case['ms'] < case['plain_ms']:
                raise AssertionError(f'{name} {case["shape"]}: {case["ms"]} '
                                     f'ms, not below the plain version\'s '
                                     f'{case["plain_ms"]} ms')
    return recs


def seg_train_kernels(dev, g):
    """K7 (both designs) and K8 (the train seg head's core, K8 also through
    the op's gradient) against their plain versions at the path's
    P [b, 16, 32, 9, 256], r = 32, nc = 19, and at SEG_RAGGED; K7 as K2 is
    held (SEG_TOLS). K8 through the op's gradient (dP incl. the plain
    scatter, da1, dc1, dwp, dbp) against autograd through K7's plain
    version, which forms fine as both kernels do (the bf16 kron table in
    bf16): f32 at rtol 2e-3 of each gradient's scale, bf16 within 6e-2 of it
    (the plain version rounds dv and dfine to bf16 where autograd casts, K8
    keeps them f32 until the TPU kernel's own roundings)."""
    import torch
    from awsegbench_torch.ops import headkernels_train as ht

    randn = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    h, w, c, nc, r, rate = H // 32, W // 32, 256, 19, 32, 0.1
    seed = torch.tensor(-123456789, dtype=torch.int32, device=dev)

    def check_k7(shape, rr, ncc, name, rt=rate):
        args = seg_core_inputs(randn, shape, ncc, getattr(torch, name))
        got = ht.seg_core_train(*args, seed, rt, rr)
        want = ht.seg_core_train_plain(*args, seed, rt, rr)
        torch.cuda.synchronize()
        b_, h_, w_ = shape[:3]
        if got.shape != (b_, h_ * rr, w_ * rr, ncc):
            raise AssertionError(f'seg_core_train shape {tuple(got.shape)}')
        check_close(f'seg_core_train {name} {shape} r{rr} nc{ncc}', got, want,
                    SEG_TOLS[name])
        return args, max_err(got, want)

    def check_k8(args, rr, name):
        b_, h_, w_ = args[0].shape[:3]
        dt, ncc = getattr(torch, name), args[3].shape[1]
        dy = randn(b_, h_ * rr, w_ * rr, ncc).mul(0.1).to(dt)
        ins = [t.detach().requires_grad_() for t in args]
        got = torch.autograd.grad(ht.seg_core_train(*ins, seed, rate, rr),
                                  ins, dy)
        ins2 = [t.detach().requires_grad_() for t in args]
        want = torch.autograd.grad(ht.seg_core_train_plain(*ins2, seed, rate,
                                                           rr), ins2, dy)
        torch.cuda.synchronize()
        tol = 2e-3 if dt == torch.float32 else 6e-2
        return max(check_scaled(f'seg_core_train grad {grad} {name} '
                                f'{tuple(args[0].shape)} r{rr} nc{ncc}', a, b,
                                tol)
                   for grad, a, b in zip(('P', 'a1', 'c1', 'wp', 'bp'),
                                         got, want))

    errs7, errs8 = dict.fromkeys(SEG_TOLS, 0.0), dict.fromkeys(SEG_TOLS, 0.0)
    for name in SEG_TOLS:
        for shape, rr, ncc in (((2, h, w, 9, c), r, nc),) + SEG_RAGGED:
            args, e = check_k7(shape, rr, ncc, name)
            errs7[name] = max(errs7[name], e)
            errs8[name] = max(errs8[name], check_k8(args, rr, name))
    check_nc_limit(ht.seg_core_train, randn, seed, rate, r)
    # without dropout: K7's other instantiation, in a process where K2 ran
    check_k7((2, h, w, 9, c), r, nc, 'bfloat16', 0.0)
    args, e = check_k7((B, h, w, 9, c), r, nc, 'bfloat16')   # batch 8
    errs7['bfloat16'] = max(errs7['bfloat16'], e)
    dy = (randn(B, h * r, w * r, nc) * 0.1).bfloat16()
    got = ht.seg_core_train_backward(*args, seed, dy, rate, r)
    want = ht.seg_core_train_backward_plain(*args, seed, dy, rate, r)
    torch.cuda.synchronize()
    errs8['bfloat16'] = max(errs8['bfloat16'], *(
        check_scaled(f'seg_core_train_backward {name} bf16 b8', a, b, 6e-2)
        for name, a, b in zip(('dpp', 'da1', 'dc1', 'dwp', 'dbp'), got, want)))
    del got, want

    recs = {}
    bms, by, kron_ms = seg_bounds(B, h, w, c, nc, r)
    # the hash on every element of the full-resolution hidden
    hash_ms, hash_ops = hash_floor(B * H * W * c)
    recs['seg_core_train'] = dict(
        name='seg_core_train', route='cuda',
        source='awsegbench_torch/csrc/seg_head_train.cu',
        replaces='awsegbench/ops/headkernels_train.py:317',
        max_abs_err=errs7['bfloat16'],
        ms=time_ms(lambda: ht.seg_core_train(*args, seed, rate, r)),
        plain_ms=time_ms(lambda: ht.seg_core_train_plain(*args, seed, rate, r),
                         reps=3, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=None,
        max_abs_err_f32=errs7['float32'], design=SEG_DESIGNS,
        device_ms=device_ms(lambda: ht.seg_core_train(*args, seed, rate, r),
                            ('seg_head_mma',)),
        kron_bound_ms=kron_ms, hash_bound_ms=hash_ms, hash_ops=hash_ops)
    pix = B * h * r * w * r
    flops7 = pix * (2 * 9 * 9 * c / r + 2 * 9 * c + 2 * c * nc)
    p_bytes = args[0].numel() * 2
    bms, by = bound(2 * flops7, p_bytes + pix * nc * 2 + 9 * p_bytes
                    + (2 * c + c * nc + nc) * 4, BF16_PEAK)
    # the tensor-core products: fine and dpp (K = 96), dv (classes padded
    # to 16-class k-steps) and dwp (classes padded to 8·⌈nc/8⌉)
    kron8 = pix * 2 * (2 * 96 * c + 16 * -(-nc // 16) * c
                       + 8 * -(-nc // 8) * c)
    k8 = lambda: ht.seg_core_train_backward(*args, seed, dy, rate, r)  # noqa: E731
    recs['seg_core_train_backward'] = dict(
        name='seg_core_train_backward', route='cuda',
        source='awsegbench_torch/csrc/seg_head_train.cu',
        replaces='awsegbench/ops/headkernels_train.py:349',
        max_abs_err=errs8['bfloat16'],
        ms=time_ms(k8),
        plain_ms=time_ms(lambda: ht.seg_core_train_backward_plain(
            *args, seed, dy, rate, r), reps=3, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=None,
        max_abs_err_f32=errs8['float32'],
        err_is='relative to each gradient\'s scale', gflop=2 * flops7 / 1e9,
        design=SEG_DESIGNS,
        device_ms=device_ms(k8, ('seg_bwd_mma', 'seg_train_reduce')),
        # without dropout (rate 0): what the hash costs K8
        device_ms_rate0=device_ms(lambda: ht.seg_core_train_backward(
            *args, seed, dy, 0.0, r), ('seg_bwd_mma', 'seg_train_reduce')),
        kron_bound_ms=kron8 / BF16_PEAK * 1e3, kron_gflop=kron8 / 1e9,
        hash_bound_ms=hash_ms)
    del args, dy
    torch.cuda.empty_cache()
    return recs


def depth_kernels(dev, g):
    """K9 and K10 (the depth head's stage-1 core) against their plain
    versions: f32 within 1e-4 (K9) and rtol 2e-3 of each gradient's scale
    (K10, also through the op's gradient), bf16 within 6e-2 of the
    scale, as K7/K8; at the path's P [b, 16, 32, 9, 128], r = 32, and at a
    ragged shape off it."""
    import torch
    from awsegbench_torch.ops import depthkernels_train as dk

    randn = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    h, w, c, r, rate = H // 32, W // 32, 128, 32, 0.1
    seed = torch.tensor(24681357, dtype=torch.int32, device=dev)

    def core_inputs(shape, dt):
        cc = shape[-1]
        return (randn(*shape).mul(0.5).to(dt), 1.0 + 0.1 * randn(cc),
                0.1 * randn(cc))

    def check_k9(shape, rr, dt, tol):
        args = core_inputs(shape, dt)
        got = dk.d1_core_train(*args, seed, rate, rr)
        want = dk.d1_core_train_plain(*args, seed, rate, rr)
        torch.cuda.synchronize()
        b_, h_, w_, _, c_ = shape
        if got.shape != (b_, h_ * rr, w_ * rr, c_) or got.dtype != dt:
            raise AssertionError(f'd1_core_train shape {tuple(got.shape)}')
        if dt == torch.float32:
            check_close(f'd1_core_train f32 {shape} r{rr}', got, want, tol)
            return args, max_err(got, want)
        # bf16: the plain version multiplies the same bf16 kron table, so
        # d1 agrees bit for bit but where an f32 sum in another order moves
        # a value across a rounding boundary (or a ReLU decision of a z
        # within rounding of 0): ≥ 99.9% bit-equal, the rest within one
        # bf16 step of the value, with the floor of one step of the largest
        # |d1| of the pixel
        err = (got.float() - want.float()).abs()
        step = torch.maximum(bf16_step(want), bf16_step(
            want.float().abs().amax(-1, keepdim=True)))
        share = float((err == 0).float().mean())
        if share < 0.999 or not bool((err <= step).all()):
            raise AssertionError(
                f'd1_core_train bf16 {shape} r{rr}: {share} bit-equal, max '
                f'excess over one bf16 step {(err - step).max().item()}')
        bit_equal[0] = min(bit_equal[0], share)
        return args, check_scaled(f'd1_core_train {dt} {shape} r{rr}', got,
                                  want, tol)

    def check_k10(args, rr, dt, tol):
        b_, h_, w_, _, c_ = args[0].shape
        dd1 = randn(b_, h_ * rr, w_ * rr, c_).to(dt)
        ins = [t.detach().requires_grad_() for t in args]
        got = torch.autograd.grad(dk.d1_core_train(*ins, seed, rate, rr),
                                  ins, dd1)
        ins2 = [t.detach().requires_grad_() for t in args]
        want = torch.autograd.grad(dk.d1_core_train_plain(*ins2, seed, rate,
                                                          rr), ins2, dd1)
        torch.cuda.synchronize()
        return max(check_scaled(f'd1_core_train grad {name} {dt} '
                                f'{tuple(args[0].shape)} r{rr}', a, b, tol)
                   for name, a, b in zip(('P', 'a1', 'c1'), got, want))

    def check_k10_direct(args, rr):
        b_, h_, w_, _, c_ = args[0].shape
        dd1 = randn(b_, h_ * rr, w_ * rr, c_).bfloat16()
        got = dk.d1_core_train_backward(*args, seed, dd1, rate, rr)
        want = dk.d1_core_train_backward_plain(*args, seed, dd1, rate, rr)
        torch.cuda.synchronize()
        return max(check_scaled(f'd1_core_train_backward {name} bf16 '
                                f'{tuple(args[0].shape)} r{rr}', x, y, 6e-2)
                   for name, x, y in zip(('dpp', 'da1', 'dc1'), got, want))

    bit_equal = [1.0]
    errs9, errs10 = {}, {}
    for dt, tol9, tol10 in ((torch.float32, 1e-4, 2e-3),
                            (torch.bfloat16, 6e-2, 6e-2)):
        args, errs9[dt] = check_k9((2, h, w, 9, c), r, dt, tol9)
        errs10[dt] = check_k10(args, r, dt, tol10)
    args, _ = check_k9((1, 3, 5, 9, 48), 8, torch.float32, 1e-4)  # ragged
    check_k10(args, 8, torch.float32, 2e-3)
    # bf16 off the path: every r class and odd h/w (the SEG_RAGGED shapes)
    for shape, rr, _ in SEG_RAGGED:
        args, e = check_k9(shape, rr, torch.bfloat16, 6e-2)
        errs9[torch.bfloat16] = max(errs9[torch.bfloat16], e)
        errs10[torch.bfloat16] = max(errs10[torch.bfloat16],
                                     check_k10(args, rr, torch.bfloat16, 6e-2),
                                     check_k10_direct(args, rr))
    args, e = check_k9((B, h, w, 9, c), r, torch.bfloat16, 6e-2)   # batch 8
    errs9[torch.bfloat16] = max(errs9[torch.bfloat16], e)
    dd1 = randn(B, h * r, w * r, c).bfloat16()
    got = dk.d1_core_train_backward(*args, seed, dd1, rate, r)
    want = dk.d1_core_train_backward_plain(*args, seed, dd1, rate, r)
    torch.cuda.synchronize()
    errs10[torch.bfloat16] = max(errs10[torch.bfloat16], *(
        check_scaled(f'd1_core_train_backward {name} bf16 b8', a, b, 6e-2)
        for name, a, b in zip(('dpp', 'da1', 'dc1'), got, want)))
    del got, want

    # bytes: P read, d1 written (K9); P and dd1 read, dpp written (K10)
    pix = B * h * r * w * r
    flops9 = pix * (2 * 9 * 9 * c / r + 2 * 9 * c)
    kron9 = pix * 2 * 96 * c          # the kron GEMM with K = 96
    p_bytes, d1_bytes = args[0].numel() * 2, pix * c * 2
    hash_ms = hash_floor(B * H * W * c)[0]
    k9 = lambda: dk.d1_core_train(*args, seed, rate, r)  # noqa: E731
    k10 = lambda: dk.d1_core_train_backward(  # noqa: E731
        *args, seed, dd1, rate, r)
    recs = {}
    bms, by = bound(flops9, p_bytes + d1_bytes + 2 * c * 4, BF16_PEAK)
    recs['d1_core_train'] = dict(
        name='d1_core_train', route='cuda',
        source='awsegbench_torch/csrc/depth_stage1_train.cu',
        replaces='awsegbench/ops/depthkernels_train.py:82',
        max_abs_err=errs9[torch.bfloat16],
        ms=time_ms(k9),
        plain_ms=time_ms(lambda: dk.d1_core_train_plain(*args, seed, rate, r),
                         reps=3, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=None,
        max_abs_err_f32=errs9[torch.float32],
        err_bf16_is='relative to the output\'s scale', gflop=flops9 / 1e9,
        bf16_bit_equal_share=bit_equal[0], design=SEG_DESIGNS,
        device_ms=device_ms(k9, ('seg_head_mma',)),
        kron_bound_ms=kron9 / BF16_PEAK * 1e3, hash_bound_ms=hash_ms)
    bms, by = bound(2 * flops9, p_bytes + d1_bytes + 9 * p_bytes + 4 * c * 4,
                    BF16_PEAK)
    recs['d1_core_train_backward'] = dict(
        name='d1_core_train_backward', route='cuda',
        source='awsegbench_torch/csrc/depth_stage1_train.cu',
        replaces='awsegbench/ops/depthkernels_train.py:97',
        max_abs_err=errs10[torch.bfloat16],
        ms=time_ms(k10),
        plain_ms=time_ms(lambda: dk.d1_core_train_backward_plain(
            *args, seed, dd1, rate, r), reps=3, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=None,
        max_abs_err_f32=errs10[torch.float32],
        err_is='relative to each gradient\'s scale', gflop=2 * flops9 / 1e9,
        design=SEG_DESIGNS,
        device_ms=device_ms(k10, ('seg_bwd_mma', 'd1_reduce')),
        device_ms_rate0=device_ms(lambda: dk.d1_core_train_backward(
            *args, seed, dd1, 0.0, r), ('seg_bwd_mma', 'd1_reduce')),
        kron_bound_ms=2 * kron9 / BF16_PEAK * 1e3, hash_bound_ms=hash_ms)
    del args, dd1
    torch.cuda.empty_cache()
    return recs


def relu_decisions(dev, g):
    """One ReLU decision, checked exactly: the bf16 backwards (K8, K10)
    recompute fine as their forwards (K7, K9) formed it. At rate 0 with
    C = nc = 32, wp = I and bp = 0, K7's logits are bf16(relu(z)) channel by
    channel, so each channel's count of positive logits must equal K8's dc1
    for dy = 1 everywhere (then dv = 1 and dz = [z > 0]); likewise K9's count
    of d1 > 0 and K10's dc1 for dd1 = 1. The counts are whole numbers below
    2^24, exact in f32. At r = 32 and an odd r."""
    import torch
    from awsegbench_torch.ops import depthkernels_train as dk
    from awsegbench_torch.ops import headkernels_train as ht

    randn = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    c, seed = 32, torch.tensor(0, dtype=torch.int32, device=dev)
    wp = torch.eye(c, device=dev, dtype=torch.bfloat16)
    bp = torch.zeros(c, device=dev)
    counts = {}
    for shape, rr in (((2, 4, 4, 9, c), 32), ((2, 3, 5, 9, c), 7)):
        P = (randn(*shape) * 0.5).bfloat16()
        a1, c1 = randn(c), 0.1 * randn(c)     # a1 of both signs
        ones = torch.ones(shape[0], shape[1] * rr, shape[2] * rr, c,
                          device=dev, dtype=torch.bfloat16)
        pos7 = (ht.seg_core_train(P, a1, c1, wp, bp, seed, 0.0, rr) > 0).sum(
            (0, 1, 2)).float()
        dc8 = ht.seg_core_train_backward(P, a1, c1, wp, bp, seed, ones, 0.0,
                                         rr)[2]
        pos9 = (dk.d1_core_train(P, a1, c1, seed, 0.0, rr) > 0).sum(
            (0, 1, 2)).float()
        dc10 = dk.d1_core_train_backward(P, a1, c1, seed, ones, 0.0, rr)[2]
        torch.cuda.synchronize()
        for fwd, bwd, a, b_ in (('K7', 'K8', pos7, dc8),
                                ('K9', 'K10', pos9, dc10)):
            if not torch.equal(a, b_):
                raise AssertionError(
                    f'{fwd} and {bwd} took different ReLU decisions at '
                    f'{shape} r{rr}: {int((a - b_).abs().sum())} pixels')
        counts[f'r{rr}'] = int(pos7.sum())
    emit({'phase': 'relu_decisions', 'agree': True,
          'positive_hidden_elements': counts})


def pp_adjoint_kernel(dev, g):
    """``neighbor_pp_adjoint`` (csrc/pp_adjoint.cu) bit-equal to
    ``_neighbor_pp_adjoint(dpp)`` rounded to dpp's dtype, at both heads'
    dpp (the seg head's C = 256, the depth head's 128) in bf16 and f32, and
    at grids where every cell is clamped (1×1, 1×N, N×1) and channel counts
    off the vector width; timed per train step (both heads' scatters)."""
    import torch
    from awsegbench_torch.ops import headkernels_train as ht

    randn = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    h, w = H // 32, W // 32
    path = [(B, h, w, 81, 256), (B, h, w, 81, 128)]
    for shape in path + [(2, 1, 1, 81, 32), (2, 1, 7, 81, 48),
                         (3, 5, 1, 81, 16), (2, 3, 5, 81, 20)]:
        for dt in (torch.bfloat16, torch.float32):
            dpp = randn(*shape).to(dt)
            got = ht.neighbor_pp_adjoint(dpp)
            want = ht._neighbor_pp_adjoint(dpp).to(dt)
            torch.cuda.synchronize()
            if got.dtype != dt or not torch.equal(got, want):
                raise AssertionError(f'neighbor_pp_adjoint {dt} {shape}: '
                                     f'{max_err(got, want)} from the plain')
    dpps = [randn(*shape).bfloat16() for shape in path]
    ms = plain_ms = dev_ms = bound_ms = 0.0
    for dpp in dpps:
        ms += time_ms(lambda: ht.neighbor_pp_adjoint(dpp))
        dev_ms += device_ms(lambda: ht.neighbor_pp_adjoint(dpp),
                            ('pp_adjoint',))
        plain_ms += time_ms(
            lambda: ht._neighbor_pp_adjoint(dpp).to(dpp.dtype), reps=5)
        bound_ms += bound(0.0, dpp.numel() * 2 * (1 + 9 / 81), BF16_PEAK)[0]
    del dpps
    torch.cuda.empty_cache()
    return dict(
        name='neighbor_pp_adjoint', route='cuda',
        source='awsegbench_torch/csrc/pp_adjoint.cu',
        # no Pallas kernel: XLA's transpose of the neighbourhood gather
        replaces='awsegbench/ops/headkernels.py:104',
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by='bytes', library_ms=None, device_ms=dev_ms,
        per='train step: the seg head\'s and the depth head\'s scatter')


EVAL_COUNTERS = ('sr_attention', 'seg_core', 'splat_coverage_batched',
                 'bn_act')
# K12 launches of one eval forward: every BN of the ensemble (64 in
# DeepLabV3+, 2 in the SegFormer depth head) and of Mask2Former-R50's
# ResNet-50
ENSEMBLE_BNS, M2F_BNS = 66, 53
# The paths that run a model in eval mode (the train CLI validates too),
# where K12 launches, and those that only train, where it never does
EVAL_PATHS = ('eval', 'evaluator', 'mask2former', 'cli_train',
              'cli_evaluate', 'pretrained', 'serving', 'parallel_tiled_eval',
              'parallel_tiled_sweep', 'tp_eval_rank0', 'tp_eval_rank1')
TRAIN_PATHS = ('train', 'remat_off', 'remat_on', 'parallel_train_rank0',
               'parallel_train_rank1', 'tp_train_rank0', 'tp_train_rank1')
# The attention wrappers' designs, by the dtype they take (ops/attention.py);
# the paths run bf16, so their launches (and those of K2 and K7–K10) must
# all go through 'mma_bf16'.
ATTENTION_DESIGNS = {'bfloat16': 'mma_bf16', 'float32': 'simt_f32'}
TRAIN_COUNTERS = ('sr_attention', 'splat_coverage_batched',
                  'sr_attention_backward', 'seg_core_train',
                  'seg_core_train_backward', 'd1_core_train',
                  'd1_core_train_backward', 'neighbor_pp_adjoint',
                  'bn_train', 'bn_train_backward')
# K13 and K14 launches of one train step of the ensemble: every BN in train
# mode (64 in DeepLabV3+, 1 in the SegFormer depth head after K9), once
# each on one process (twice under a data-parallel mesh: the sums, then
# the pass that reads them)
TRAIN_BNS = 65
SINGLE_COUNTERS = ('splat_coverage_windowed', 'splat_coverage_tiled')
# K5's shapes: Cityscapes' height × width, then the same pixels upright
K5_SHAPES = ((1024, 2048), (2048, 1024))


def count_launches(run):
    """``run()`` after the launch table is cleared: its result and the
    launches of every op of ``library.KERNEL_OPS`` by name, and of each of
    the designs of those with two as ``<name>.by_design``."""
    import torch
    from awsegbench_torch import _build
    from awsegbench_torch.ops.library import KERNEL_OPS
    torch.cuda.synchronize()
    _build.launches.clear()
    _build.design_launches.clear()
    out = run()
    torch.cuda.synchronize()
    counts = {op: _build.launches[op] for op in KERNEL_OPS}
    for op, designs in KERNEL_OPS.items():
        if designs:
            counts[f'{op}.by_design'] = {
                d: _build.design_launches[op, d] for d in designs}
    return out, counts


def run_counted(run, needed, what):
    """:func:`count_launches` of ``run``; raises if a kernel in ``needed``
    never launched, or if a needed op with two designs (K1, K2,
    K6–K10) launched its bf16 design ('mma_bf16') no time or its f32
    design at all: the paths run in bf16."""
    out, launches = count_launches(run)
    designs = [launches[f'{k}.by_design'] for k in needed
               if f'{k}.by_design' in launches]
    if min(launches[k] for k in needed) <= 0 or any(
            by['mma_bf16'] <= 0 or by['simt_f32'] != 0 for by in designs):
        raise AssertionError(f'a kernel of the {what} path never launched: '
                             f'{launches}')
    return out, launches


def phase_train_path(dev):
    import torch
    from awsegbench_torch.models import count_parameters, create_model
    from awsegbench_torch.train.step import TrainStep

    model = create_model(TRAIN_CFG, device=dev, seed=0)
    step = TrainStep(model, device=dev)             # bf16, bench.py's AdamW
    g = torch.Generator(device=dev).manual_seed(4)
    batches = []
    for i in range(7):
        images = torch.randint(0, 256, (B, H, W, 3), generator=g, device=dev,
                               dtype=torch.uint8)
        labels = torch.randint(0, 19, (B, H, W), generator=g, device=dev)
        labels[:, :16] = 255                               # ignored rows
        batches.append((images, labels, (torch.arange(B, device=dev) + i) % 5))
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = [b.clone() for b in model.buffers()]
    torch.cuda.reset_peak_memory_stats()

    def run():
        losses = [step(*batch, generator=g) for batch in batches[:2]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += [step(*batch, generator=g) for batch in batches[2:]]
        torch.cuda.synchronize()
        return losses, time.perf_counter() - t0

    (loss_dicts, dt), launches = run_counted(run, TRAIN_COUNTERS, 'train')
    for op in ('bn_train', 'bn_train_backward'):
        if launches[op] != TRAIN_BNS * len(batches):
            raise AssertionError(f'train: {launches[op]} {op} launches, not '
                                 f'{TRAIN_BNS} a step')
    losses = [float(x['total_loss']) for x in loss_dicts]
    depth_losses = [float(x['depth_loss']) for x in loss_dicts]
    if not all(map(math.isfinite, losses + depth_losses)) \
            or min(depth_losses) <= 0:
        raise AssertionError(f'train losses: {losses}, depth {depth_losses}')
    # every parameter moves but those listed with their reason
    still = [n for n, p in model.named_parameters()
             if torch.equal(p, params0[n])]
    stats_moved = sum(not torch.equal(b, b0) for b, b0 in zip(model.buffers(),
                                                              stats0))
    if sorted(still) != sorted(STILL_BY_CONSTRUCTION) \
            or stats_moved != len(stats0):
        raise AssertionError(f'parameters that did not move: {still}; '
                             f'{stats_moved}/{len(stats0)} BN stats moved')
    emit({'phase': 'train_path', 'images_per_s': 5 * B / dt,
          'step_ms': dt / 5 * 1e3, 'batch': B, 'hw': [H, W],
          'compute_dtype': 'bfloat16', 'params': count_parameters(model),
          'launches': launches, 'losses': losses,
          'depth_losses': depth_losses,
          'params_still_by_construction': STILL_BY_CONSTRUCTION,
          'peak_mem_gib': torch.cuda.max_memory_allocated() / 2 ** 30})
    phase_train_layers(step, batches[0], g)
    del step, model, params0, stats0
    torch.cuda.empty_cache()
    return launches


def profile_step(run):
    """Device time by kernel over one call of ``run`` (torch.profiler) and
    the device's busy share of its wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            rec = by_kernel.setdefault(e.name[:100], [0.0, 0])
            rec[0] += e.time_range.elapsed_us() / 1e3
            rec[1] += 1
    busy_ms = sum(ms for ms, _ in by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:20]
    return {'profiled_step_wall_ms': wall_ms, 'device_busy_ms': busy_ms,
            'device_busy_share': busy_ms / wall_ms,
            'top_kernels_ms_count': [[k, ms, n] for k, (ms, n) in top]}


def phase_train_layers(step, batch, g):
    """Where a train step's time goes: each layer timed alone by CUDA
    events (the members forward + backward of their summed logits), and
    device time by kernel over one whole step."""
    import torch
    from torch.func import functional_call
    from awsegbench_torch.data.pipeline import prepare_batch
    from awsegbench_torch.train.trainer import (draw_dropout_seed,
                                                fog_density_from_weather)

    images, labels, wids = batch
    model, policy = step.model, step.policy
    dev = images.device
    prep = prepare_batch(images, labels, wids, generator=g,
                         include_depth=True, train=True)
    x = prep['image'].to(policy.compute_dtype)
    seed, seed_sf, seed_dl = (draw_dropout_seed(g, dev) for _ in range(3))

    def member_fwd_bwd(member, kwargs):
        out = functional_call(member, policy.cast_to_compute(member), (x,),
                              kwargs)
        (out['segmentation'].float().sum()
         + out['depth'].float().sum()).backward()

    with torch.no_grad():
        out = functional_call(model, policy.cast_to_compute(model), (x,),
                              {'seed': seed, 'generator': g,
                               'segformer_depth_seed': seed_sf,
                               'deeplab_depth_seed': seed_dl})
    out = {k: v.float() for k, v in out.items()}
    fog = fog_density_from_weather(wids, H, W, g)
    targets = {'label': prep['label'], 'depth': prep['depth']}
    layers = {
        'prepare_batch_train': lambda: prepare_batch(
            images, labels, wids, generator=g, include_depth=True,
            train=True),
        'segformer_b0_fwd_bwd': lambda: member_fwd_bwd(
            model.segformer, {'seed': seed, 'depth_seed': seed_sf}),
        'deeplabv3plus_r50_fwd_bwd': lambda: member_fwd_bwd(
            model.deeplabv3plus, {'generator': g, 'depth_seed': seed_dl}),
        'loss': lambda: step.loss_fn(out, targets, fog),
        'clip_adamw': step.optimizer.step}
    layer_ms = {k: time_ms(fn, reps=3, warmup=1) for k, fn in layers.items()}
    emit({'phase': 'train_layers', 'batch': B, 'layer_ms': layer_ms,
          **profile_step(lambda: step(*batch, generator=g))})


def phase_train_parity(dev):
    """One f32 step at 128×256, batch 2, with the same draws on the card
    (kernels) and on the CPU (plain versions)."""
    import torch
    from awsegbench_torch.data.pipeline import draw_augment
    from awsegbench_torch.models import create_model
    from awsegbench_torch.train.optim import create_optimizer
    from awsegbench_torch.train.step import TrainStep
    from awsegbench_torch.weather.corruption import draw_corruption

    h, w, b = 128, 256, 2
    g = torch.Generator().manual_seed(5)
    images = torch.randint(0, 256, (b, h, w, 3), generator=g,
                           dtype=torch.uint8)
    labels = torch.randint(0, 19, (b, h, w), generator=g)
    labels[:, :4] = 255
    wids = torch.tensor([1, 3])
    draws = {'corruption': draw_corruption(wids, h, w, g),
             'augment': draw_augment(b, g, torch.device('cpu')),
             'fog_u': torch.rand((b, h, w), generator=g),
             'seed': torch.tensor(987654321, dtype=torch.int32),
             'segformer_depth_seed': torch.tensor(-55555, dtype=torch.int32),
             'deeplab_depth_seed': torch.tensor(1234567, dtype=torch.int32),
             'aspp_mask': torch.rand((b, h // 16, w // 16, 256),
                                     generator=g) < 0.5}
    state = create_model(TRAIN_CFG, device='cpu', seed=0).state_dict()
    sgd0 = {'type': 'sgd', 'learning_rate': 0.0, 'momentum': 0.0,
            'weight_decay': 0.0}
    res = {}
    for where in (dev, torch.device('cpu')):
        model = create_model(TRAIN_CFG, device=where, seed=0)
        model.load_state_dict(state)
        step = TrainStep(model, create_optimizer(model.parameters(), sgd0,
                                                 grad_clip=0.0),
                         precision='fp32', device=where)
        t0 = time.perf_counter()
        loss = {k: float(v) for k, v in step(images, labels, wids,
                                              draws=draws).items()}
        res[where.type] = (loss, {n: (torch.zeros_like(p) if p.grad is None
                                      else p.grad).cpu()
                                  for n, p in model.named_parameters()},
                           {n: t.cpu() for n, t in model.named_buffers()},
                           time.perf_counter() - t0)
        del step, model
    (lg, gg, sg, _), (lc, gc, sc, cpu_s) = res['cuda'], res['cpu']
    for k in ('total_loss', 'depth_loss'):
        if not abs(lg[k] - lc[k]) <= 1e-4 * abs(lc[k]) or lc[k] <= 0:
            raise AssertionError(f'train {k}: card {lg[k]}, CPU {lc[k]}')
    top = max(t.abs().max().item() for t in gc.values())
    held = dl_rel = 0.0
    for name, want in gc.items():
        got, scale = gg[name], want.abs().max().item()
        if scale < 1e-6 * top:           # analytically zero leaves
            if got.abs().max().item() >= 1e-6 * top:
                raise AssertionError(f'{name}: card grad not negligible')
            continue
        if name.startswith('deeplabv3plus.'):
            # library convs only; ill-conditioned in f32 at batch 2, so held
            # on the leaf's relative L2 error
            dl_rel = max(dl_rel, ((got - want).norm() / want.norm()).item())
            continue
        rel = ((got - want).abs() - 2e-3 * want.abs()).max().item() / scale
        held = max(held, rel)
        if rel > 2e-3:
            raise AssertionError(f'{name}: card and CPU gradients differ by '
                                 f'{rel} of the leaf scale')
    if dl_rel > 0.1:
        raise AssertionError(f'DeepLab member: card and CPU gradients differ '
                             f'by {dl_rel} (relative L2 of a leaf)')
    stat_err = max(max_err(sg[n], sc[n]) / max(sc[n].abs().max().item(), 1.0)
                   for n in sc)
    if not stat_err <= 1e-4:
        raise AssertionError(f'BN running stats: card and CPU differ by '
                             f'{stat_err}')
    emit({'phase': 'train_parity', 'batch': b, 'hw': [h, w],
          'dtype': 'float32', 'loss_card': lg['total_loss'],
          'loss_cpu': lc['total_loss'], 'depth_loss_card': lg['depth_loss'],
          'depth_loss_cpu': lc['depth_loss'],
          'grad_excess_over_rtol_per_leaf_scale': held,
          'deeplab_grad_max_rel_l2': dl_rel,
          'bn_stats_max_err': stat_err, 'cpu_seconds': cpu_s})


def phase_single_image(dev):
    """The single-image corruption API: ``apply_weather_effect`` for rain
    and snow at 512×1024 (K4), 1024×2048 (Cityscapes' height and width)
    and 2048×1024 (K5), counted; the uint8 images card vs CPU within one
    step and 99.9% exact, as the eval parity phase holds them; then K4 and
    K5 against their plain version on the card, bit for bit, and timed (K5
    at both of its shapes). Returns (records, launches)."""
    import torch
    from awsegbench_torch.ops import splat
    from awsegbench_torch.weather.corruption import (WEATHER_IDS,
                                                     apply_weather_effect,
                                                     draw_corruption)

    g = torch.Generator(device=dev).manual_seed(6)
    runs = []
    for hw in ((H, W),) + K5_SHAPES:
        image = torch.randint(0, 256, (*hw, 3), generator=g, device=dev,
                              dtype=torch.uint8)
        for weather in ('rain', 'snow'):
            wid = torch.tensor([WEATHER_IDS[weather]], device=dev)
            runs.append((hw, weather, image, draw_corruption(wid, *hw, g)))

    outs, launches = run_counted(
        lambda: [apply_weather_effect(image, weather, draws=draws)
                 for _, weather, image, draws in runs],
        SINGLE_COUNTERS, 'single_image')
    exact = {}
    for (hw, weather, image, draws), out in zip(runs, outs):
        cpu = apply_weather_effect(image.cpu(), weather,
                                   draws={k: v.cpu() for k, v in draws.items()})
        diff = (out.cpu().int() - cpu.int()).abs()
        exact[f'{weather}_{hw[0]}x{hw[1]}'] = float((diff == 0).float().mean())
        if out.shape != image.shape or int(diff.max()) > 1 \
                or (diff == 0).float().mean() < 0.999 \
                or (out == image).float().mean() > 0.5:
            raise AssertionError(f'single image {weather} {hw}: card and CPU '
                                 f'differ (max {int(diff.max())})')

    def rain_params(d):
        return splat.pack_params(d['rain_ax'], d['rain_ay'], d['rain_bx'],
                                 d['rain_by'], d['rain_radius'],
                                 d['rain_valid'])[0]

    def splat_record(name, line, rain_runs):
        """The kernel's record at the first run's shape, with its device
        time and bound at every shape of ``rain_runs``."""
        fn = getattr(splat, name)
        by_hw = {}
        for hw, _, _, d in rain_runs:
            params = rain_params(d)
            got = fn(params, *hw)
            check_splat(f'{name} {hw}', got,
                        splat.splat_coverage_plain(params[None], *hw)[0])
            by_hw[f'{hw[0]}x{hw[1]}'] = dict(
                device_ms=device_ms(lambda: fn(params, *hw), ('',)),
                **splat_bound(params, *hw), covered=float(got.mean()))
        hw, params = rain_runs[0][0], rain_params(rain_runs[0][3])
        first = by_hw[f'{hw[0]}x{hw[1]}']
        return dict(
            name=name, route='cuda', source='awsegbench_torch/csrc/splat.cu',
            replaces=f'awsegbench/ops/splat.py:{line}', max_abs_err=0.0,
            ms=time_ms(lambda: fn(params, *hw)),
            device_ms=first['device_ms'],
            plain_ms=time_ms(lambda: splat.splat_coverage_plain(
                params[None], *hw), reps=3, warmup=1),
            bound_ms=first['bound_ms'], bound_by=first['bound_by'],
            library_ms=None, hw=list(hw), by_hw=by_hw)

    rain = [r for r in runs if r[1] == 'rain']
    recs = {'splat_coverage_windowed': splat_record(
                'splat_coverage_windowed', 38, rain[:1]),
            'splat_coverage_tiled': splat_record(
                'splat_coverage_tiled', 90, rain[1:])}
    emit({'phase': 'single_image', 'launches': launches, 'u8_exact': exact,
          'k5_by_hw': recs['splat_coverage_tiled']['by_hw']})
    return recs, launches


EVAL_SWEEP_BATCHES = 10


def schema_keys(exact: bool) -> set:
    """The JAX package's result keys of a sweep over every weather."""
    from awsegbench_torch.weather.corruption import WEATHER_CONDITIONS
    adverse = WEATHER_CONDITIONS[1:]
    return ({'overall_miou', 'expected_calibration_error',
             'ensemble_disagreement_auroc', 'robustness_degradation_ratio',
             '_throughput_images_per_sec', '_eval_seconds', '_num_images'}
            | {f'{k}_{w}' for k in ('miou', 'ece') for w in WEATHER_CONDITIONS}
            | {f'robustness_degradation_{w}' for w in adverse}
            | ({'_auroc_histogram_estimate'} if exact else set()))


def check_sweep(what, ev, res, loader, exact, members=True):
    """Every schema key present and finite (a model without members has
    no disagreement AUROC); each weather's confusion matrix holds that
    weather's non-ignored pixels; the ECE bins hold every non-ignored
    pixel, and the AUROC histogram every one of them (none without
    members)."""
    import torch
    keys = schema_keys(exact) - (set() if members
                                 else {'ensemble_disagreement_auroc'})
    if set(res) != keys or not all(math.isfinite(v) for v in res.values()):
        raise AssertionError(f'{what}: result keys or values: {res}')
    n_valid = torch.zeros(5, dtype=torch.int64)
    for b in loader:
        valid = (b['label'] != 255).sum(dim=(1, 2)).cpu()
        n_valid.index_add_(0, b['weather_id'].cpu().long(), valid)
    acc = ev.last_acc
    if not (torch.equal(acc['cm'].sum(dim=(1, 2)), n_valid)
            and int(acc['ece'][..., 0].sum()) == int(n_valid.sum())
            and int(acc['auroc_hist'].sum()) == (int(n_valid.sum())
                                                 if members else 0)):
        raise AssertionError(f'{what}: counts {acc["cm"].sum(dim=(1, 2))}, '
                             f'ECE {acc["ece"][..., 0].sum()}, histogram '
                             f'{acc["auroc_hist"].sum()} for {n_valid}')
    return int(n_valid.sum())


def sweep_loader(dev, g, n, b, h, w):
    """``n`` seeded synthetic batches of ``b`` images on ``dev``: weather
    ids ``(i + j) % 5``, random labels, the first rows ignored."""
    import torch
    loader = []
    for i in range(n):
        labels = torch.randint(0, 19, (b, h, w), generator=g, device=dev,
                               dtype=torch.int32)
        labels[:, :h // 32] = 255
        loader.append({
            'image': torch.randint(0, 256, (b, h, w, 3), generator=g,
                                   device=dev, dtype=torch.uint8),
            'label': labels,
            'weather_id': (torch.arange(b, device=dev) + i) % 5,
            'sample_id': torch.arange(i * b, (i + 1) * b, device=dev)})
    return loader


def phase_evaluator(dev):
    """The robustness sweep (``Evaluator``) on the main path's model at
    512×1024, batch 8, bf16, over ``EVAL_SWEEP_BATCHES`` synthetic
    batches: in ``histogram`` mode (counted: K1–K3 must launch; then timed
    in a second sweep) and in ``exact`` mode, whose exact AUROC must agree
    with its histogram estimate within 1e-3; the metrics alone timed per
    batch, and one whole batch profiled. Then card against CPU: a small
    f32 sweep, 2 batches of 5 at 128×256, with the same draws (made on the
    CPU), held to the CPU's results within the tests' tolerances. Returns
    the launches."""
    import torch
    from awsegbench_torch.eval.evaluator import (AUROC_BINS, AUROC_RANGE,
                                                 Evaluator)
    from awsegbench_torch.metrics.disagreement import (auroc_exact,
                                                       auroc_histogram_update)
    from awsegbench_torch.models import create_model
    from awsegbench_torch.weather.corruption import draw_corruption

    g = torch.Generator(device=dev).manual_seed(7)
    loader = sweep_loader(dev, g, EVAL_SWEEP_BATCHES, B, H, W)
    config = {'model': MODEL_CFG, 'tpu': {'precision': 'bf16'}}
    model = create_model(MODEL_CFG, device=dev, seed=0)
    ev = Evaluator(model, config, auroc_mode='histogram', device=dev)
    res, launches = run_counted(lambda: ev.run(loader, seed=1),
                                EVAL_COUNTERS, 'evaluator')
    n_valid = check_sweep('histogram sweep', ev, res, loader, False)
    res = ev.run(loader, seed=1)                      # warm: timed
    check_sweep('histogram sweep', ev, res, loader, False)
    ex = Evaluator(model, config, auroc_mode='exact', device=dev)
    res_exact = ex.run(loader, seed=1)
    check_sweep('exact sweep', ex, res_exact, loader, True)
    gap = abs(res_exact['ensemble_disagreement_auroc']
              - res_exact['_auroc_histogram_estimate'])
    if not gap <= 1e-3:
        raise AssertionError(f'exact and histogram AUROC differ by {gap}')

    # the metrics alone, on one batch's outputs; one whole batch profiled
    b0 = loader[0]
    out = ev.forward(b0['image'], b0['label'], b0['weather_id'], g)
    acc = ev.init_acc()
    metrics_ms = time_ms(lambda: ev.accumulate(acc, out, b0['label'],
                                               b0['weather_id']), reps=10)
    batch_profile = profile_step(lambda: ev.accumulate(
        acc, ev.forward(b0['image'], b0['label'], b0['weather_id'], g),
        b0['label'], b0['weather_id']))
    with torch.inference_mode():
        dis = torch.rand(B * H * W, generator=g, device=dev) * 0.7
        err = dis > 0.35
        valid = (b0['label'] != 255).reshape(-1)
    hist_ms = time_ms(lambda: auroc_histogram_update(
        dis, err, AUROC_BINS, *AUROC_RANGE, weights=valid, log_scale=True),
        reps=10)
    scores = torch.rand(EVAL_SWEEP_BATCHES * B * H * W, generator=g,
                        device=dev)
    sort_ms = time_ms(lambda: auroc_exact(scores, scores > 0.5), reps=3,
                      warmup=1)
    del ev, ex, model, out, acc, loader, scores
    torch.cuda.empty_cache()

    # card against CPU: f32, the same draws
    cg = torch.Generator().manual_seed(8)
    small = sweep_loader('cpu', cg, 2, 5, 128, 256)
    draws = [draw_corruption(b['weather_id'], 128, 256, cg) for b in small]
    f32 = {'model': MODEL_CFG, 'tpu': {'precision': 'fp32'}}
    both = {}
    for where in (dev, 'cpu'):
        e = Evaluator(create_model(MODEL_CFG, device=where, seed=0), f32,
                      auroc_mode='exact', device=where)
        both[str(where)] = (e.run(small, seed=0, draws=draws), e.last_acc)
    (rg, ag), (rc, ac) = both[str(dev)], both['cpu']
    moved = ((ag['cm'] - ac['cm']).abs().sum(dim=(1, 2)) / 2).tolist()
    per_weather = ac['cm'].sum(dim=(1, 2)).tolist()
    gaps = {k: abs(rg[k] - rc[k]) for k in rc if not k.startswith('_')
            or k == '_auroc_histogram_estimate'}
    if rg.keys() != rc.keys() or max(gaps.values()) > 2e-3 or any(
            m > 1e-3 * n for m, n in zip(moved, per_weather)):
        raise AssertionError(f'evaluator card vs CPU: moved {moved} of '
                             f'{per_weather}, gaps {gaps}')
    emit({'phase': 'evaluator', 'batch': B, 'hw': [H, W], 'dtype': 'bfloat16',
          'batches': EVAL_SWEEP_BATCHES, 'valid_pixels': n_valid,
          'images_per_s': res['_throughput_images_per_sec'],
          'batch_ms': 1e3 * B / res['_throughput_images_per_sec'],
          'exact_images_per_s': res_exact['_throughput_images_per_sec'],
          'metrics_ms_per_batch': metrics_ms, 'batch_profile': batch_profile,
          'auroc_histogram_update_ms': hist_ms,
          'auroc_exact_ms': sort_ms,
          'exact_pixels': EVAL_SWEEP_BATCHES * B * H * W,
          'results': res, 'results_exact': res_exact, 'launches': launches,
          'card_vs_cpu': {'cm_moved': moved, 'cm_pixels': per_weather,
                          'max_gap': max(gaps.values()),
                          'cpu_results': rc}})
    return launches


M2F_SWEEP_BATCHES = 6
M2F_LAYERS = 6                    # pixel-decoder layers: one K11 launch each
M2F_SWIN_BATCHES = 3


def phase_mask2former(dev):
    """The robustness sweep (``Evaluator``) on Mask2Former-R50 as the
    ``sweep-m2fr50-cityscapes`` cell runs it: 1024×2048, batch 4, bf16,
    over ``M2F_SWEEP_BATCHES`` synthetic batches, counted from zero (K11
    exactly ``M2F_LAYERS`` launches a batch, K12 ``M2F_BNS``, K3 at least
    one), then timed in a second sweep with its peak memory; K11's device
    time in one batch's forward. Then card against CPU in f32 from the
    same weights: the forward at 128×256, batch 2 (semantic scores within
    1e-4 relative L2 error: the two sides sum in other orders, a few ulps a
    product; argmax at least 99.9% equal), and a sweep of 2 batches of 2
    with the same draws (confusion matrices within 0.1% of each weather's
    pixels, mIoU and ECE within 2e-3, as the evaluator phase holds the
    ensemble). Returns the counted sweep's launches."""
    return mask2former_sweep(
        dev, 'mask2former', M2F_CFG, M2F_SWEEP_BATCHES,
        {'ms_deform_attn': M2F_LAYERS, 'bn_act': M2F_BNS},
        ('ms_deform_attn', 'splat_coverage_batched', 'bn_act'),
        ('k11', 'ms_deform_attn'), cpu_batch=2, seed=11)


def phase_mask2former_swin(dev):
    """The same sweep on Mask2Former-Swin-L as the
    ``sweep-m2fswinl-cityscapes`` cell runs it, over ``M2F_SWIN_BATCHES``
    batches: K15 exactly ``M2F_SWIN_BLOCKS`` launches a batch, all through
    its tensor-core design, K11 ``M2F_LAYERS``, K12 none (the model has no
    BN), K3 at least one; K15's device time in one batch's forward; card
    against CPU as the R50's, at batch 1 (the Swin-L's f32 forward on the
    CPU is the phase's longest part). Returns the counted sweep's
    launches."""
    return mask2former_sweep(
        dev, 'mask2former_swin', M2F_SWIN_CFG, M2F_SWIN_BATCHES,
        {'window_attention': M2F_SWIN_BLOCKS, 'ms_deform_attn': M2F_LAYERS,
         'bn_act': 0},
        ('window_attention', 'ms_deform_attn', 'splat_coverage_batched'),
        ('k15', 'window_attention'), cpu_batch=1, seed=13)


def mask2former_sweep(dev, phase, model_cfg, batches, per_batch, needed,
                      timed, cpu_batch, seed):
    """A Mask2Former type's sweep at the cells' 1024×2048, batch
    ``M2F_B``, bf16, over ``batches`` synthetic batches: counted from zero
    (each op of ``per_batch`` exactly that many launches a batch, each of
    ``needed`` at least one), the count checks, then timed in a second
    sweep with its peak memory, and the device time of ``timed`` (its key,
    its kernel's name) in one batch's forward. Then card against CPU in
    f32 from the same weights: the forward at 128×256, batch
    ``cpu_batch``, and a sweep of 2 batches of ``cpu_batch`` with the same
    draws. Emits the phase's line and returns the counted launches."""
    import torch
    from awsegbench_torch.eval.evaluator import Evaluator
    from awsegbench_torch.models import create_model
    from awsegbench_torch.weather.corruption import draw_corruption

    g = torch.Generator(device=dev).manual_seed(seed)
    loader = sweep_loader(dev, g, batches, M2F_B, M2F_H, M2F_W)
    config = {'model': model_cfg, 'tpu': {'precision': 'bf16'}}
    ev = Evaluator(create_model(model_cfg, device=dev, seed=0), config,
                   auroc_mode='histogram', device=dev)
    res, launches = run_counted(lambda: ev.run(loader, seed=1), needed,
                                f'{phase} sweep')
    want = {k: v * batches for k, v in per_batch.items()}
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f'{phase} sweep: launches {launches}, not '
                             f'{want}')
    n_valid = check_sweep(f'{phase} sweep', ev, res, loader, False,
                          members=False)
    torch.cuda.reset_peak_memory_stats()
    res = ev.run(loader, seed=1)                      # warm: timed
    peak = torch.cuda.max_memory_allocated()
    check_sweep(f'{phase} sweep', ev, res, loader, False, members=False)
    b0 = loader[0]
    timed_ms = device_ms(lambda: ev.forward(b0['image'], b0['label'],
                                            b0['weather_id'], g),
                         (timed[1],), reps=2)
    del ev, loader
    torch.cuda.empty_cache()

    # card against CPU: f32, the same weights and draws
    cg = torch.Generator().manual_seed(seed + 1)
    x = torch.randn(cpu_batch, 128, 256, 3, generator=cg)
    small = sweep_loader('cpu', cg, 2, cpu_batch, 128, 256)
    draws = [draw_corruption(b['weather_id'], 128, 256, cg) for b in small]
    f32 = {'model': model_cfg, 'tpu': {'precision': 'fp32'}}
    both = {}
    for where in (dev, 'cpu'):
        model = create_model(model_cfg, device=where, seed=0)
        with torch.inference_mode():
            scores = model(x.to(where))['segmentation'].cpu()
        e = Evaluator(model, f32, device=where)
        both[str(where)] = (scores, e.run(small, seed=0, draws=draws),
                            e.last_acc)
        del model, e
    (sg, rg, ag), (sc, rc, ac) = both[str(dev)], both['cpu']
    rel = float((sg - sc).norm() / sc.norm())
    same = float((sg.argmax(-1) == sc.argmax(-1)).float().mean())
    moved = ((ag['cm'] - ac['cm']).abs().sum(dim=(1, 2)) / 2).tolist()
    per_weather = ac['cm'].sum(dim=(1, 2)).tolist()
    gaps = {k: abs(rg[k] - rc[k]) for k in rc if not k.startswith('_')}
    if not (rel <= 1e-4 and same >= 0.999 and rg.keys() == rc.keys()
            and max(gaps.values()) <= 2e-3
            and all(m <= 1e-3 * n for m, n in zip(moved, per_weather))):
        raise AssertionError(f'{phase} card vs CPU: scores rel {rel}, '
                             f'argmax equal {same}, moved {moved} of '
                             f'{per_weather}, gaps {gaps}')
    emit({'phase': phase, 'batch': M2F_B, 'hw': [M2F_H, M2F_W],
          'dtype': 'bfloat16', 'batches': batches, 'valid_pixels': n_valid,
          'images_per_s': res['_throughput_images_per_sec'],
          'batch_ms': 1e3 * M2F_B / res['_throughput_images_per_sec'],
          'peak_memory_bytes': peak,
          f'{timed[0]}_device_ms_per_batch': timed_ms,
          'results': res, 'launches': launches,
          'card_vs_cpu': {'scores_rel': rel, 'argmax_equal': same,
                          'cm_moved': moved, 'cm_pixels': per_weather,
                          'max_gap': max(gaps.values())}})
    return launches


CLI_WEATHERS = ('clean', 'fog', 'rain', 'snow', 'night')


def cli_config(tmp: Path) -> Path:
    """``configs/default.yaml`` with an empty data root (the synthetic
    fallback: 100 train and 20 val/test images), 512×1024, batch 8, one
    epoch, bf16, MLflow off and warnings only; written under ``tmp``."""
    import yaml
    cfg = yaml.safe_load((ROOT / 'configs' / 'default.yaml').read_text())
    (tmp / 'no_data').mkdir()
    cfg['data'].update(data_root=str(tmp / 'no_data'), image_size=[H, W])
    cfg['training'].update(batch_size=B, epochs=1)
    cfg['tpu']['precision'] = 'bf16'
    cfg['mlflow']['enabled'] = False
    cfg['logging']['level'] = 'WARNING'
    path = tmp / 'config.yaml'
    path.write_text(yaml.safe_dump(cfg))
    return path


def timed_methods(cls, names, seconds):
    """Wrap ``cls``'s methods ``names`` so that each call's wall time is
    added to ``seconds[name]`` (each method ends in a fetch from the card,
    so its wall time covers its device work); returns the originals."""
    originals = {n: getattr(cls, n) for n in names}

    def wrap(name, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                seconds[name] = seconds.get(name, 0.0) + \
                    time.perf_counter() - t0
        return timed
    for n, fn in originals.items():
        setattr(cls, n, wrap(n, fn))
    return originals


def phase_cli(dev):
    """The train CLI then the evaluate CLI, in this process, on the
    default config's full-width ensemble with depth heads (faithful heads)
    at 512×1024, batch 8, bf16, one epoch over the synthetic set: counted
    (K1, K3, K6–K10 and the scatter in the train CLI, K1–K3 in the
    evaluate CLI), the result files checked, the latest checkpoint
    reloaded into a fresh model bit for bit. Returns the launches."""
    import tempfile

    import torch
    from awsegbench_torch.cli import evaluate as eval_cli
    from awsegbench_torch.cli import train as train_cli
    from awsegbench_torch.data.pipeline import prefetch_to_device
    from awsegbench_torch.models import create_model
    from awsegbench_torch.train.checkpoints import load_checkpoint
    from awsegbench_torch.train.trainer import AdverseWeatherTrainer
    from awsegbench_torch.utils.config import load_config

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cfg = cli_config(tmp)
        run = tmp / 'run'
        seconds = {}
        originals = timed_methods(AdverseWeatherTrainer,
                                  ('train_epoch', 'validate_epoch',
                                   'save_checkpoint'), seconds)
        try:
            t0 = time.perf_counter()
            trainer, train_launches = run_counted(
                lambda: train_cli.main(['--config', str(cfg),
                                        '--output-dir', str(run)]),
                TRAIN_COUNTERS, 'cli train')
            train_cli_s = time.perf_counter() - t0
        finally:
            for n, fn in originals.items():
                setattr(AdverseWeatherTrainer, n, fn)
        results = json.loads((run / 'results' / 'training_results.json')
                             .read_text())
        tr, va = results['history']['train'], results['history']['val']
        losses = [tr[0][k] for k in ('train_loss', 'train_seg_loss',
                                     'train_depth_loss')] + \
            [va[0][k] for k in ('val_loss', 'val_seg_loss', 'val_depth_loss')]
        ckpt = run / 'checkpoints'
        if not (results['total_epochs'] == len(tr) == len(va) == 1
                and all(map(math.isfinite, losses))
                and tr[0]['train_samples'] == 96 and va[0]['val_samples'] == 20
                and tr[0]['train_images_per_sec'] > 0
                and (ckpt / 'latest' / 'model.pt').exists()
                and (ckpt / 'best' / 'model.pt').exists()):
            raise AssertionError(f'cli train: {results["history"]}, '
                                 f'{sorted(p.name for p in ckpt.iterdir())}')
        ckpt_bytes = sum(f.stat().st_size
                         for f in (ckpt / 'latest').iterdir())

        # the loader alone: one epoch of the train split onto the card
        loader, _ = train_cli.create_datasets_and_loaders(load_config(cfg))
        t0 = time.perf_counter()
        n_loaded = sum(int(b['image'].shape[0])
                       for b in prefetch_to_device(loader, dev))
        torch.cuda.synchronize()
        loader_images_per_sec = n_loaded / (time.perf_counter() - t0)

        # the latest checkpoint in a fresh model on the card, bit for bit
        model = create_model(load_config(cfg), device=dev)
        tree, _ = load_checkpoint(str(ckpt / 'latest'), map_location=dev)
        model.load_state_dict(tree['state_dict'])
        final = trainer.model.state_dict()
        reloaded = model.state_dict()
        if reloaded.keys() != final.keys() or not all(
                torch.equal(reloaded[k], v) for k, v in final.items()):
            raise AssertionError('cli: the latest checkpoint does not '
                                 'reload to the trained weights')
        n_buffers = sum('running_' in k for k in final)
        del trainer, model, tree, final, reloaded
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        res, eval_launches = run_counted(
            lambda: eval_cli.main([str(ckpt / 'latest'), '--config',
                                   str(cfg), '--output-dir',
                                   str(tmp / 'eval')]),
            EVAL_COUNTERS, 'cli evaluate')
        eval_cli_s = time.perf_counter() - t0
        written = json.loads((tmp / 'eval' / 'evaluation_results.json')
                             .read_text())
        needed = {'overall_miou', 'expected_calibration_error',
                  'ensemble_disagreement_auroc'} | {
            f'{k}_{w}' for k in ('miou', 'ece') for w in CLI_WEATHERS}
        if not (needed <= set(written) and written['_num_images'] == 20
                and all(math.isfinite(v) for v in written.values())
                and (tmp / 'eval' / 'evaluation_report.md').exists()):
            raise AssertionError(f'cli evaluate: {written}')
    torch.cuda.empty_cache()
    emit({'phase': 'cli', 'nvidia_smi': nvidia_smi(), 'batch': B,
          'hw': [H, W], 'dtype': 'bfloat16',
          'train_epoch_s': seconds['train_epoch'],
          'train_images_per_sec': tr[0]['train_images_per_sec'],
          'loader_images_per_sec': loader_images_per_sec,
          'validate_s': seconds['validate_epoch'],
          'checkpoint_bytes': ckpt_bytes,
          'checkpoint_save_s': seconds['save_checkpoint'],
          'train_cli_s': train_cli_s, 'bn_buffers_reloaded': n_buffers,
          'evaluate_cli_s': eval_cli_s,
          'evaluate_images_per_sec': written['_throughput_images_per_sec'],
          'evaluate_sweep_s': written['_eval_seconds'],
          'history': results['history'], 'evaluation': written,
          'launches': {'cli_train': train_launches,
                       'cli_evaluate': eval_launches}})
    return train_launches, eval_launches


# ---------------------------------------------------------------------------
# pretrained encoders, remat, the rest of weather/ops
# ---------------------------------------------------------------------------

# MiT's per-stage spatial-reduction ratios, patch sizes and MLP ratio
# (every variant shares them)
MIT_SR, MIT_PATCH, MIT_MLP = (8, 4, 2, 1), (7, 3, 3, 3), 4


def _he(rng, *shape):
    """Normal values scaled by √(2 / fan-in) of an [out, in, ...] weight."""
    import numpy as np
    fan_in = int(np.prod(shape[1:]))
    return (rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)).astype(
        np.float32)


def mit_state_dict(variant='b0', seed=0, prefix='segformer.'):
    """A Hugging Face ``SegformerModel`` state dict of MiT ``variant`` (the
    transformers key schema, under ``prefix``) with seeded random values:
    He-scaled conv and linear weights, LayerNorm scales near 1, small
    biases. ``{name: float32 ndarray}``."""
    import numpy as np
    from awsegbench_torch.models.segformer import MIT_VARIANTS
    hidden, depths = MIT_VARIANTS[variant]
    rng = np.random.default_rng(seed)
    sd = {}

    def small(n):
        return (rng.standard_normal(n) * 0.02).astype(np.float32)

    def ln(key, c):
        sd[f'{key}.weight'] = rng.uniform(0.8, 1.2, c).astype(np.float32)
        sd[f'{key}.bias'] = small(c)

    def layer(key, cout, cin, *k):
        sd[f'{key}.weight'] = _he(rng, cout, cin, *k)
        sd[f'{key}.bias'] = small(cout)

    cin = 3
    for s, c in enumerate(hidden):
        pe = f'{prefix}encoder.patch_embeddings.{s}'
        layer(f'{pe}.proj', c, cin, MIT_PATCH[s], MIT_PATCH[s])
        ln(f'{pe}.layer_norm', c)
        for j in range(depths[s]):
            hb = f'{prefix}encoder.block.{s}.{j}'
            ln(f'{hb}.layer_norm_1', c)
            ln(f'{hb}.layer_norm_2', c)
            for name in ('self.query', 'self.key', 'self.value',
                         'output.dense'):
                layer(f'{hb}.attention.{name}', c, c)
            if MIT_SR[s] > 1:
                layer(f'{hb}.attention.self.sr', c, c, MIT_SR[s], MIT_SR[s])
                ln(f'{hb}.attention.self.layer_norm', c)
            layer(f'{hb}.mlp.dense1', c * MIT_MLP, c)
            layer(f'{hb}.mlp.dwconv.dwconv', c * MIT_MLP, 1, 3, 3)
            layer(f'{hb}.mlp.dense2', c, c * MIT_MLP)
        ln(f'{prefix}encoder.layer_norm.{s}', c)
        cin = c
    return sd


def resnet50_state_dict(seed=0):
    """A torchvision ResNet-50 state dict (``conv1/bn1/layer{1..4}``, with
    ``num_batches_tracked``) with seeded random values: He-scaled convs, BN
    scales near 1 (near 0.25 for the last BN of each residual branch, as
    the port's init), running means near 0 and variances near 1."""
    import numpy as np
    rng = np.random.default_rng(seed)
    sd = {}

    def bn(key, c, scale=1.0):
        sd[f'{key}.weight'] = (rng.uniform(0.8, 1.2, c) * scale).astype(
            np.float32)
        sd[f'{key}.bias'] = (rng.standard_normal(c) * 0.02).astype(np.float32)
        sd[f'{key}.running_mean'] = (rng.standard_normal(c) * 0.05).astype(
            np.float32)
        sd[f'{key}.running_var'] = rng.uniform(0.9, 1.1, c).astype(np.float32)
        sd[f'{key}.num_batches_tracked'] = np.array(1000, np.int64)

    sd['conv1.weight'] = _he(rng, 64, 3, 7, 7)
    bn('bn1', 64)
    cin = 64
    for s, (n, width) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
        for j in range(n):
            tb = f'layer{s + 1}.{j}'
            sd[f'{tb}.conv1.weight'] = _he(rng, width, cin, 1, 1)
            bn(f'{tb}.bn1', width)
            sd[f'{tb}.conv2.weight'] = _he(rng, width, width, 3, 3)
            bn(f'{tb}.bn2', width)
            sd[f'{tb}.conv3.weight'] = _he(rng, width * 4, width, 1, 1)
            bn(f'{tb}.bn3', width * 4, 0.25)
            if j == 0:
                sd[f'{tb}.downsample.0.weight'] = _he(rng, width * 4, cin, 1, 1)
                bn(f'{tb}.downsample.1', width * 4)
            cin = width * 4
    return sd


def write_safetensors(path, sd) -> None:
    """``sd`` as a ``.safetensors`` file of F32 tensors, written by hand: an
    8-byte little-endian header length, the JSON header (name → dtype,
    shape, data offsets), the raw little-endian data."""
    import numpy as np
    header, chunks, off = {}, [], 0
    for k, v in sd.items():
        b = np.ascontiguousarray(v, '<f4').tobytes()
        header[k] = {'dtype': 'F32', 'shape': list(np.shape(v)),
                     'data_offsets': [off, off + len(b)]}
        chunks.append(b)
        off += len(b)
    h = json.dumps(header).encode()
    h += b' ' * (-len(h) % 8)
    Path(path).write_bytes(len(h).to_bytes(8, 'little') + h + b''.join(chunks))


def leaf_digests(tensors) -> list:
    """The sorted (shape, SHA-1 of the f32 bytes) of each tensor: equal
    lists mean the same values, leaf for leaf, whatever their names."""
    import hashlib

    import numpy as np
    return sorted((tuple(np.shape(t)), hashlib.sha1(np.ascontiguousarray(
        t.detach().float().cpu().numpy() if hasattr(t, 'detach')
        else np.asarray(t, np.float32)).tobytes()).hexdigest())
        for t in tensors)


class _Warnings:
    """The warnings a logger emits while in a ``with`` block."""

    def __init__(self, name):
        import logging
        self.logger, self.messages = logging.getLogger(name), []
        self.handler = logging.Handler(logging.WARNING)
        self.handler.emit = lambda r: self.messages.append(r.getMessage())

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self.messages

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def phase_pretrained(dev):
    """Pretrained encoders, from synthetic state dicts in a temporary
    ``$AWSEG_WEIGHTS_DIR``: an HF MiT-B0 as ``.npz``, a torchvision
    ResNet-50 as ``.pt`` (a ``state_dict`` wrapper, ``num_batches_tracked``
    in it) and the same MiT as a hand-written ``.safetensors``. Grafted
    through the trainer's path into the default ensemble on the card: every
    grafted leaf equals its source bit for bit, nothing else moves, and
    ``apply_pretrained`` alone (from either MiT file) grafts the same.
    Then an f32 ``EvalStep`` at batch 8, 512×1024, clean images, card
    against CPU (in calls of 2) within 2e-3 (as the parity phase), the
    confusion matrices within 1e-4 of the pixels; the bf16 ``EvalStep`` at
    batch 8 over 7 mixed-weather batches, counted (K1–K3 must launch) and
    timed; and a truncated ``resnet50.npz`` leaves DeepLab at random init
    with a warning while MiT is grafted. Returns the eval launches."""
    import os
    import tempfile

    import numpy as np
    import torch
    from awsegbench_torch.eval.step import EvalStep
    from awsegbench_torch.models import apply_pretrained, create_model
    from awsegbench_torch.train.trainer import AdverseWeatherTrainer

    mit, r50 = mit_state_dict('b0', seed=11), resnet50_state_dict(seed=12)
    r50_leaves = [v for k, v in r50.items()
                  if not k.endswith('num_batches_tracked')]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        dirs = {d: tmp / d for d in ('weights', 'safetensors', 'truncated')}
        for d in dirs.values():
            d.mkdir()
        np.savez(dirs['weights'] / 'segformer_b0.npz', **mit)
        torch.save({'state_dict': {k: torch.from_numpy(v)
                                   for k, v in r50.items()}},
                   dirs['weights'] / 'resnet50.pt')
        write_safetensors(dirs['safetensors'] / 'segformer_b0.safetensors',
                          mit)
        np.savez(dirs['truncated'] / 'segformer_b0.npz', **mit)
        np.savez(dirs['truncated'] / 'resnet50.npz', **r50)
        bad = dirs['truncated'] / 'resnet50.npz'
        bad.write_bytes(bad.read_bytes()[:bad.stat().st_size // 2])
        file_bytes = {f'{d.name}/{p.name}': p.stat().st_size
                      for d in dirs.values() for p in d.iterdir()}

        # the trainer's path: model.pretrained is true, the cache in the env
        model = create_model(MODEL_CFG, device=dev, seed=0)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        config = {'model': dict(MODEL_CFG, pretrained=True),
                  'tpu': {'precision': 'bf16'}, 'mlflow': {'enabled': False},
                  'seed': 0}
        old = os.environ.get('AWSEG_WEIGHTS_DIR')
        os.environ['AWSEG_WEIGHTS_DIR'] = str(dirs['weights'])
        try:
            t0 = time.perf_counter()
            trainer = AdverseWeatherTrainer(
                model, [], [], config, device=dev,
                checkpoint_dir=str(tmp / 'ck'), log_dir=str(tmp / 'logs'))
            torch.cuda.synchronize()
            trainer_init_s = time.perf_counter() - t0
        finally:
            if old is None:
                del os.environ['AWSEG_WEIGHTS_DIR']
            else:
                os.environ['AWSEG_WEIGHTS_DIR'] = old
        del trainer
        mit_enc = model.segformer.MiTEncoder_0.state_dict()
        r50_enc = model.deeplabv3plus.ResNetEncoder_0.state_dict()
        if leaf_digests(mit_enc.values()) != leaf_digests(mit.values()) \
                or leaf_digests(r50_enc.values()) != leaf_digests(r50_leaves):
            raise AssertionError('pretrained: a grafted leaf differs from '
                                 'its source')
        grafted_keys = {k for k in before
                        if k.startswith(('segformer.MiTEncoder_0.',
                                         'deeplabv3plus.ResNetEncoder_0.'))}
        state = model.state_dict()
        if any(not torch.equal(state[k], v) for k, v in before.items()
               if k not in grafted_keys) or len(grafted_keys) != len(
                   mit_enc) + len(r50_enc):
            raise AssertionError('pretrained: a leaf outside the encoders '
                                 'moved')

        def fresh_graft(weights_dir):
            m = create_model(MODEL_CFG, device=dev, seed=0)
            t0 = time.perf_counter()
            with _Warnings('awsegbench_torch.models.pretrained') as warned:
                grafted = apply_pretrained(m, MODEL_CFG, weights_dir)
            torch.cuda.synchronize()
            return m.state_dict(), grafted, warned, time.perf_counter() - t0

        direct, grafted, _, graft_s = fresh_graft(dirs['weights'])
        st, st_grafted, st_warned, st_s = fresh_graft(dirs['safetensors'])
        bad_sd, bad_grafted, bad_warned, _ = fresh_graft(dirs['truncated'])
    mit_keys = [k for k in state if k.startswith('segformer.MiTEncoder_0.')]
    r50_keys = [k for k in state
                if k.startswith('deeplabv3plus.ResNetEncoder_0.')]
    if grafted != {'segformer': True, 'resnet': True} or any(
            not torch.equal(direct[k], v) for k, v in state.items()):
        raise AssertionError(f'pretrained: apply_pretrained alone {grafted} '
                             'differs from the trainer\'s graft')
    if st_grafted != {'segformer': True, 'resnet': False} or any(
            not torch.equal(st[k], state[k]) for k in mit_keys) or not any(
            'ResNet-50 weights not found' in m for m in st_warned):
        raise AssertionError(f'pretrained: the .safetensors graft '
                             f'{st_grafted}, {st_warned}')
    if bad_grafted != {'segformer': True, 'resnet': False} or any(
            not torch.equal(bad_sd[k], state[k]) for k in mit_keys) or any(
            not torch.equal(bad_sd[k], before[k]) for k in r50_keys) \
            or not any('Could not load pretrained resnet' in m
                       for m in bad_warned):
        raise AssertionError(f'pretrained: a truncated resnet50.npz gave '
                             f'{bad_grafted}, warnings {bad_warned}')
    del direct, st, bad_sd

    # f32 card against CPU on 8 clean images (the same input on both sides):
    # the card's EvalStep at batch 8, the CPU's over 4 calls of 2 (eval-mode
    # BN: each image's outputs are its own)
    g = torch.Generator().manual_seed(13)
    images = torch.randint(0, 256, (B, H, W, 3), generator=g,
                           dtype=torch.uint8)
    labels = torch.randint(0, 19, (B, H, W), generator=g)
    clean = torch.zeros(B, dtype=torch.int64)
    outs, cms = {}, {}
    for side, where, chunk in (('card', dev, B),
                               ('cpu', torch.device('cpu'), 2)):
        m = create_model(MODEL_CFG, device=where, seed=0)
        m.load_state_dict(state)
        step = EvalStep(m, 19, device=where, dtype=torch.float32)
        t0 = time.perf_counter()
        parts = [{k: v.float().cpu() for k, v in step(
            images[i:i + chunk], labels[i:i + chunk], clean[i:i + chunk],
            generator=torch.Generator(where).manual_seed(0)).items()}
            for i in range(0, B, chunk)]
        outs[side] = {k: torch.cat([o[k] for o in parts]) for k in parts[0]}
        cms[side] = (step.cm.cpu(), time.perf_counter() - t0)
        del step, m, parts
    errs = {k: max_err(outs['card'][k], outs['cpu'][k]) for k in outs['cpu']}
    logit_scale = outs['cpu']['segmentation'].abs().max().item()
    cm_diff = int((cms['card'][0] - cms['cpu'][0]).abs().sum())
    if not all(errs[k] <= 2e-3 for k in ('segmentation', 'segformer_seg',
                                          'deeplabv3plus_seg')) \
            or int(cms['card'][0].sum()) != int(cms['cpu'][0].sum()) \
            or cm_diff > 1e-4 * int(cms['cpu'][0].sum()):
        raise AssertionError(f'pretrained: card and CPU differ: {errs}, '
                             f'confusion matrices by {cm_diff} pixels')
    del outs

    # bf16 EvalStep at batch 8, counted and timed
    step = EvalStep(model, 19, device=dev, dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(14)
    batches = []
    for i in range(7):
        lab = torch.randint(0, 19, (B, H, W), generator=g, device=dev)
        lab[:, :16] = 255
        batches.append((torch.randint(0, 256, (B, H, W, 3), generator=g,
                                      device=dev, dtype=torch.uint8),
                        lab, (torch.arange(B, device=dev) + i) % 5))

    def run():
        for batch in batches[:2]:
            step(*batch, generator=g)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in batches[2:]:
            out = step(*batch, generator=g)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    (dt, out), launches = run_counted(run, EVAL_COUNTERS, 'pretrained eval')
    bf16_scale = out['segmentation'].float().abs().max().item()
    n_valid = sum(int((lab != 255).sum()) for _, lab, _ in batches)
    if int(step.cm.sum()) != n_valid or not math.isfinite(bf16_scale) \
            or not torch.isfinite(step.dsum):
        raise AssertionError(f'pretrained eval: cm {int(step.cm.sum())} of '
                             f'{n_valid}, logit scale {bf16_scale}')
    emit({'phase': 'pretrained', 'nvidia_smi': nvidia_smi(),
          'file_bytes': file_bytes, 'trainer_init_with_graft_s':
          trainer_init_s, 'load_graft_s': graft_s,
          'load_graft_safetensors_s': st_s,
          'grafted_leaves': len(mit_enc) + len(r50_enc),
          'fallback_warnings': bad_warned,
          'parity_f32_batch8_max_abs_err': errs,
          'parity_logit_scale': logit_scale, 'parity_cm_diff_pixels':
          cm_diff, 'cpu_seconds': cms['cpu'][1],
          'eval_images_per_s': 5 * B / dt, 'eval_step_ms': dt / 5 * 1e3,
          'eval_bf16_logit_scale': bf16_scale, 'batch': B, 'hw': [H, W],
          'launches': launches})
    del step, model
    torch.cuda.empty_cache()
    return launches


def phase_remat(dev):
    """``TrainStep`` on the train path's configuration (depth heads, bf16,
    512×1024, batch 8, bench.py's AdamW) with remat off and then on, on the
    same initial weights: one step with the same batch and draws, counted
    (K1 must launch 8 times with remat off, 16 with it on: the 8 blocks
    recompute), whose gradients are held against each other at the train
    parity phase's tolerances and whose updated parameters must lie within
    2·lr of each other (one AdamW step moves a value by about lr);
    then 2 warm-up and 5 timed steps (peak memory between
    ``reset_peak_memory_stats`` and the end) and one profiled step, for
    each setting. The same step with remat off once more gives the card's
    own run-to-run spread of those gradients (cuDNN's backward and the
    BN reductions are not bit-reproducible), reported beside. Returns the
    launches by setting."""
    import torch
    from awsegbench_torch.data.pipeline import draw_augment
    from awsegbench_torch.models import create_model
    from awsegbench_torch.train.step import TrainStep
    from awsegbench_torch.weather.corruption import draw_corruption

    g = torch.Generator(device=dev).manual_seed(15)
    batches = []
    for i in range(8):
        labels = torch.randint(0, 19, (B, H, W), generator=g, device=dev)
        labels[:, :16] = 255
        batches.append((torch.randint(0, 256, (B, H, W, 3), generator=g,
                                      device=dev, dtype=torch.uint8),
                        labels, (torch.arange(B, device=dev) + i) % 5))
    seed = lambda v: torch.tensor(v, dtype=torch.int32)     # noqa: E731
    draws = {'corruption': draw_corruption(batches[0][2], H, W, g),
             'augment': draw_augment(B, g, dev),
             'fog_u': torch.rand((B, H, W), generator=g, device=dev),
             'seed': seed(7), 'segformer_depth_seed': seed(-8),
             'deeplab_depth_seed': seed(9),
             'aspp_mask': torch.rand((B, H // 16, W // 16, 256), generator=g,
                                     device=dev) < 0.5}
    res = {}
    for name, remat in (('off', False), ('on', True), ('off_again', False)):
        model = create_model({'model': dict(TRAIN_CFG, remat=remat)},
                             device=dev, seed=0)
        step = TrainStep(model, device=dev)
        loss, launches = run_counted(
            lambda: step(*batches[0], draws=draws), TRAIN_COUNTERS,
            f'remat={remat}')
        grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad).cpu()
                 for n, p in model.named_parameters()}
        params = {n: p.detach().cpu() for n, p in model.named_parameters()}
        if name == 'off_again':
            res[name] = dict(grads=grads)
            del step, model
            break
        gs = torch.Generator(device=dev).manual_seed(16)
        for batch in batches[1:3]:
            step(*batch, generator=gs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for batch in batches[3:]:
            step(*batch, generator=gs)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / 5 * 1e3
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        prof = profile_step(lambda: step(*batches[0], generator=gs))
        res[name] = dict(loss={k: float(v) for k, v in loss.items()},
                         launches=launches, grads=grads, params=params,
                         step_ms=step_ms, peak_mem_gib=peak,
                         device_busy_ms=prof['device_busy_ms'],
                         profiled_step_wall_ms=prof['profiled_step_wall_ms'])
        del step, model
        torch.cuda.empty_cache()
    off, on = res['off'], res['on']
    k1 = (off['launches']['sr_attention'], on['launches']['sr_attention'])
    if k1 != (8, 16):
        raise AssertionError(f'remat: K1 launched {k1} times per step with '
                             'remat off and on, expected (8, 16)')

    held, dl_rel, exact = grad_spread(on['grads'], off['grads'], 'remat')
    floor = grad_spread(res['off_again']['grads'], off['grads'],
                        'remat off twice')
    lr = 1e-3                               # bench.py's AdamW
    param_err = max(max_err(on['params'][n], p)
                    for n, p in off['params'].items())
    if dl_rel > 0.1 or param_err > 2 * lr or not math.isfinite(
            on['loss']['total_loss']) or abs(
            on['loss']['total_loss'] - off['loss']['total_loss']) > 1e-3 * abs(
            off['loss']['total_loss']):
        raise AssertionError(f'remat: DeepLab grads {dl_rel}, params '
                             f'{param_err}, losses {off["loss"]} '
                             f'{on["loss"]}')
    emit({'phase': 'remat', 'nvidia_smi': nvidia_smi(), 'batch': B,
          'hw': [H, W], 'compute_dtype': 'bfloat16',
          'k1_launches_per_step': {'off': k1[0], 'on': k1[1]},
          'grad_excess_over_rtol_per_leaf_scale': held,
          'deeplab_grad_max_rel_l2': dl_rel,
          'grads_bit_equal_share': exact, 'param_max_abs_err': param_err,
          'off_twice': dict(zip(('grad_excess_over_rtol_per_leaf_scale',
                                 'deeplab_grad_max_rel_l2',
                                 'grads_bit_equal_share'), floor)),
          **{f'{k}_{s}': r[k] for s, r in (('off', off), ('on', on))
             for k in ('loss', 'step_ms', 'peak_mem_gib', 'device_busy_ms',
                       'profiled_step_wall_ms')},
          'launches': {'remat_off': off['launches'],
                       'remat_on': on['launches']}})
    return off['launches'], on['launches']


AUG_SHAPES = ((H, W),) + K5_SHAPES[:1]      # K4 at 512×1024, K5 at 1024×2048


def phase_weather_extras(dev):
    """The rest of weather/ops on the card against the CPU: the fog density
    map at 1024×2048 (the same synthetic depth on both sides), the
    single-image depth estimate, a label map's nearest resize (bit for
    bit) and ``WeatherAugmentationPipeline`` for each weather at 512×1024
    (rain and snow through K4) and 1024×2048 (through K5), counted (K4 and
    K5 must launch). The pipeline's output on the card is held against the
    same composition on the CPU, from the same draws (read back from a
    generator in the pipeline's state): uint8 within 2 steps (one step of
    the corruption, scaled by the style transfer's up to 1.3 and rounded)
    and 99.9% exact. Max |Δ| and times. Returns the pipeline's launches."""
    import torch
    from awsegbench_torch.ops.resize import resize_nearest
    from awsegbench_torch.weather import (WeatherAugmentationPipeline,
                                          corruption, estimate_depth,
                                          fog_density_map, synthetic_depth)
    from awsegbench_torch.weather.augmentation import (DEFAULT_INTENSITIES,
                                                       style_transfer)

    g = torch.Generator(device=dev).manual_seed(17)
    hh, ww = K5_SHAPES[0]
    image = torch.randint(0, 256, (hh, ww, 3), generator=g, device=dev,
                          dtype=torch.uint8)
    depth = synthetic_depth(hh, ww, g, device=dev)
    labels = torch.randint(0, 19, (hh, ww), generator=g, device=dev)
    funcs = {'fog_density_map': lambda im, d, lab: fog_density_map(
                 im, depth=d),
             'estimate_depth': lambda im, d, lab: estimate_depth(im),
             'resize_nearest_labels': lambda im, d, lab: resize_nearest(
                 lab, (H, W))}
    errs, ms = {}, {}
    for name, fn in funcs.items():
        got = fn(image, depth, labels)
        want = fn(image.cpu(), depth.cpu(), labels.cpu())
        errs[name] = max_err(got.cpu(), want)
        ms[name] = time_ms(lambda: fn(image, depth, labels), reps=5)
        if got.shape != want.shape or errs[name] > (
                0 if name.startswith('resize') else 1e-5):
            raise AssertionError(f'{name}: card and CPU differ by '
                                 f'{errs[name]}')

    pipe = WeatherAugmentationPipeline()
    names = list(pipe.weather_intensities)
    runs = []
    for hw in AUG_SHAPES:
        img = torch.randint(0, 256, (*hw, 3), generator=g, device=dev,
                            dtype=torch.uint8)
        for i, weather in enumerate(names):
            runs.append((hw, weather, img, 100 * len(runs) + i))

    def augment(hw, weather, img, seed):
        return pipe.apply_domain_adaptation_augmentation(
            img, torch.Generator(device=dev).manual_seed(seed), weather)

    outs, launches = run_counted(lambda: [augment(*r) for r in runs],
                                 SINGLE_COUNTERS, 'augmentation')
    aug = {}
    for (hw, weather, img, seed), out in zip(runs, outs):
        gr = torch.Generator(device=dev).manual_seed(seed)
        torch.randint(len(names), (), generator=gr, device=dev)
        styled = bool(torch.rand((), generator=gr, device=dev)
                      < pipe.style_transfer_prob)
        wid = torch.tensor([corruption.WEATHER_IDS[weather]], device=dev)
        draws = corruption.draw_corruption(wid, *hw, gr,
                                           DEFAULT_INTENSITIES[weather])
        cpu = corruption.apply_weather_effect(
            img.cpu(), weather, draws={k: v.cpu() for k, v in draws.items()})
        cpu = style_transfer(cpu, weather) if styled else cpu
        diff = (out.cpu().int() - cpu.int()).abs()
        key = f'{weather}_{hw[0]}x{hw[1]}'
        aug[key] = {'max_abs_diff': int(diff.max()), 'styled': styled,
                    'exact': float((diff == 0).float().mean()),
                    'ms': time_ms(lambda: augment(hw, weather, img, seed),
                                  reps=5)}
        if out.shape != img.shape or int(diff.max()) > 2 \
                or aug[key]['exact'] < 0.999:
            raise AssertionError(f'augmentation {key}: card and CPU differ: '
                                 f'{aug[key]}')
    emit({'phase': 'weather_extras', 'nvidia_smi': nvidia_smi(),
          'hw': [hh, ww], 'max_abs_err': errs, 'ms': ms,
          'augmentation': aug, 'launches': launches})
    return launches


SERVING_COUNTERS = ('sr_attention', 'seg_core', 'bn_act')
SERVING_LARGE = K5_SHAPES[0]          # Cityscapes' 1024×2048, batch 1


def latency_ms(fn, reps: int) -> list:
    """Host-clock ms of ``reps`` calls of ``fn``, each ended by a
    synchronise, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def percentiles(ms: list) -> dict:
    q = statistics.quantiles(ms, n=10)
    return {'p50_ms': statistics.median(ms), 'p90_ms': q[8], 'n': len(ms)}


def phase_serving(dev):
    """``serving.py`` on the card with the main path's model (the faithful
    ensemble with depth heads, seeded): a ``'poly'`` bf16 artifact at
    512×1024 exported on the card, saved and loaded back through
    ``ServingModel.load``. One batch-1 request counted (K1 8 launches, K2
    1, K3 none: serving applies no corruption; K12 66); its batch-8 outputs against
    the in-process ``build_serving_fn`` forward on the same weights; images
    per second at batch 8 (input on the card, and from the host), p50/p90
    latency at batch 1 from the host (host clock, synchronised), the same
    two for the in-process forward, one profiled batch-8 request; a wrong
    shape refused. A batch-1 bf16
    artifact at 1024×2048 and its latency. An f32 artifact exported on the
    card for ('cuda', 'cpu') against the same artifact loaded on the CPU
    at batch 1 (within 2e-3, the parity phase's logit tolerance), and an
    f32 artifact exported on the CPU for ('cpu', 'cuda'), loaded on the
    card: counted (K1 and K2 must launch there) and equal to the
    card-exported one. Export and load seconds and artifact MB. Returns
    the counted request's launches."""
    import copy
    import tempfile

    import torch
    from awsegbench_torch.models import create_model
    from awsegbench_torch.serving import (ServingModel, build_serving_fn,
                                          export_serving,
                                          save_serving_artifact)

    model = create_model(MODEL_CFG, device=dev, seed=0)
    g = torch.Generator(device=dev).manual_seed(18)
    x8 = torch.randint(0, 256, (B, H, W, 3), generator=g, device=dev,
                       dtype=torch.uint8)
    x8_host, x1_host = x8.cpu().numpy(), x8[:1].cpu().numpy()
    res = {'nvidia_smi': nvidia_smi(), 'hw': [H, W],
           'export_s': {}, 'artifact_mb': {}, 'load_s': {}}

    with tempfile.TemporaryDirectory() as tmp:
        def artifact(name, m, hw, batch, precision, platforms, device):
            t0 = time.perf_counter()
            blob = export_serving(m, hw, batch_size=batch,
                                  precision=precision, platforms=platforms)
            res['export_s'][name] = time.perf_counter() - t0
            res['artifact_mb'][name] = len(blob) / 1e6
            out = save_serving_artifact(
                Path(tmp) / name, blob, {'input_shape': [batch, *hw, 3]})
            t0 = time.perf_counter()
            sm = ServingModel.load(out, device=device)
            res['load_s'][name] = time.perf_counter() - t0
            return out, sm

        _, sm = artifact('poly_bf16', model, (H, W), 'poly', 'bf16',
                         ('cuda',), None)
        out1, launches = run_counted(lambda: sm.predict(x1_host),
                                     SERVING_COUNTERS, 'serving')
        if (launches['sr_attention'], launches['seg_core'],
                launches['splat_coverage_batched'],
                launches['bn_act']) != (8, 1, 0, ENSEMBLE_BNS):
            raise AssertionError(f'serving: a request launched {launches}, '
                                 f'expected K1 8, K2 1, K3 0, K12 '
                                 f'{ENSEMBLE_BNS}')
        got = sm.predict(x8_host)
        serve = build_serving_fn(model, precision='bf16')
        want = serve(x8)
        scale = want['segmentation'].abs().max().item()
        res['bf16_vs_direct_max_abs_diff'] = {
            k: max_err(got[k], want[k]) for k in want}
        res['bf16_logit_scale'] = scale
        if set(got) != {'segmentation', 'depth'} \
                or got['segmentation'].shape != (B, H, W, 19) \
                or got['segmentation'].dtype != torch.float32 \
                or not torch.isfinite(got['segmentation']).all() \
                or max(res['bf16_vs_direct_max_abs_diff'].values()) \
                > scale * 2 ** -7:
            raise AssertionError(f'serving: the artifact and the direct '
                                 f'forward differ: {res}')
        del want
        for what, x in (('device', x8), ('host', x8_host)):
            ms = latency_ms(lambda: sm.predict(x), reps=10)
            res[f'batch8_images_per_s_{what}_input'] = \
                B * len(ms) / sum(ms) * 1e3
        res['batch1_latency'] = percentiles(
            latency_ms(lambda: sm.predict(x1_host), reps=30))
        # the same forward in this process, not exported (eager torch)
        with torch.inference_mode():
            ms = latency_ms(lambda: serve(x8), reps=10)
            res['eager_batch8_images_per_s_device_input'] = \
                B * len(ms) / sum(ms) * 1e3
            res['eager_batch1_latency'] = percentiles(
                latency_ms(lambda: serve(x8[:1]), reps=30))
        del serve
        res['batch8_profile'] = profile_step(lambda: sm.predict(x8))
        for bad in (x8[:1, :H // 2], x8[:1].float()):
            try:
                sm.predict(bad)
            except ValueError:
                continue
            raise AssertionError(f'serving: {tuple(bad.shape)} {bad.dtype} '
                                 'was not refused')
        del sm, got

        large = torch.randint(0, 256, (1, *SERVING_LARGE, 3), generator=g,
                              device=dev, dtype=torch.uint8).cpu().numpy()
        _, sm = artifact('b1_bf16_1024x2048', model, SERVING_LARGE, 1,
                         'bf16', ('cuda',), None)
        res['batch1_latency_1024x2048'] = percentiles(
            latency_ms(lambda: sm.predict(large), reps=20))
        del sm

        path, sm = artifact('b1_f32_card', model, (H, W), 1, 'fp32',
                            ('cuda', 'cpu'), None)
        card = sm.predict(x1_host)
        t0 = time.perf_counter()
        cpu = ServingModel.load(path, device='cpu').predict(x1_host)
        res['f32_cpu_load_and_request_s'] = time.perf_counter() - t0
        res['f32_card_vs_cpu_max_abs_err'] = {
            k: max_err(card[k].cpu(), cpu[k]) for k in card}
        if max(res['f32_card_vs_cpu_max_abs_err'].values()) > 2e-3:
            raise AssertionError(f'serving: f32 card and CPU differ: {res}')
        del sm

        _, sm = artifact('b1_f32_cpu_export', copy.deepcopy(model).cpu(),
                         (H, W), 1, 'fp32', ('cpu', 'cuda'), 'cuda')
        moved, moved_launches = count_launches(lambda: sm.predict(x1_host))
        res['cpu_export_on_card_launches'] = moved_launches
        res['cpu_export_vs_card_export_max_abs_diff'] = {
            k: max_err(moved[k], card[k]) for k in card}
        if (moved_launches['sr_attention'], moved_launches['seg_core'],
                moved_launches['bn_act']) != (8, 1, ENSEMBLE_BNS) \
                or moved_launches['sr_attention.by_design'][
                    'simt_f32'] != 8 or any(
                    res['cpu_export_vs_card_export_max_abs_diff'].values()):
            raise AssertionError(f'serving: the CPU-exported artifact on '
                                 f'the card: {res}')
        del sm
    emit({'phase': 'serving', **res, 'launches': launches})
    del model
    torch.cuda.empty_cache()
    return launches


# The parallel phase: Cityscapes' 1024×2048 split into a 2×2 grid of
# 512×1024 tiles with a 128-pixel halo (4 tiles of 768×1280).
TILE_HW, TILE_GRID, TILE_HALO = (1024, 2048), (512, 1024), 128
PARALLEL_JOIN_S = 240           # the two ranks' time to finish, or fail


def grad_spread(grads, want, what, hold=True):
    """(the SegFormer and ensemble leaves' largest excess over rtol 2e-3 per
    leaf scale, DeepLab's largest relative L2 error, the bit-equal share of
    leaves) of ``grads`` against ``want``, both by name. With ``hold`` it
    raises past the train parity tolerances of the SegFormer and ensemble
    leaves (2e-3 of the leaf's scale; analytically zero leaves
    negligible); DeepLab's bound (0.1 relative L2: library convs,
    ill-conditioned in the low-precision backward) is the caller's."""
    import torch
    top = max(t.abs().max().item() for t in want.values())
    held = dl_rel = 0.0
    for name, w in want.items():
        got, scale = grads[name], w.abs().max().item()
        if scale < 1e-6 * top:
            if hold and got.abs().max().item() >= 1e-6 * top:
                raise AssertionError(f'{what} {name}: grad not negligible')
            continue
        if name.startswith('deeplabv3plus.'):
            dl_rel = max(dl_rel, ((got - w).norm() / w.norm()).item())
            continue
        rel = ((got - w).abs() - 2e-3 * w.abs()).max().item() / scale
        held = max(held, rel)
        if hold and rel > 2e-3:
            raise AssertionError(f'{what} {name}: gradients differ by {rel} '
                                 'of the leaf scale')
    exact = sum(torch.equal(grads[n], g) for n, g in want.items()) / len(want)
    return held, dl_rel, exact


def member_l2(grads, want) -> dict:
    """Each member's gradient (its leaves together; 'ensemble' for the
    mixing weights and the temperature) as the relative L2 distance of
    ``grads`` from ``want``."""
    import torch
    out = {}
    for member in ('segformer', 'deeplabv3plus', 'ensemble'):
        names = [n for n in want if n.split('.')[0] == member
                 or (member == 'ensemble' and '.' not in n)]
        g = torch.cat([grads[n].reshape(-1) for n in names])
        w = torch.cat([want[n].reshape(-1) for n in names])
        out[member] = ((g - w).norm() / w.norm()).item()
    return out


def tiled(model, x, mesh=None):
    """The exact tiled forward of one [H, W, 3] image (``tile_info``)."""
    from awsegbench_torch.parallel.collectives import tiled_forward
    return tiled_forward(lambda _, t, info: model(t, tile_info=info), None,
                         x, *TILE_GRID, TILE_HALO, mesh=mesh,
                         with_tile_info=True)


def parallel_train_inputs(dev, h=None, w=None, b=None, seed=23):
    """A train step's global batch (by default the 2-rank step's: 8 at
    512×1024, mixed weather) and every draw of it, made on the card from
    ``seed``."""
    import torch
    from awsegbench_torch.data.pipeline import draw_augment
    from awsegbench_torch.weather.corruption import draw_corruption
    h, w, b = h or H, w or W, b or B
    g = torch.Generator(device=dev).manual_seed(seed)
    labels = torch.randint(0, 19, (b, h, w), generator=g, device=dev)
    labels[:, :16] = 255
    batch = (torch.randint(0, 256, (b, h, w, 3), generator=g, device=dev,
                           dtype=torch.uint8), labels,
             torch.arange(b, device=dev) % 5)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)     # noqa: E731
    draws = {'corruption': draw_corruption(batch[2], h, w, g),
             'augment': draw_augment(b, g, dev),
             'fog_u': torch.rand((b, h, w), generator=g, device=dev),
             'seed': i32(31), 'segformer_depth_seed': i32(-32),
             'deeplab_depth_seed': i32(33),
             'aspp_mask': torch.rand((b, h // 16, w // 16, 256), generator=g,
                                     device=dev) < 0.5}
    return batch, draws


def parallel_step(dev, mesh, precision):
    """``TrainStep`` on the train path's model (depth heads) in
    ``precision``, plain SGD at lr 0 without a clip (the raw gradients stay
    in ``.grad``), on ``mesh``."""
    from awsegbench_torch.models import create_model
    from awsegbench_torch.train.optim import create_optimizer
    from awsegbench_torch.train.step import TrainStep
    model = create_model(TRAIN_CFG, device=dev, seed=0)
    sgd0 = {'type': 'sgd', 'learning_rate': 0.0, 'momentum': 0.0,
            'weight_decay': 0.0}
    return TrainStep(model, create_optimizer(model.parameters(), sgd0,
                                             grad_clip=0.0),
                     precision=precision, device=dev, mesh=mesh)


def rank_init(rank, world, port, device):
    """Joins this spawned rank to a gloo group of ``world`` on ``port``
    (TF32 off, the card set); returns its device."""
    import torch
    from awsegbench_torch.core.mesh import init_distributed
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    init_distributed(f'localhost:{port}', world, rank, backend='gloo')
    return dev


def parallel_rank(rank: int, port: int, tmp: str, device: str) -> None:
    """One of two ranks on the one card, over gloo (NCCL takes one card
    per rank): (a) the 2-rank train step on its 4 rows of the global
    batch of 8, in bf16 (counted, then 3 timed steps and the gradient
    all-reduce alone) and in f32; (b) the f32 tiled forward with 2 of the
    4 tiles. Saves its results under ``tmp``."""
    import torch
    from awsegbench_torch.core.mesh import create_mesh
    from awsegbench_torch.models import create_model
    from awsegbench_torch.train.trainer import all_reduce_grads
    dev = rank_init(rank, 2, port, device)
    try:
        mesh = create_mesh()
        inp = torch.load(Path(tmp) / 'inputs.pt', weights_only=False)
        batch = tuple(t.to(dev) for t in inp['batch'])
        out = {}
        step = parallel_step(dev, mesh, 'bf16')
        loss, out['launches'] = run_counted(
            lambda: step(*batch, draws=inp['draws']), TRAIN_COUNTERS,
            f'rank {rank} train')
        out['bf16'] = ({k: float(v) for k, v in loss.items()},
                       {n: p.grad.float().cpu() for n, p in
                        step.model.named_parameters()})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            step(*batch, draws=inp['draws'])
        torch.cuda.synchronize()
        out['step_ms'] = (time.perf_counter() - t0) / 3 * 1e3
        params = step.optimizer.params
        out['all_reduce_ms'] = []
        for _ in range(3):
            torch.distributed.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            all_reduce_grads(params, mesh)
            torch.cuda.synchronize()
            out['all_reduce_ms'].append((time.perf_counter() - t0) * 1e3)
        out['grad_mb'] = sum(p.numel() for p in params) * 4 / 1e6
        del step, params
        torch.cuda.empty_cache()
        step = parallel_step(dev, mesh, 'fp32')
        loss = step(*batch, draws=inp['draws'])
        out['fp32'] = ({k: float(v) for k, v in loss.items()},
                       {n: p.grad.cpu() for n, p in
                        step.model.named_parameters()})
        del step
        torch.cuda.empty_cache()
        model = create_model(MODEL_CFG, device=dev, seed=0).eval()
        with torch.inference_mode():
            out['tiled_seg'] = tiled(model, inp['image'].to(dev),
                                     mesh)['segmentation'].cpu()
        torch.save(out, Path(tmp) / f'rank{rank}.pt')
    finally:
        torch.distributed.destroy_process_group()


def run_ranks(target, world: int, tmp: str, dev) -> list:
    """``target(rank, port, tmp, device)`` in ``world`` spawned processes on
    a free port; each saves its result as ``rank<r>.pt`` under ``tmp``.
    Raises if a rank fails or does not finish within ``PARALLEL_JOIN_S``."""
    import socket

    import torch
    import torch.multiprocessing as mp
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context('spawn')
    procs = [ctx.Process(target=target, args=(r, port, tmp, str(dev)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + PARALLEL_JOIN_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(30)
    codes = [p.exitcode for p in procs]
    if hung or codes != [0] * world:
        raise AssertionError(f'{target.__name__}: rank exit codes {codes}, '
                             f'{len(hung)} killed after {PARALLEL_JOIN_S} s')
    return [torch.load(Path(tmp) / f'rank{r}.pt', weights_only=False)
            for r in range(world)]


def phase_parallel(dev):
    """The data mesh and spatial tiling on the card.

    1. Tiled eval on one rank: the main path's ensemble (19 classes, depth
       heads, faithful heads) at 1024×2048 in 512×1024 tiles with a
       128-pixel halo (4 tiles of 768×1280; K1 sees the 4 tiles' heads
       against the full image's 2048 reduced tokens in stage 1). In f32
       with TF32 off, tiled against monolithic within rtol 2e-4 and atol
       2e-5 (the JAX package's tolerance, tests/test_parallel.py), argmax
       equal; in bf16 the tiled forward's argmax agreement with the f32
       monolithic one at most 0.1% below the bf16 monolithic forward's
       (bf16 rounding alone moves the argmax of this seeded model's nearly
       tied logits on about 1% of the pixels), a tiled forward counted (K1
       8 launches, K2 1); ms and peak memory, tiled and monolithic.
    2. An ``Evaluator`` with ``spatial_tiling='on'`` on two synthetic
       1024×2048 images in f32 against the monolithic sweep: mIoU and ECE
       within 1e-4; the tiled sweep's launches counted.
    3. Two ranks on this one card over gloo (spawned, a free port, a join
       timeout): (a) ``TrainStep`` at 512×1024 on a global batch of 8 split
       4 + 4, depth heads, against one process at batch 8 with the same
       draws, in bf16 (the path's; counted) and in f32: the losses within
       1e-3 relative, the ranks' gradients bit-equal to each other; the
       f32 gradients at the train parity tolerances (``grad_spread``); the
       bf16 gradients, whose reductions round per rank, each member's
       within 1.5 times (and 1e-3) the one-process bf16 gradient's relative
       L2 distance from the f32 one (``member_l2``); per-rank step ms, the
       gradient all-reduce's ms (gloo through the host) and launches per
       rank. (b)
       Item 1's f32 tiled forward with its 4 tiles split 2 + 2 over the
       ranks equal to item 1's (rtol 2e-4, atol 2e-5, argmax equal).
    Returns the launches of the counted tiled forward (bf16), of the tiled
    sweep (f32: K1 and K2 through their f32 design) and of each rank's
    bf16 step."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from awsegbench_torch.core.mesh import DataMesh
    from awsegbench_torch.eval.evaluator import Evaluator
    from awsegbench_torch.models import create_model

    t_phase = time.perf_counter()
    hh, ww = TILE_HW
    g = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn((hh, ww, 3), generator=g, device=dev)
    res = {'phase': 'parallel', 'nvidia_smi': nvidia_smi(), 'hw': [hh, ww],
           'tile': list(TILE_GRID), 'halo': TILE_HALO}

    # 1. tiled against monolithic, f32 then bf16
    model = create_model(MODEL_CFG, device=dev, seed=0).eval()
    with torch.inference_mode():
        mono = {k: v[0] for k, v in model(x[None]).items()}
        til = tiled(model, x)
    f32_err = {}
    for k, want in mono.items():
        f32_err[k] = max_err(til[k], want)
        if not torch.allclose(til[k], want, rtol=2e-4, atol=2e-5):
            raise AssertionError(f'parallel: f32 tiled {k} differs from the '
                                 f'monolithic forward by {f32_err[k]}')
        if k != 'depth' and not k.endswith('_depth') and not torch.equal(
                til[k].argmax(-1), want.argmax(-1)):
            raise AssertionError(f'parallel: f32 tiled {k} argmax differs')
    res['f32_tiled_vs_mono_max_abs_err'] = f32_err
    f32_tiled_seg = til['segmentation']
    f32_argmax = mono['segmentation'].argmax(-1)
    del mono, til
    model = model.to(torch.bfloat16)
    xb = x.to(torch.bfloat16)

    @torch.inference_mode()
    def run_tiled():
        return tiled(model, xb)

    @torch.inference_mode()
    def run_mono():
        return model(xb[None])

    til, launches = run_counted(run_tiled, ('sr_attention', 'seg_core',
                                            'bn_act'), 'tiled eval')
    if (launches['sr_attention'], launches['seg_core'],
            launches['bn_act']) != (8, 1, ENSEMBLE_BNS):
        raise AssertionError(f'parallel: a tiled forward launched {launches}'
                             f', expected K1 8, K2 1 and K12 {ENSEMBLE_BNS}')
    mono = run_mono()

    def agree(a, b):
        return (a['segmentation'].reshape(-1, 19).argmax(-1)
                == b.reshape(-1)).float().mean().item()
    res['bf16_argmax_agreement'] = {
        'tiled_vs_monolithic': agree(til, mono['segmentation'].argmax(-1)),
        'tiled_vs_f32': agree(til, f32_argmax),
        'monolithic_vs_f32': agree(mono, f32_argmax)}
    # bf16 rounding alone moves the argmax of this seeded model's nearly
    # tied logits; tiling may move at most 0.1% of the pixels beyond it
    a = res['bf16_argmax_agreement']
    if a['tiled_vs_f32'] < a['monolithic_vs_f32'] - 1e-3:
        raise AssertionError(f'parallel: bf16 argmax agreement {a}')
    del til, mono
    for name, fn in (('tiled', run_tiled), ('monolithic', run_mono)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res[f'bf16_{name}_ms'] = time_ms(fn, reps=5, warmup=1)
        res[f'bf16_{name}_peak_mem_gib'] = (torch.cuda.max_memory_allocated()
                                            / 2 ** 30)
    res['tiled_launches'] = launches
    del model, xb
    torch.cuda.empty_cache()

    # 2. the sweep with spatial tiling against the monolithic sweep
    rng = np.random.default_rng(24)
    batches = []
    for i in range(2):
        labels = rng.integers(0, 19, (1, hh, ww)).astype(np.int32)
        labels[:, :32] = 255
        batches.append({'image': rng.integers(0, 256, (1, hh, ww, 3),
                                              dtype=np.uint8),
                        'label': labels,
                        'weather_id': np.array([i + 1], np.int32),
                        'sample_id': np.array([i], np.int32)})
    sweep = {}
    for tiling in ('off', 'on'):
        cfg = {'model': {'num_classes': 19}, 'tpu': {'precision': 'fp32'},
               'evaluation': {'spatial_tiling': tiling,
                              'tile_size': list(TILE_GRID),
                              'tile_halo': TILE_HALO}}
        ev = Evaluator(create_model(MODEL_CFG, device=dev, seed=0), cfg,
                       device=dev)
        sweep[tiling], counts = count_launches(lambda: ev.run(batches,
                                                              seed=7))
        del ev
        torch.cuda.empty_cache()
    sweep_err = {k: abs(sweep['on'][k] - sweep['off'][k])
                 for k in ('overall_miou', 'expected_calibration_error')}
    if max(sweep_err.values()) > 1e-4:
        raise AssertionError(f'parallel: tiled sweep against monolithic '
                             f'{sweep_err}')
    res['sweep_tiled_vs_mono_abs_err'] = sweep_err
    res['tiled_sweep_launches'] = sweep_launches = counts   # tiling 'on'
    res['sweep_seconds'] = {k: v['_eval_seconds'] for k, v in sweep.items()}

    # 3. two ranks on this card over gloo, against one process
    batch, draws = parallel_train_inputs(dev)
    one = {}
    for precision in ('bf16', 'fp32'):
        step = parallel_step(dev, DataMesh(), precision)
        loss = step(*batch, draws=draws)
        one[precision] = ({k: float(v) for k, v in loss.items()},
                          {n: p.grad.float().cpu()
                           for n, p in step.model.named_parameters()})
        del step, loss
        torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix='awseg_parallel_')
    try:
        torch.save({'batch': tuple(t.cpu() for t in batch),
                    'draws': {k: ({kk: vv.cpu() for kk, vv in v.items()}
                                  if isinstance(v, dict) else v.cpu())
                              for k, v in draws.items()},
                    'image': x.cpu()}, Path(tmp) / 'inputs.pt')
        t0 = time.perf_counter()
        ranks = run_ranks(parallel_rank, 2, tmp, dev)
        res['two_rank_wall_s'] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r0, r1 = ranks
    for precision, (loss1, grads1) in one.items():
        loss2, grads2 = r0[precision]
        if not all(torch.equal(grads2[n], r1[precision][1][n])
                   for n in grads2):
            raise AssertionError(f'parallel: the two ranks hold different '
                                 f'{precision} gradients after the '
                                 'all-reduce')
        for k in ('total_loss', 'depth_loss'):
            if not abs(loss2[k] - loss1[k]) <= 1e-3 * abs(loss1[k]):
                raise AssertionError(f'parallel: {precision} 2-rank {k} '
                                     f'{loss2[k]}, 1 process {loss1[k]}')
        # f32: held at the train parity tolerances. bf16: the split batch
        # rounds its reductions elsewhere (per rank, then summed), which
        # moves its gradients by bf16's own error; each member is held
        # against the f32 gradients of one process, within 1.5 times (and
        # 1e-3) of the one-process bf16 step's distance from them.
        held, dl_rel, exact = grad_spread(grads2, grads1,
                                          f'parallel 2-rank {precision}',
                                          hold=precision == 'fp32')
        if precision == 'fp32' and dl_rel > 0.1:
            raise AssertionError(f'parallel: f32 2-rank DeepLab gradients '
                                 f'differ by {dl_rel} (relative L2 of a '
                                 'leaf)')
        res[precision] = {
            'loss_1_process': loss1, 'loss_2_ranks': loss2,
            'grad_excess_over_rtol_per_leaf_scale': held,
            'deeplab_grad_max_rel_l2': dl_rel,
            'grads_bit_equal_share': exact}
    f32_grads = one['fp32'][1]
    l2 = {'2_ranks': member_l2(r0['bf16'][1], f32_grads),
          '1_process': member_l2(one['bf16'][1], f32_grads)}
    res['bf16']['member_rel_l2_from_f32_1_process'] = l2
    for member, e1 in l2['1_process'].items():
        if l2['2_ranks'][member] > 1.5 * e1 + 1e-3:
            raise AssertionError(f'parallel: bf16 2-rank {member} gradients '
                                 f'{l2} from the f32 ones')
    tile_err = max_err(r0['tiled_seg'], f32_tiled_seg.cpu())
    for r in ranks:
        if not torch.allclose(r['tiled_seg'], f32_tiled_seg.cpu(),
                              rtol=2e-4, atol=2e-5) or not torch.equal(
                r['tiled_seg'].argmax(-1), f32_tiled_seg.cpu().argmax(-1)):
            raise AssertionError(f'parallel: tiles over 2 ranks differ from '
                                 f'one rank by {tile_err}')
    res.update({
        'train_batch': B, 'train_hw': [H, W],
        'rank_step_ms_bf16': [r['step_ms'] for r in ranks],
        'all_reduce_ms': [r['all_reduce_ms'] for r in ranks],
        'all_reduce_mb': r0['grad_mb'], 'backend': 'gloo (one card)',
        'tiles_2_ranks_vs_1_max_abs_err': tile_err,
        'rank_launches': [r['launches'] for r in ranks],
        'phase_wall_s': time.perf_counter() - t_phase})
    emit(res)
    return launches, sweep_launches, r0['launches'], r1['launches']


# The tensor-parallel phase: a {data: 1, model: 2} mesh of two gloo ranks
# sharing the card. Its f32 checks run at a batch of 2 (the eval forward)
# and 2 (the train step): gloo stages every collective through the host,
# about 0.5 GB/s, and an f32 batch of 8 gathers some 8 GB a step; the
# {data: 2, model: 2} step at 128×256, batch 4.
TP_MESH = {'data': 1, 'model': 2}
TP_EVAL_F32_B = 2
TP_F32_B = 2
TP_SMALL = (128, 256, 4)
TP_MIN_FEATURES = 64
TP_LOSS_RTOL = 1e-3           # a rank's losses against one process's
# the ops whose device time is the convolutions' and the matmuls'
CONV_MM_OPS = ('aten::convolution', 'aten::convolution_backward',
               'aten::addmm', 'aten::mm', 'aten::bmm')


def conv_mm_device_ms(prof) -> float:
    """Device ms of the convolutions and matmuls (their aten ops, forward
    and backward) in a torch.profiler profile."""
    total = 0.0
    for e in prof.key_averages():
        if e.key in CONV_MM_OPS:
            total += e.device_time_total
    return total / 1e3


def state_bytes(params, optimizer) -> dict:
    """Bytes of the parameters, their gradients and the optimiser's
    per-element state (AdamW's two moments) this process holds."""
    import torch

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)
    params = list(params)
    return {'params': nbytes(params),
            'grads': nbytes(p.grad for p in params if p.grad is not None),
            'moments': nbytes(v for st in optimizer.inner.state.values()
                              for v in st.values()
                              if torch.is_tensor(v) and v.ndim)}


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(to_cpu(v) for v in tree)
    return tree.cpu()


def tp_step(dev, mesh, precision):
    """``TrainStep`` on the train path's model (depth heads) with bench.py's
    optimiser (clip 1.0, AdamW 1e-3, decay 1e-4) in ``precision`` on
    ``mesh`` (sharded at ``TP_MIN_FEATURES`` on a model axis)."""
    from awsegbench_torch.models import create_model
    from awsegbench_torch.train.step import TrainStep
    return TrainStep(create_model(TRAIN_CFG, device=dev, seed=0),
                     precision=precision, device=dev, mesh=mesh,
                     tp_min_features=TP_MIN_FEATURES)


def argmax_ties(got, want) -> tuple[int, int]:
    """(pixels whose class argmax differs, those of them whose top-2 logits
    in ``want`` lie further apart than the f32 tolerance allows both to
    move: 2·(2e-5 + 2e-4·|top|)); the latter must be 0, the former are ties
    at f32's resolution."""
    import torch
    diff = got.argmax(-1) != want.argmax(-1)
    top2 = want[diff].topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    return (int(diff.sum()), int((margin > 2 * (2e-5 + 2e-4 * top2[:, 0]
                                                .abs())).sum()))


def tp_rank(rank: int, port: int, tmp: str, device: str) -> None:
    """One of two ranks of the {data: 1, model: 2} mesh on the one card,
    over gloo: (a) the main path's eval forward at 512×1024, f32 at
    ``TP_EVAL_F32_B`` rows against the unsharded model in this process,
    bf16 at B rows counted and timed; (b) ``TrainStep`` on the train cell,
    bf16 at B rows (one step: counted, timed, its model-axis collectives
    recorded and the profiler on) and f32 at ``TP_F32_B`` rows; (c) this
    rank's bytes of parameters, gradients and AdamW moments, and its peak
    memory; (d) the collectives and the convolutions' and matmuls' device
    time (the other rank's kernels share the card). Saves its results
    under ``tmp``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from awsegbench_torch.core.mesh import create_mesh, tp_param_shardings
    from awsegbench_torch.models import create_model
    from awsegbench_torch.parallel.tensor import record_comm, shard_model_
    dev = rank_init(rank, 2, port, device)
    t_rank = time.perf_counter()
    try:
        mesh = create_mesh(mesh_shape=TP_MESH)
        out = {'place': (mesh.rank, mesh.data.rank, mesh.model.rank)}
        g = torch.Generator(device=dev).manual_seed(41)
        x = torch.randn((B, H, W, 3), generator=g, device=dev)

        # (a) eval: f32 against this process's unsharded forward, then bf16
        model = create_model(MODEL_CFG, device=dev, seed=0).eval()
        x32 = x[:TP_EVAL_F32_B]
        with torch.inference_mode():
            ref = model(x32)
        shard_model_(model, mesh, tp_param_shardings(model, mesh,
                                                     TP_MIN_FEATURES))
        with torch.inference_mode():
            got = model(x32)
        out['f32_max_abs_err'] = {k: max_err(got[k], v)
                                  for k, v in ref.items()}
        # the largest |Δ| − (2e-5 + 2e-4·|ref|): at most 0 within tolerance
        out['f32_excess'] = {
            k: ((got[k] - v).abs() - 2e-5 - 2e-4 * v.abs()).max().item()
            for k, v in ref.items()}
        out['f32_argmax_ties'] = {k: argmax_ties(got[k], ref[k])
                                  for k in ref if not k.endswith('depth')}
        del got, ref, x32
        out['eval_f32_s'] = time.perf_counter() - t_rank
        model = model.to(torch.bfloat16)
        xb = x.to(torch.bfloat16)

        @torch.inference_mode()
        def forward():
            return model(xb)
        torch.distributed.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tp16, out['eval_launches'] = run_counted(
            forward, ('sr_attention', 'seg_core', 'bn_act'),
            f'rank {rank} tp eval')
        if out['eval_launches']['bn_act'] != ENSEMBLE_BNS:
            raise AssertionError(f'rank {rank} tp eval: '
                                 f'{out["eval_launches"]["bn_act"]} K12 '
                                 f'launches, not {ENSEMBLE_BNS}')
        out['bf16_eval_ms'] = (time.perf_counter() - t0) * 1e3
        tp_argmax = tp16['segmentation'].argmax(-1)
        del tp16, model
        mono = create_model(MODEL_CFG, device=dev, seed=0).eval()
        with torch.inference_mode():
            f32_argmax = mono(x)['segmentation'].argmax(-1)
            mono_argmax = mono.to(torch.bfloat16)(xb)['segmentation'].argmax(
                -1)
        out['bf16_argmax_agreement'] = {
            'tp_vs_1_process': (tp_argmax == mono_argmax).float().mean()
            .item(),
            'tp_vs_f32': (tp_argmax == f32_argmax).float().mean().item(),
            '1_process_vs_f32': (mono_argmax == f32_argmax).float().mean()
            .item()}
        out['eval_s'] = time.perf_counter() - t_rank
        del mono, x, xb
        torch.cuda.empty_cache()

        # (b)–(d) the train step
        inp = torch.load(Path(tmp) / 'inputs.pt', weights_only=False)
        batch = tuple(t.to(dev) for t in inp['bf16'][0])
        draws = inp['bf16'][1]
        step = tp_step(dev, mesh, 'bf16')
        torch.distributed.barrier()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with record_comm() as log, profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            loss, out['train_launches'] = run_counted(
                lambda: step(*batch, draws=draws), TRAIN_COUNTERS,
                f'rank {rank} tp train')
        out['bf16_step_ms'] = (time.perf_counter() - t0) * 1e3
        out['peak_mem_gib'] = torch.cuda.max_memory_allocated() / 2 ** 30
        out['train_comm'] = comm_record(log)
        out['conv_mm_device_ms'] = conv_mm_device_ms(prof)
        out['bf16'] = ({k: float(v) for k, v in loss.items()},
                       {n: p.grad.float().cpu() for n, p in
                        step.model.named_parameters()})
        out['bytes'] = state_bytes(step.model.parameters(), step.optimizer)
        del step, prof
        torch.cuda.empty_cache()
        step = tp_step(dev, mesh, 'fp32')
        loss = step(*(t.to(dev) for t in inp['fp32'][0]),
                    draws=inp['fp32'][1])
        out['fp32'] = ({k: float(v) for k, v in loss.items()},
                       {n: p.grad.cpu() for n, p in
                        step.model.named_parameters()})
        out['rank_s'] = time.perf_counter() - t_rank
        torch.save(out, Path(tmp) / f'rank{rank}.pt')
    finally:
        torch.distributed.destroy_process_group()


def tp_small_rank(rank: int, port: int, tmp: str, device: str) -> None:
    """One of four ranks of a {data: 2, model: 2} mesh on the one card:
    one f32 ``TrainStep`` at ``TP_SMALL``; saves its gradients and
    place."""
    import torch
    from awsegbench_torch.core.mesh import create_mesh
    dev = rank_init(rank, 4, port, device)
    try:
        mesh = create_mesh(mesh_shape={'data': 2, 'model': 2})
        inp = torch.load(Path(tmp) / 'inputs.pt', weights_only=False)
        step = tp_step(dev, mesh, 'fp32')
        loss = step(*(t.to(dev) for t in inp['small'][0]),
                    draws=inp['small'][1])
        torch.save({'place': (mesh.rank, mesh.data.rank, mesh.model.rank),
                    'loss': {k: float(v) for k, v in loss.items()},
                    'grads': {n: p.grad.cpu() for n, p in
                              step.model.named_parameters()}},
                   Path(tmp) / f'rank{rank}.pt')
    finally:
        torch.distributed.destroy_process_group()


def comm_record(log) -> dict:
    """A ``parallel.tensor.CommLog`` as {kind: calls, MB, ms}."""
    return {k: {'calls': log.calls[k], 'mb': log.bytes[k] / 1e6,
                'ms': log.seconds[k] * 1e3} for k in log.calls}


def gather_shards(ranks, key, layout_full):
    """Each parameter's full tensor from the ranks of one model group
    (``ranks`` in model-rank order): shards concatenated on dim 0."""
    import torch
    out = {}
    for n, full in layout_full.items():
        parts = [r[key][n] if not isinstance(r[key], tuple) else r[key][1][n]
                 for r in ranks]
        out[n] = (parts[0] if tuple(parts[0].shape) == tuple(full)
                  else torch.cat(parts))
    return out


def rank_share_conv_mm_ms(dev, batch, draws) -> float:
    """The device ms of the convolutions and matmuls in one bf16 train step
    of one rank's share of the model on ``TP_MESH`` (rank 0's slices), run
    alone in this process: the model axis's collectives are replaced by
    local copies (the values are meaningless, the shapes a rank's), so the
    other rank's kernels do not share the card's time with these."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from awsegbench_torch.core.mesh import (DataMesh, TPMesh,
                                            tp_param_shardings)
    from awsegbench_torch.models import create_model
    from awsegbench_torch.parallel import tensor
    from awsegbench_torch.train import optim
    from awsegbench_torch.train.step import TrainStep
    m = TP_MESH['model']
    mesh = TPMesh(DataMesh(), DataMesh(0, m, None, 'model'), 0, m)
    saved = (tensor._gather, tensor.all_reduce_, optim.all_reduce_)
    tensor._gather = lambda t, dim, mesh: torch.cat([t] * mesh.size, dim)
    tensor.all_reduce_ = optim.all_reduce_ = lambda t, mesh, op=None: t
    try:
        model = create_model(TRAIN_CFG, device=dev, seed=0)
        tensor.shard_model_(model, mesh, tp_param_shardings(
            model, mesh, TP_MIN_FEATURES))
        step = TrainStep(model, precision='bf16', device=dev, mesh=mesh)
        step(*batch, draws=draws)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(*batch, draws=draws)
            torch.cuda.synchronize()
        return conv_mm_device_ms(prof)
    finally:
        tensor._gather, tensor.all_reduce_, optim.all_reduce_ = saved
        torch.cuda.empty_cache()


def phase_tensor_parallel(dev):
    """The mesh's model axis (tensor parallelism, ``parallel/tensor.py``)
    on the card, with gloo ranks sharing it (spawned as ``phase_parallel``
    spawns them).

    1. ``{data: 1, model: 2}``, the main path's ensemble at full width (19
       classes, depth heads, faithful heads), sharded at
       ``tp_min_features`` 64: (a) the eval forward at 512×1024: f32 at
       ``TP_EVAL_F32_B`` rows against one process on the same weights
       within rtol 2e-4 and atol 2e-5, the argmax equal wherever one
       process's top two logits are not tied at that tolerance
       (``argmax_ties``); bf16 at batch 8 held against bf16's own error
       (its argmax agreement with the f32 one at most 0.1% below one
       process's), counted (K1 8, K2 1 a rank) and timed. (b)
       ``TrainStep`` on the train cell with bench.py's optimiser (clip
       1.0, AdamW), the global batch of 8 on both ranks in bf16 (counted:
       K1 8, K3 1, K6 8, K7–K10 1 each, the scatter 2 a rank) and
       ``TP_F32_B`` rows in f32, against one process: the losses within
       ``TP_LOSS_RTOL``; the clipped f32 gradients, shards concatenated,
       at the train parity tolerances (``grad_spread``, DeepLab within 0.1
       relative L2); the bf16 gradients per member within 1.5× (and 1e-3)
       the one-process bf16 gradient's relative L2 distance from the f32
       one of the same batch; the two ranks' replicated gradients
       bit-equal. (c) Bytes per rank of parameters, gradients and AdamW
       moments against one process (at most 0.51), and peak memory. (d)
       The model axis's collectives in that step (calls, MB and ms by
       kind, synchronised while recorded; gloo stages through the host,
       so they are the semantics' cost, not a scaling number) and the
       device time of the convolutions and matmuls: a rank's in that step
       (the other rank's kernels share the card), a rank's share run
       alone (``rank_share_conv_mm_ms``), and one process's.
    2. ``{data: 2, model: 2}``, four ranks: one f32 ``TrainStep`` at
       128×256, batch 4, against one process at the train parity
       tolerances: both subgroups on the card.
    Returns the launches of each rank's counted bf16 eval forward and
    train step."""
    import shutil
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile
    from awsegbench_torch.core.mesh import DataMesh

    t_phase = time.perf_counter()
    res = {'phase': 'tensor_parallel', 'nvidia_smi': nvidia_smi(),
           'mesh': TP_MESH, 'tp_min_features': TP_MIN_FEATURES,
           'eval_batch': {'bf16': B, 'fp32': TP_EVAL_F32_B},
           'train_batch': {'bf16': B, 'fp32': TP_F32_B},
           'hw': [H, W], 'backend': 'gloo (one card)'}
    inputs = {'bf16': parallel_train_inputs(dev, seed=43),
              'fp32': parallel_train_inputs(dev, b=TP_F32_B, seed=44),
              'small': parallel_train_inputs(dev, *TP_SMALL, seed=45)}
    one = {}
    for precision in ('bf16', 'fp32'):
        step = tp_step(dev, DataMesh(), precision)
        batch, draws = inputs[precision]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            loss = step(*batch, draws=draws)
            torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
        one[precision] = ({k: float(v) for k, v in loss.items()},
                          {n: p.grad.float().cpu()
                           for n, p in step.model.named_parameters()})
        if precision == 'bf16':
            res['1_process'] = {
                'bytes': state_bytes(step.model.parameters(),
                                     step.optimizer),
                'peak_mem_gib': torch.cuda.max_memory_allocated() / 2 ** 30,
                'conv_mm_device_ms': conv_mm_device_ms(prof),
                'bf16_first_step_ms_profiled': step_ms}
            shapes = {n: p.shape for n, p in step.model.named_parameters()}
        del step, prof
        torch.cuda.empty_cache()
    # the f32 gradients of the bf16 step's batch (bf16's own error) and of
    # the 2x2 mesh's
    f32 = {}
    for name in ('bf16', 'small'):
        step = tp_step(dev, DataMesh(), 'fp32')
        loss = step(*inputs[name][0], draws=inputs[name][1])
        f32[name] = ({k: float(v) for k, v in loss.items()},
                     {n: p.grad.cpu() for n, p in
                      step.model.named_parameters()})
        del step, loss
        torch.cuda.empty_cache()
    small = f32['small']
    from awsegbench_torch.models import create_model
    model = create_model(MODEL_CFG, device=dev, seed=0).eval().to(
        torch.bfloat16)
    xb = torch.randn((B, H, W, 3), generator=torch.Generator(
        device=dev).manual_seed(41), device=dev).to(torch.bfloat16)
    with torch.inference_mode():
        res['1_process']['bf16_eval_ms'] = time_ms(lambda: model(xb),
                                                   reps=3, warmup=1)
    del model, xb
    torch.cuda.empty_cache()
    res['rank_share_conv_mm_device_ms'] = rank_share_conv_mm_ms(
        dev, *inputs['bf16'])

    res['one_process_s'] = time.perf_counter() - t_phase
    tmp = tempfile.mkdtemp(prefix='awseg_tp_')
    try:
        torch.save(to_cpu(inputs), Path(tmp) / 'inputs.pt')
        t0 = time.perf_counter()
        ranks = run_ranks(tp_rank, 2, tmp, dev)
        res['two_rank_wall_s'] = time.perf_counter() - t0
        for r in range(2):
            (Path(tmp) / f'rank{r}.pt').unlink()
        t0 = time.perf_counter()
        fours = run_ranks(tp_small_rank, 4, tmp, dev)
        res['four_rank_wall_s'] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # Every check below adds to ``failed``; the phase's line is printed
    # first, then it raises if any check failed.
    failed = []
    r0, r1 = ranks

    # (a) eval
    if [r['place'] for r in ranks] != [(0, 0, 0), (1, 0, 1)]:
        failed.append(f'places {[r["place"] for r in ranks]}')
    for r in ranks:
        # an argmax may differ only where one process's top two logits are
        # tied at f32's resolution (``argmax_ties``)
        if max(r['f32_excess'].values()) > 0 or any(
                n for _, n in r['f32_argmax_ties'].values()):
            failed.append(f'f32 eval on rank {r["place"]}: excess over '
                          f'rtol 2e-4 + atol 2e-5 {r["f32_excess"]}, argmax '
                          f'(mismatches, untied) {r["f32_argmax_ties"]}')
        a = r['bf16_argmax_agreement']
        if a['tp_vs_f32'] < a['1_process_vs_f32'] - 1e-3:
            failed.append(f'bf16 argmax {a}')
        if (r['eval_launches']['sr_attention'],
                r['eval_launches']['seg_core']) != (8, 1):
            failed.append(f'a TP eval forward launched {r["eval_launches"]}')
        want = {'sr_attention': 8, 'splat_coverage_batched': 1,
                'sr_attention_backward': 8, 'seg_core_train': 1,
                'seg_core_train_backward': 1, 'd1_core_train': 1,
                'd1_core_train_backward': 1, 'neighbor_pp_adjoint': 2,
                'bn_train': TRAIN_BNS, 'bn_train_backward': TRAIN_BNS}
        got = {k: r['train_launches'][k] for k in want}
        if got != want:
            failed.append(f'a rank\'s train step launched {got}, expected '
                          f'{want}')

    # (b) the train step against one process
    for precision, (loss1, grads1) in one.items():
        for r in ranks:
            for k in ('total_loss', 'depth_loss'):
                if not abs(r[precision][0][k] - loss1[k]) <= TP_LOSS_RTOL \
                        * abs(loss1[k]):
                    failed.append(f'{precision} {k} {r[precision][0][k]}, '
                                  f'1 process {loss1[k]}')
        split = [n for n, g in r0[precision][1].items()
                 if tuple(g.shape) == tuple(shapes[n])
                 and not torch.equal(g, r1[precision][1][n])]
        if split:
            failed.append(f'{precision}: replicated leaves differ between '
                          f'the ranks: {split[:5]}')
        grads2 = gather_shards([r0, r1], precision, shapes)
        held, dl_rel, exact = grad_spread(
            grads2, grads1, f'tensor_parallel {precision}', hold=False)
        if precision == 'fp32' and (held > 2e-3 or dl_rel > 0.1):
            failed.append(f'f32 gradients: excess {held} of a leaf scale, '
                          f'DeepLab {dl_rel} relative L2')
        res[precision] = {'loss_1_process': loss1,
                          'loss_ranks': [r[precision][0] for r in ranks],
                          'grad_excess_over_rtol_per_leaf_scale': held,
                          'deeplab_grad_max_rel_l2': dl_rel,
                          'grads_bit_equal_share': exact}
        if precision == 'bf16':
            bf16_grads = grads2
    # bf16: each member's gradient as far from the f32 one of the same batch
    # as one process's bf16 gradient is, within 1.5× and 1e-3
    f32_grads = f32['bf16'][1]
    l2 = {'tp': member_l2(bf16_grads, f32_grads),
          '1_process': member_l2(one['bf16'][1], f32_grads)}
    res['bf16']['member_rel_l2_from_f32'] = l2
    for member, e1 in l2['1_process'].items():
        if l2['tp'][member] > 1.5 * e1 + 1e-3:
            failed.append(f'bf16 {member} gradients {l2} from the f32 ones')

    # (c) bytes and memory; (d) collectives and conv/matmul device time
    one_b = res['1_process']['bytes']
    res['rank_bytes'] = [r['bytes'] for r in ranks]
    res['rank_bytes_share'] = [
        {k: r['bytes'][k] / one_b[k] for k in one_b} for r in ranks]
    for sh in res['rank_bytes_share']:
        if max(sh.values()) > 0.51:
            failed.append(f'a rank holds {sh} of one process\'s bytes')
    res.update({
        'rank_peak_mem_gib': [r['peak_mem_gib'] for r in ranks],
        'rank_conv_mm_device_ms': [r['conv_mm_device_ms'] for r in ranks],
        'rank_bf16_step_ms': [r['bf16_step_ms'] for r in ranks],
        'rank_bf16_eval_ms': [r['bf16_eval_ms'] for r in ranks],
        'eval_f32_max_abs_err': [r['f32_max_abs_err'] for r in ranks],
        'eval_f32_excess': [r['f32_excess'] for r in ranks],
        'eval_f32_argmax_ties': [r['f32_argmax_ties'] for r in ranks],
        'bf16_argmax_agreement': [r['bf16_argmax_agreement']
                                  for r in ranks],
        'train_comm': [r['train_comm'] for r in ranks],
        'eval_launches': [r['eval_launches'] for r in ranks],
        'train_launches': [r['train_launches'] for r in ranks],
        'rank_seconds': [{k: r[k] for k in ('eval_f32_s', 'eval_s',
                                            'rank_s')} for r in ranks]})

    # 2. {data: 2, model: 2}
    if [f['place'] for f in fours] != [(0, 0, 0), (1, 0, 1), (2, 1, 0),
                                       (3, 1, 1)]:
        failed.append(f'4-rank places {[f["place"] for f in fours]}')
    for f in fours:
        for k in ('total_loss', 'depth_loss'):
            if not abs(f['loss'][k] - small[0][k]) <= 1e-4 * abs(small[0][k]):
                failed.append(f'4-rank {k} {f["loss"][k]}, one '
                              f'{small[0][k]}')
    grads4 = gather_shards(fours[:2], 'grads', shapes)
    held, dl_rel, exact = grad_spread(grads4, small[1],
                                      'tensor_parallel 2x2 f32', hold=False)
    if held > 2e-3 or dl_rel > 0.1:
        failed.append(f'2x2 f32 gradients: excess {held} of a leaf scale, '
                      f'DeepLab {dl_rel} relative L2')
    res['2x2_fp32'] = {'hw': list(TP_SMALL[:2]), 'batch': TP_SMALL[2],
                       'loss_1_process': small[0],
                       'loss_ranks': [f['loss'] for f in fours],
                       'grad_excess_over_rtol_per_leaf_scale': held,
                       'deeplab_grad_max_rel_l2': dl_rel}
    res['phase_wall_s'] = time.perf_counter() - t_phase
    res['failed'] = failed
    emit(res)
    if failed:
        raise AssertionError(f'tensor_parallel: {failed}')
    return ([r['eval_launches'] for r in ranks],
            [r['train_launches'] for r in ranks])


def main() -> int:
    try:
        import torch
    except ImportError:
        print('chip_smoke: torch is not installed', file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    if not (ROOT / 'awsegbench_torch' / 'csrc').is_dir():
        print('chip_smoke: awsegbench_torch/ is not beside this script',
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from awsegbench_torch import _build

    torch.backends.cuda.matmul.allow_tf32 = False     # f32 parity phases
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)
    smi = nvidia_smi()
    t0 = time.perf_counter()
    build_s = _build.build_all()
    build_wall_s = time.perf_counter() - t0
    # the loader's native host library (g++, before the CLIs time it)
    from awsegbench_torch import native
    t0 = time.perf_counter()
    native_ok = native.available()
    emit({'phase': 'device', 'nvidia_smi': smi,
          'name': torch.cuda.get_device_name(0),
          'count': torch.cuda.device_count(), 'torch': torch.__version__,
          'cuda': torch.version.cuda, 'build_seconds': build_s,
          'build_wall_seconds': build_wall_s,
          'native_host_library': native_ok,
          'native_build_seconds': time.perf_counter() - t0,
          'tf32': 'off for matmuls and cuDNN convs'})
    for name, (_, log) in _build.build_log.items():
        print(f'--- nvcc {name} ---\n{log}', file=sys.stderr)

    recs = phase_kernels(dev)
    emit({'phase': 'kernels', 'kernels': list(recs.values())})
    eval_launches = phase_main_path(dev)
    phase_parity(dev)
    train_recs = phase_train_kernels(dev)
    emit({'phase': 'train_kernels', 'kernels': list(train_recs.values())})
    train_launches = phase_train_path(dev)
    phase_train_parity(dev)
    single_recs, single_launches = phase_single_image(dev)
    evaluator_launches = phase_evaluator(dev)
    m2f_launches = phase_mask2former(dev)
    m2f_swin_launches = phase_mask2former_swin(dev)
    cli_train_launches, cli_evaluate_launches = phase_cli(dev)
    pretrained_launches = phase_pretrained(dev)
    remat_off_launches, remat_on_launches = phase_remat(dev)
    augment_launches = phase_weather_extras(dev)
    serving_launches = phase_serving(dev)
    (tiled_launches, tiled_sweep_launches, rank0_launches,
     rank1_launches) = phase_parallel(dev)
    tp_eval_launches, tp_train_launches = phase_tensor_parallel(dev)

    keys = ('name', 'route', 'source', 'replaces', 'launches', 'max_abs_err',
            'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms')
    # K1, K6: the exponential floor, device times (theirs and SDPA's); K2,
    # K7–K10: device time and the kron design's bound, K7–K10 the hash
    # floor, K8 and K10 their device time without dropout
    extra = ('design', 'device_ms', 'device_ms_rate0', 'library_device_ms',
             'exp_bound_ms', 'kron_bound_ms', 'hash_bound_ms', 'hash_ops',
             'by_hw', 'block', 'published_ms', 'by_stage')
    paths = {'eval': eval_launches, 'train': train_launches,
             'single_image': single_launches,
             'evaluator': evaluator_launches,
             'mask2former': m2f_launches,
             'mask2former_swin': m2f_swin_launches,
             'cli_train': cli_train_launches,
             'cli_evaluate': cli_evaluate_launches,
             'pretrained': pretrained_launches,
             'remat_off': remat_off_launches, 'remat_on': remat_on_launches,
             'weather_extras': augment_launches,
             'serving': serving_launches,
             'parallel_tiled_eval': tiled_launches,
             'parallel_tiled_sweep': tiled_sweep_launches,
             'parallel_train_rank0': rank0_launches,
             'parallel_train_rank1': rank1_launches,
             'tp_eval_rank0': tp_eval_launches[0],
             'tp_eval_rank1': tp_eval_launches[1],
             'tp_train_rank0': tp_train_launches[0],
             'tp_train_rank1': tp_train_launches[1]}
    # the path whose launches a kernel's record gives, where it is not
    # that of its phase: K11 serves Mask2Former's sweeps, K15 the Swin's
    served_by = {'ms_deform_attn': 'mask2former',
                 'window_attention': 'mask2former_swin'}
    summary = []
    for path, path_recs in (('eval', recs), ('train', train_recs),
                            ('single_image', single_recs)):
        for name, rec in path_recs.items():
            rec = dict(rec, launches=paths[served_by.get(name, path)][name])
            line = dict({k: rec.get(k) for k in keys},
                        launches_by_path={p: c[name]
                                          for p, c in paths.items()})
            line.update({k: rec[k] for k in extra if k in rec})
            if 'design' in rec:
                line['launches_by_design_by_path'] = {
                    p: c[f'{name}.by_design'] for p, c in paths.items()}
            summary.append(line)
    if len(summary) != 16:
        raise AssertionError(f'{len(summary)} kernels in the summary, not 16')
    # K15 is the Swin backbone's: its sweep launches it, no other path
    k15 = {p: c['window_attention'] for p, c in paths.items()}
    if k15['mask2former_swin'] <= 0 or any(
            k15[p] for p in paths if p != 'mask2former_swin'):
        raise AssertionError(f'K15 launches by path: {k15}')
    # K12 is eval BN: every eval path launches it, no train path
    k12 = {p: c['bn_act'] for p, c in paths.items()}
    if any(k12[p] <= 0 for p in EVAL_PATHS) or any(k12[p]
                                                    for p in TRAIN_PATHS):
        raise AssertionError(f'K12 launches by path: {k12}')
    # K13 and K14 are train BN: every train path launches them (the train
    # CLI too), no path that only evaluates
    for op in ('bn_train', 'bn_train_backward'):
        k13 = {p: c[op] for p, c in paths.items()}
        if any(k13[p] <= 0 for p in TRAIN_PATHS + ('cli_train',)) or any(
                k13[p] for p in paths
                if p not in TRAIN_PATHS + ('cli_train',)):
            raise AssertionError(f'{op} launches by path: {k13}')
    emit({'kernels': summary})
    print(smi, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
