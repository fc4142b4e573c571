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
   plus K1 and K2 at a few ragged shapes off the path; median times of the
   kernel, the plain version and, for attention,
   ``F.scaled_dot_product_attention`` (a yardstick only; the port never
   calls it). K1 and K6 also get the exponential floor
   (``exp_bound_ms``: one ex2 per score on the special-function unit) and
   device times by the profiler, theirs and SDPA's (``device_ms``,
   ``library_device_ms``: ``ms`` less the host's time to launch them);
   K3–K5 get the device time of every device op of one call.
3. main path: the faithful SegFormer-B0 + DeepLabV3+ (ResNet-50) ensemble
   eval step at 512×1024, bf16, batch 8, mixed weather 0–4: 2 warm-up and
   5 timed batches; images/s, and each kernel's launch count in that run
   (every count must be > 0, and K1's bf16 calls must have gone through
   its tensor-core design); the confusion-matrix total must equal the
   count of non-ignored pixels and the depth sum must be finite.
   Then where a step's time goes: each layer (corruption, the two
   members, the confusion matrix) timed alone, and device time by kernel
   over one profiled step.
4. parity: at batch 1 in f32, the corruption and the ensemble forward on
   the card (through the kernels) against the same on the CPU (where every
   wrapper takes its plain version): uint8 images within one step with
   99.9% exact, logits within 2e-3.
5. train kernels: K6 (the attention backward, through ``autograd.grad``
   of the K1/K6 Function), K7 and K8 (the train seg head's core, K8 also
   through the Function's backward), K9 and K10 (the train depth head's
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
   (``neighbor_pp_adjoint``) is bit-equal to its plain version.
6. train path: ``TrainStep`` on bench.py's train configuration, the
   faithful ensemble with depth heads, at 512×1024, bf16 compute, batch 8,
   mixed weather 0–4, clip 1.0 and AdamW(1e-3, decay 1e-4): 2 warm-up and
   5 timed steps; images/s, peak memory, the launches of K1, K3 and K6–K10
   in that run (each must be > 0, K1's and K6's through their tensor-core
   design); the losses (the depth loss included)
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

TF32 is switched off for matmuls and cuDNN convs throughout, so the f32
comparisons compare f32 arithmetic. Before the last line it prints the
``{"kernels": [...]}`` summary of all eleven kernels (the ten TPU
kernels' counterparts and the scatter; each kernel's ``launches`` from the
path it serves: K1–K3 from the eval path, K6–K10 and the scatter from the
train path, K4 and K5 from the single-image path, every path's counts
(the evaluator's too) under ``launches_by_path``; the kernels with two
designs add their ``design`` per dtype and their per-design counts per
path) and the card's ``nvidia-smi`` name and power limit; the last line
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
    """K1–K3 against their plain versions; returns the kernels' records."""
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
    n_valid = sum(int((lab != 255).sum()) for _, lab, _ in batches)
    cm_total = int(step.cm.sum())
    if cm_total != n_valid:
        raise AssertionError(f'confusion matrix holds {cm_total} pixels, '
                             f'expected {n_valid}')
    dsum = float(step.dsum)
    if not torch.isfinite(step.dsum):
        raise AssertionError(f'depth sum is not finite: {dsum}')
    emit({'phase': 'main_path', 'images_per_s': 5 * B / dt,
          'step_ms': dt / 5 * 1e3, 'batch': B, 'hw': [H, W],
          'dtype': 'bfloat16', 'params': count_parameters(step.model),
          'launches': launches, 'cm_total': cm_total, 'depth_sum': dsum,
          'peak_mem_gib': torch.cuda.max_memory_allocated() / 2 ** 30})
    phase_layers(step, batches[0], g)
    del step, model
    torch.cuda.empty_cache()
    return launches


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
    (through the kernels) against the same on the CPU, where every wrapper
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

    # K6 through autograd.grad of the K1/K6 Function, against plain
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
    return recs


def seg_train_kernels(dev, g):
    """K7 (both designs) and K8 (the train seg head's core, K8 also through
    the Function's backward) against their plain versions at the path's
    P [b, 16, 32, 9, 256], r = 32, nc = 19, and at SEG_RAGGED; K7 as K2 is
    held (SEG_TOLS). K8 through the Function's backward (dP incl. the plain
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
    (K10, also through the Function's backward), bf16 within 6e-2 of the
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


EVAL_COUNTERS = ('sr_attention', 'seg_core', 'splat_coverage_batched')
# The attention wrappers' designs, by the dtype they take (ops/attention.py);
# the paths run bf16, so their launches (and those of K2 and K7–K10) must
# all go through 'mma_bf16'.
ATTENTION_DESIGNS = {'bfloat16': 'mma_bf16', 'float32': 'simt_f32'}
TRAIN_COUNTERS = ('sr_attention', 'splat_coverage_batched',
                  'sr_attention_backward', 'seg_core_train',
                  'seg_core_train_backward', 'd1_core_train',
                  'd1_core_train_backward', 'neighbor_pp_adjoint')
SINGLE_COUNTERS = ('splat_coverage_windowed', 'splat_coverage_tiled')
# K5's shapes: Cityscapes' height × width, then the same pixels upright
K5_SHAPES = ((1024, 2048), (2048, 1024))


def counters():
    """Every kernel wrapper's launch counter, by name."""
    from awsegbench_torch.ops import attention, headkernels, splat
    from awsegbench_torch.ops import depthkernels_train as dk
    from awsegbench_torch.ops import headkernels_train as ht
    return {fn.__name__: fn for fn in (
        attention.sr_attention, headkernels.seg_core,
        splat.splat_coverage_batched, splat.splat_coverage_windowed,
        splat.splat_coverage_tiled, attention.sr_attention_backward,
        ht.seg_core_train, ht.seg_core_train_backward, dk.d1_core_train,
        dk.d1_core_train_backward, ht.neighbor_pp_adjoint)}


def run_counted(run, needed, what):
    """Every launch counter (and per-design count) set to 0, ``run()``, the
    counts read after it (all of them, by name; the per-design ones as
    ``<name>.by_design``); raises if a kernel in ``needed`` never launched,
    or if a needed wrapper with two designs (K1, K2, K6–K10) launched its
    bf16 design ('mma_bf16') no time or its f32 design at all: the paths
    run in bf16."""
    import torch
    fns = counters()
    torch.cuda.synchronize()
    for fn in fns.values():
        fn.launches = 0
        by = getattr(fn, 'launches_by_design', {})
        by.update(dict.fromkeys(by, 0))
    out = run()
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in fns.items()}
    launches.update({f'{name}.by_design': dict(fn.launches_by_design)
                     for name, fn in fns.items()
                     if hasattr(fn, 'launches_by_design')})
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


def check_sweep(what, ev, res, loader, exact):
    """Every schema key present and finite; each weather's confusion
    matrix holds that weather's non-ignored pixels; the ECE bins and the
    AUROC histogram hold every non-ignored pixel."""
    import torch
    if set(res) != schema_keys(exact) or not all(
            math.isfinite(v) for v in res.values()):
        raise AssertionError(f'{what}: result keys or values: {res}')
    n_valid = torch.zeros(5, dtype=torch.int64)
    for b in loader:
        valid = (b['label'] != 255).sum(dim=(1, 2)).cpu()
        n_valid.index_add_(0, b['weather_id'].cpu().long(), valid)
    acc = ev.last_acc
    if not (torch.equal(acc['cm'].sum(dim=(1, 2)), n_valid)
            and int(acc['ece'][..., 0].sum()) == int(n_valid.sum())
            and int(acc['auroc_hist'].sum()) == int(n_valid.sum())):
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
    emit({'phase': 'device', 'nvidia_smi': smi,
          'name': torch.cuda.get_device_name(0),
          'count': torch.cuda.device_count(), 'torch': torch.__version__,
          'cuda': torch.version.cuda, 'build_seconds': build_s,
          'build_wall_seconds': time.perf_counter() - t0,
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

    keys = ('name', 'route', 'source', 'replaces', 'launches', 'max_abs_err',
            'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms')
    # K1, K6: the exponential floor, device times (theirs and SDPA's); K2,
    # K7–K10: device time and the kron design's bound, K7–K10 the hash
    # floor, K8 and K10 their device time without dropout
    extra = ('design', 'device_ms', 'device_ms_rate0', 'library_device_ms',
             'exp_bound_ms', 'kron_bound_ms', 'hash_bound_ms', 'hash_ops',
             'by_hw')
    paths = {'eval': eval_launches, 'train': train_launches,
             'single_image': single_launches,
             'evaluator': evaluator_launches}
    summary = []
    for path, path_recs in (('eval', recs), ('train', train_recs),
                            ('single_image', single_recs)):
        for name, rec in path_recs.items():
            rec = dict(rec, launches=paths[path][name])
            line = dict({k: rec.get(k) for k in keys},
                        launches_by_path={p: c[name]
                                          for p, c in paths.items()})
            line.update({k: rec[k] for k in extra if k in rec})
            if 'design' in rec:
                line['launches_by_design_by_path'] = {
                    p: c[f'{name}.by_design'] for p, c in paths.items()}
            summary.append(line)
    if len(summary) != 11:
        raise AssertionError(f'{len(summary)} kernels in the summary, not 11')
    emit({'kernels': summary})
    print(smi, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
