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
   mode and must match bit for bit; K1's bf16 output must also lie within
   a bf16 step of f32 math on its inputs), plus K1 and K2 at a few ragged
   shapes off the path; median times of the kernel, the plain version and,
   for attention, ``F.scaled_dot_product_attention`` (a yardstick only;
   the port never calls it).
3. main path: the faithful SegFormer-B0 + DeepLabV3+ (ResNet-50) ensemble
   eval step at 512×1024, bf16, batch 8, mixed weather 0–4: 2 warm-up and
   5 timed batches; images/s, and each kernel's launch count in that run
   (every count must be > 0); the confusion-matrix total must equal the
   count of non-ignored pixels and the depth sum must be finite.
   Then where a step's time goes: each layer (corruption, the two
   members, the confusion matrix) timed alone, and device time by kernel
   over one profiled step.
4. parity: at batch 1 in f32, the corruption and the ensemble forward on
   the card (through the kernels) against the same on the CPU (where every
   wrapper takes its plain version): uint8 images within one step with
   99.9% exact, logits within 2e-3.

TF32 is switched off for matmuls and cuDNN convs throughout, so the f32
comparisons compare f32 arithmetic. Before the last line it prints the
``{"kernels": [...]}`` summary and the card's ``nvidia-smi`` name and power
limit; the last line is ``{"ok": true, "device": {...}}``. Any failed
check raises, and the script exits non-zero.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H, W, B = 512, 1024, 8
BF16_PEAK, F32_PEAK, HBM_BW = 989e12, 67e12, 3.35e12   # H100 SXM data sheet
MODEL_CFG = {'type': 'ensemble', 'num_classes': 19, 'include_depth': True,
             'head_mode': 'faithful'}


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


def phase_kernels(dev):
    """K1–K3 against their plain versions; returns the kernels' records."""
    import torch
    import torch.nn.functional as F
    from awsegbench_torch.ops import attention, headkernels, splat
    from awsegbench_torch.weather.corruption import draw_corruption

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
        # The kernel's bf16 mode is f32 math between a bf16 load and a bf16
        # store, so it must sit within half a bf16 step (at most 2^-8 of the
        # value) of the f32 plain version on the same bf16 inputs; checked
        # at twice that, a limit that scales with the data.
        want = attention.sr_attention_plain(q.float(), k.float(), v.float(),
                                            dd ** -0.5)
        check_close(f'sr_attention bf16 vs f32 math {gg}x{n}x{mm}x{dd}', got,
                    want, 2 ** -7, 1e-5)
        return q32, k32, v32, errs

    errs = {torch.float32: 0.0, torch.bfloat16: 0.0}
    ms = plain_ms = lib_ms = bound_ms = 0.0
    flops_all = bytes_all = 0.0
    for gg, n in stages:
        q32, k32, v32, e = check_k1(gg, n, m, d)
        errs = {dt: max(errs[dt], e[dt]) for dt in errs}
        q, k, v = (t.bfloat16() for t in (q32, k32, v32))
        ms += 2 * time_ms(lambda: attention.sr_attention(q, k, v, d ** -0.5))
        plain_ms += 2 * time_ms(
            lambda: attention.sr_attention_plain(q, k, v, d ** -0.5), reps=5)
        q4, k4, v4 = q[None], k[None], v[None]
        lib_ms += 2 * time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, scale=d ** -0.5))
        flops, nbytes = 4.0 * gg * n * m * d, 2.0 * (2 * gg * n * d + 2 * gg * m * d)
        bound_ms += 2 * bound(flops, nbytes, BF16_PEAK)[0]
        flops_all += 2 * flops
        bytes_all += 2 * nbytes
    recs['sr_attention'] = dict(
        name='sr_attention', route='cuda',
        source='awsegbench_torch/csrc/sr_attention.cu',
        replaces='awsegbench/ops/attention.py:36',
        max_abs_err=errs[torch.bfloat16], ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound(flops_all, bytes_all, BF16_PEAK)[1],
        library_ms=lib_ms, max_abs_err_f32=errs[torch.float32])

    # K1 off the main path's shapes: ragged q, K/V tiles and key chunks,
    # and head_dim 64 (MiT-b1..b5)
    for shape in ((3, 130, 70, 64), (2, 100, 33, 32)):
        check_k1(*shape)

    # K2: the seg head core at f [b, H/32, W/32, 256] → [b, H, W, 19]
    h, w, c, nc, r = H // 32, W // 32, 256, 19, 32

    def seg_inputs(b, dt):
        P = (randn(b, h, w, 9, c) * 0.5).to(dt)
        return (P, 1.0 + 0.1 * randn(c), 0.1 * randn(c),
                (randn(c, nc) / 16).to(dt), 0.1 * randn(nc))

    errs = {}
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 6e-2)):
        args = seg_inputs(2, dt)
        got = headkernels.seg_core(*args, r)
        want = headkernels.seg_core_plain(*args, r)
        torch.cuda.synchronize()
        if got.shape != (2, h * r, w * r, nc):
            raise AssertionError(f'seg_core shape {tuple(got.shape)}')
        check_close(f'seg_core {dt}', got, want, tol)
        errs[str(dt)] = max_err(got, want)
    for shape, rr in (((1, 3, 5, 9, 32), 32), ((2, 2, 3, 9, 48), 8)):
        Pq = randn(*shape) * 0.5           # off the main path's shapes
        cq = shape[-1]
        small = (Pq, 1.0 + 0.1 * randn(cq), 0.1 * randn(cq),
                 randn(cq, nc) / 16, 0.1 * randn(nc))
        check_close(f'seg_core f32 {shape} r{rr}',
                    headkernels.seg_core(*small, rr),
                    headkernels.seg_core_plain(*small, rr), 1e-4)
    args = seg_inputs(B, torch.bfloat16)           # the main path's batch
    check_close('seg_core bf16 b8', headkernels.seg_core(*args, r),
                headkernels.seg_core_plain(*args, r), 6e-2)
    pix = B * h * r * w * r
    flops = pix * (2 * 9 * 9 * c / r + 2 * 9 * c + 2 * c * nc)
    nbytes = args[0].numel() * 2 + c * nc * 2 + pix * nc * 2
    bms, by = bound(flops, nbytes, BF16_PEAK)
    recs['seg_core'] = dict(
        name='seg_core', route='cuda', source='awsegbench_torch/csrc/seg_head.cu',
        replaces='awsegbench/ops/headkernels.py:156',
        max_abs_err=errs[str(torch.bfloat16)],
        ms=time_ms(lambda: headkernels.seg_core(*args, r)),
        plain_ms=time_ms(lambda: headkernels.seg_core_plain(*args, r), reps=3,
                         warmup=1),
        bound_ms=bms, bound_by=by, library_ms=None,
        max_abs_err_f32=errs[str(torch.float32)], gflop=flops / 1e9)

    # K3: 8 mixed rain/snow images at 512×1024 with full drop counts
    wid = torch.tensor([2, 3] * (B // 2), device=dev)
    dr = draw_corruption(wid, H, W, g)
    rain = (wid == 2)[:, None]
    params = splat.pack_params(
        torch.where(rain, dr['rain_ax'], dr['snow_x']),
        torch.where(rain, dr['rain_ay'], dr['snow_y']),
        torch.where(rain, dr['rain_bx'], dr['snow_x']),
        torch.where(rain, dr['rain_by'], dr['snow_y']),
        torch.where(rain, dr['rain_radius'], dr['snow_radius']),
        torch.where(rain, True, torch.arange(500, device=dev)[None] < 200))
    got = splat.splat_coverage_batched(params, H, W)
    want = splat.splat_coverage_plain(params, H, W)
    torch.cuda.synchronize()
    if not torch.equal(got, want) or not got.any():
        raise AssertionError(f'splat: masks differ in '
                             f'{int((got != want).sum())} pixels')
    # hit tests the kernel runs: the inflated, clipped box of each valid drop
    lo_x = (torch.minimum(params[..., 0], params[..., 2]) - params[..., 4]).floor() - 1
    hi_x = (torch.maximum(params[..., 0], params[..., 2]) + params[..., 4]).ceil() + 1
    lo_y = (torch.minimum(params[..., 1], params[..., 3]) - params[..., 4]).floor() - 1
    hi_y = (torch.maximum(params[..., 1], params[..., 3]) + params[..., 4]).ceil() + 1
    area = ((hi_x.clamp(max=W - 1) - lo_x.clamp(min=0) + 1)
            * (hi_y.clamp(max=H - 1) - lo_y.clamp(min=0) + 1))
    n_tests = float((area * (params[..., 5] > 0)).sum())
    bms, by = bound(20 * n_tests, B * H * W * 4 + params.numel() * 4, F32_PEAK)
    recs['splat_coverage_batched'] = dict(
        name='splat_coverage_batched', route='cuda',
        source='awsegbench_torch/csrc/splat.cu',
        replaces='awsegbench/ops/splat.py:216', max_abs_err=0.0,
        ms=time_ms(lambda: splat.splat_coverage_batched(params, H, W)),
        plain_ms=time_ms(lambda: splat.splat_coverage_plain(params, H, W),
                         reps=3, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=None,
        covered=float(got.mean()))
    return recs


def phase_main_path(dev):
    import torch
    from awsegbench_torch.eval.step import EvalStep
    from awsegbench_torch.models import count_parameters, create_model
    from awsegbench_torch.ops import attention, headkernels, splat

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
    torch.cuda.synchronize()
    counters = (attention.sr_attention, headkernels.seg_core,
                splat.splat_coverage_batched)
    for fn in counters:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    for batch in batches[:2]:
        step(*batch, generator=g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches[2:]:
        step(*batch, generator=g)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    if min(launches.values()) <= 0:
        raise AssertionError(f'a kernel of the path never launched: {launches}')
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
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
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(*batch, generator=g)
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
    emit({'phase': 'layers', 'batch': B, 'dtype': str(step.dtype),
          'layer_ms': layer_ms, 'profiled_step_wall_ms': wall_ms,
          'device_busy_ms': busy_ms, 'device_busy_share': busy_ms / wall_ms,
          'top_kernels_ms_count': [[k, ms, n] for k, (ms, n) in top]})


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
    launches = phase_main_path(dev)
    phase_parity(dev)

    keys = ('name', 'route', 'source', 'replaces', 'launches', 'max_abs_err',
            'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms')
    emit({'kernels': [{k: dict(rec, launches=launches[name]).get(k)
                       for k in keys} for name, rec in recs.items()]})
    print(smi, flush=True)
    emit({'ok': True, 'device': {'platform': 'gpu',
                                 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
