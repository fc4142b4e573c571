"""Batched mixed-weather corruption (counterpart of the fused
``corrupt_batch`` path of ``awsegbench/weather/corruption.py``).

The JAX function draws from per-sample ``jax.random`` keys and corrupts in
one program. Its streams cannot be reproduced with torch, so the port splits
it in two:

* :func:`draw_corruption` draws everything the JAX path draws (fog intensity
  and noise, the rain/snow splat parameters, snow's 3/7 blur choice, the
  night factor and noise) from an explicit ``torch.Generator``, with the
  same distributions;
* :func:`apply_corruption` is deterministic given those draws, and follows
  ``_corrupt_batch_fused`` operation by operation: fog scattering over a
  synthetic depth, one shared rain/snow splat pass (the ``ops/splat.py``
  kernel), the blur bank, night, then the final select and uint8
  truncation.

:func:`corrupt_batch` composes the two. Tests hand JAX's draws to
``apply_corruption`` and compare with the JAX output.
"""

from __future__ import annotations

import torch

from .._device import const, resolve_device
from ..ops.filters import gaussian_blur_cv, gaussian_filter_scipy
from ..ops.splat import pack_params, splat_coverage_batched

WEATHER_CONDITIONS = ('clean', 'fog', 'rain', 'snow', 'night')
WEATHER_IDS = {name: i for i, name in enumerate(WEATHER_CONDITIONS)}

# Parameter tables (reference preprocessing.py:33-57).
FOG_PARAMS = {'beta_range': (0.005, 0.05), 'A_range': (0.7, 1.0), 'depth_scale': 100.0}
RAIN_PARAMS = {
    'intensity_range': (0.1, 0.8),
    'drop_size_values': (1, 3),     # a choice over the 2-tuple (1, 3)
    'angle_range': (-15.0, 15.0),
    'num_drops_range': (100, 500),
    'length_range': (5, 20),        # randint(5, 20)
    'color': (0.8, 0.9, 1.0),
}
SNOW_PARAMS = {
    'intensity_range': (0.1, 0.7),
    'flake_size_values': (2, 8),    # a choice over the 2-tuple (2, 8)
    'num_flakes_range': (50, 200),
    'blur_kernel_values': (3, 7),
}
NIGHT_PARAMS = {
    'brightness_reduction': (0.2, 0.6),
    'color_shift': (0.8, 0.85, 1.2),
    'noise_std': 5.0,
}
# Per-call intensity ranges when none is given (preprocessing.py:108,128,173,207).
DEFAULT_INTENSITY = {
    'fog': (0.3, 0.9),
    'rain': (0.2, 0.8),
    'snow': (0.2, 0.7),
    'night': (0.4, 0.8),
}

MAX_RAIN_DROPS = 500
MAX_SNOW_FLAKES = 200


def quantize_uint8(x: torch.Tensor) -> torch.Tensor:
    """(clip(x, 0, 1) * 255).astype(uint8): truncation, like numpy."""
    return (torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)


def _uniform(lo, hi, shape, g, dev):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)


def draw_corruption(weather_ids: torch.Tensor, h: int, w: int,
                    generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Every random draw of the fused corruption, for a batch of B images.

    As the JAX path, every sample gets every weather's draws (the select
    happens in :func:`apply_corruption`). The generator must live on
    ``weather_ids``' device. Returns float32 tensors (bool for masks):
    intensities ``[B]``, fog noise ``[B, H, W]``, rain/snow drops
    ``[B, 500]``, night noise ``[B, H, W, 3]``.
    """
    g, dev = generator, weather_ids.device
    b = weather_ids.shape[0]
    d: dict[str, torch.Tensor] = {}

    d['fog_intensity'] = _uniform(*DEFAULT_INTENSITY['fog'], (b,), g, dev)
    d['fog_noise'] = torch.randn((b, h, w), generator=g, device=dev) * 10.0

    # rain (_rain_splat_params): num_drops = int(100 + i·400) valid slots
    i = _uniform(*DEFAULT_INTENSITY['rain'], (b,), g, dev)
    n = MAX_RAIN_DROPS
    x = torch.randint(0, w, (b, n), generator=g, device=dev).float()
    y = torch.randint(0, h, (b, n), generator=g, device=dev).float()
    length = torch.randint(*RAIN_PARAMS['length_range'], (b, n), generator=g,
                           device=dev).float()
    t0, t1 = RAIN_PARAMS['drop_size_values']
    thick = torch.where(torch.rand((b, n), generator=g, device=dev) < 0.5,
                        float(t1), float(t0))
    angle = _uniform(*RAIN_PARAMS['angle_range'], (b, n), g, dev)
    rad = torch.deg2rad(angle)
    lo, hi = RAIN_PARAMS['num_drops_range']
    num = (lo + i * (hi - lo)).to(torch.int32)
    d.update(rain_intensity=i, rain_ax=x, rain_ay=y,
             rain_bx=torch.clamp(torch.trunc(x + length * torch.sin(rad)), 0, w - 1),
             rain_by=torch.clamp(torch.trunc(y + length * torch.cos(rad)), 0, h - 1),
             rain_radius=thick / 2.0,
             rain_valid=torch.arange(n, device=dev)[None] < num[:, None])

    # snow (_snow_splat_params): circles, padded to MAX_RAIN_DROPS slots
    i = _uniform(*DEFAULT_INTENSITY['snow'], (b,), g, dev)
    n = MAX_SNOW_FLAKES
    pad = MAX_RAIN_DROPS - n
    x = torch.randint(0, w, (b, n), generator=g, device=dev).float()
    y = torch.randint(0, h, (b, n), generator=g, device=dev).float()
    s0, s1 = SNOW_PARAMS['flake_size_values']
    size = torch.where(torch.rand((b, n), generator=g, device=dev) < 0.5,
                       float(s1), float(s0))
    lo, hi = SNOW_PARAMS['num_flakes_range']
    num = (lo + i * (hi - lo)).to(torch.int32)
    padf = torch.nn.functional.pad
    d.update(snow_intensity=i, snow_x=padf(x, (0, pad)),
             snow_y=padf(y, (0, pad)), snow_radius=padf(size, (0, pad)),
             snow_valid=torch.arange(MAX_RAIN_DROPS, device=dev)[None]
             < num[:, None],
             snow_use7=torch.rand((b,), generator=g, device=dev) < 0.5)

    # night
    i = _uniform(*DEFAULT_INTENSITY['night'], (b,), g, dev)
    d['night_intensity'] = i
    d['night_brightness'] = 1.0 - i * _uniform(
        *NIGHT_PARAMS['brightness_reduction'], (b,), g, dev)
    d['night_noise'] = torch.randn((b, h, w, 3), generator=g, device=dev) * (
        NIGHT_PARAMS['noise_std'] / 255.0)
    return d


def apply_corruption(images: torch.Tensor, weather_ids: torch.Tensor,
                     draws: dict[str, torch.Tensor]) -> torch.Tensor:
    """Deterministic part of the fused corruption.

    images [B, H, W, 3] uint8, weather_ids [B] in [0, 5) → [B, H, W, 3]
    uint8. Clean samples are returned untouched.
    """
    b, h, w, _ = images.shape
    dev = images.device
    img_f = images.to(torch.float32) / 255.0
    wid = weather_ids.to(dev)
    col = lambda v: v.reshape(b, 1, 1, 1)   # noqa: E731  per-sample scalar

    # fog: I·t + A·(1 − t), t = exp(−β·depth), synthetic depth
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] / h
    depth = gaussian_filter_scipy(
        (yy * FOG_PARAMS['depth_scale'] + draws['fog_noise'])[..., None],
        sigma=2.0)[..., 0]
    depth = torch.clamp(depth, min=1.0)
    i_fog = draws['fog_intensity']
    beta_min, beta_max = FOG_PARAMS['beta_range']
    a_min, a_max = FOG_PARAMS['A_range']
    beta = (beta_min + i_fog * (beta_max - beta_min))[:, None, None]
    a = col(a_min + i_fog * (a_max - a_min))
    transmission = torch.exp(-beta * depth)[..., None]
    fog_out = img_f * transmission + a * (1.0 - transmission)

    # rain/snow: one shared splat pass
    is_rain = wid == WEATHER_IDS['rain']
    is_snow = wid == WEATHER_IDS['snow']
    sel = is_rain[:, None]
    params = pack_params(
        torch.where(sel, draws['rain_ax'], draws['snow_x']),
        torch.where(sel, draws['rain_ay'], draws['snow_y']),
        torch.where(sel, draws['rain_bx'], draws['snow_x']),
        torch.where(sel, draws['rain_by'], draws['snow_y']),
        torch.where(sel, draws['rain_radius'], draws['snow_radius']),
        torch.where(sel, draws['rain_valid'],
                    draws['snow_valid'] & is_snow[:, None]))
    cov = splat_coverage_batched(params, h, w) > 0.5

    haze = col(draws['rain_intensity'] * 0.3)
    base_rain = img_f * (1.0 - haze) + haze * 0.7
    base_snow = torch.clamp(img_f + col(draws['snow_intensity'] * 0.2),
                            0.0, 1.0)
    rain4 = col(is_rain)
    base_splat = torch.where(rain4, base_rain, base_snow)
    color = torch.where(rain4, const(tuple, RAIN_PARAMS['color'], device=dev),
                        torch.ones(3, device=dev))
    splatted = torch.where(cov[..., None], color, base_splat)

    # shared blur bank
    blur3_05 = gaussian_blur_cv(splatted, ksize=3, sigma=0.5)
    blur3_1 = gaussian_blur_cv(splatted, ksize=3, sigma=1.0)
    blur7_1 = gaussian_blur_cv(splatted, ksize=7, sigma=1.0)
    snow_blur = torch.where(col(draws['snow_use7']), blur7_1, blur3_1)
    rainsnow_out = torch.where(rain4, blur3_05, snow_blur)

    # night
    shift = const(tuple, NIGHT_PARAMS['color_shift'], device=dev)
    night_out = (img_f * col(draws['night_brightness'])) * shift + \
        draws['night_noise'] * col(draws['night_intensity'] * 0.5)

    widb = col(wid)
    out_f = torch.where(widb == WEATHER_IDS['fog'], fog_out,
                        torch.where(col(is_rain | is_snow), rainsnow_out,
                                    night_out))
    return torch.where(widb == 0, images, quantize_uint8(out_f))


def corrupt_batch(images: torch.Tensor, weather_ids: torch.Tensor,
                  generator: torch.Generator,
                  device: str | torch.device = 'cuda') -> torch.Tensor:
    """Corrupt a mixed-weather batch: images [B, H, W, 3] uint8, weather_ids
    [B] in [0, 5) → [B, H, W, 3] uint8 on ``device``. ``generator`` must
    live on ``device``."""
    dev = resolve_device(device)
    images, weather_ids = images.to(dev), weather_ids.to(dev)
    draws = draw_corruption(weather_ids, images.shape[1], images.shape[2],
                            generator)
    return apply_corruption(images, weather_ids, draws)

