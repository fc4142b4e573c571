"""Domain-adaptation weather augmentation (counterpart of
``awsegbench/weather/augmentation.py``): a weather at its fixed intensity,
then, with probability ``style_transfer_prob``, a per-weather "style
transfer" (cv2.convertScaleAbs contrast and brightness, and a tint of
channel 2 for rain and night).

The draws come from an explicit ``torch.Generator`` on the image's device:
the weather (uniform over ``weather_intensities``' keys) and whether to
style. The weather is chosen on the host, since each weather is another
path (rain and snow launch the single-image splat kernel, K4 up to 1 Mpx
and K5 above); that reads one value back from the card per image.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .corruption import apply_weather_effect

DEFAULT_INTENSITIES = {'fog': 0.7, 'rain': 0.5, 'snow': 0.6, 'night': 0.8}


def convert_scale_abs(image_u8: torch.Tensor, alpha: float,
                      beta: float) -> torch.Tensor:
    """cv2.convertScaleAbs: saturate_cast<uint8>(round(|alpha·x + beta|)),
    rounding half to even as ``jnp.round``."""
    y = torch.abs(alpha * image_u8.to(torch.float32) + beta)
    return torch.clamp(torch.round(y), 0, 255).to(torch.uint8)


def _tint_channel2(image_u8: torch.Tensor, factor: float) -> torch.Tensor:
    b = torch.clamp(image_u8[..., 2].to(torch.float32) * factor, 0, 255)
    return torch.cat([image_u8[..., :2], b.to(torch.uint8)[..., None]], -1)


def style_transfer(image_u8: torch.Tensor, weather_type: str) -> torch.Tensor:
    """The per-weather colour-space shift (loader.py:360-387) on uint8
    [..., 3]; any other weather returns the image."""
    if weather_type == 'fog':
        return convert_scale_abs(image_u8, 0.8, 30)
    if weather_type == 'rain':
        return _tint_channel2(convert_scale_abs(image_u8, 1.2, -10), 1.1)
    if weather_type == 'snow':
        return convert_scale_abs(image_u8, 0.9, 20)
    if weather_type == 'night':
        return _tint_channel2(convert_scale_abs(image_u8, 0.4, -20), 1.3)
    return image_u8


class WeatherAugmentationPipeline:
    """The reference class's public surface (loader.py:296-358)."""

    def __init__(self,
                 weather_intensities: Optional[Dict[str, float]] = None,
                 style_transfer_prob: float = 0.3,
                 **kwargs) -> None:
        self.weather_intensities = weather_intensities or dict(DEFAULT_INTENSITIES)
        self.style_transfer_prob = style_transfer_prob

    def apply_domain_adaptation_augmentation(
            self, image_u8: torch.Tensor, generator: torch.Generator,
            target_weather: Optional[str] = None) -> torch.Tensor:
        """One uint8 image [H, W, 3] corrupted at the weather's fixed
        intensity (``target_weather``, else one drawn uniformly), then
        style-transferred with probability ``style_transfer_prob``; on the
        image's device, all draws from ``generator`` (on that device)."""
        dev = image_u8.device
        names = list(self.weather_intensities)
        pick = torch.randint(len(names), (), generator=generator, device=dev)
        do_style = torch.rand((), generator=generator, device=dev) \
            < self.style_transfer_prob
        name = target_weather or names[int(pick)]
        aug = apply_weather_effect(image_u8, name, generator=generator,
                                   intensity=self.weather_intensities[name])
        return torch.where(do_style, style_transfer(aug, name), aug)
