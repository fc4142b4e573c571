"""The train step on the card launches without waiting for it.

From the parameter cast to the AdamW update (``trainer.train_step``: cast →
train-mode forward → loss → backward → clip → AdamW) no call may make the
host synchronise with the card: under ``torch.cuda.set_sync_debug_mode
('error')`` a synchronising call raises. A wait there drains the queue, and
the card then idles while the host launches the next layers. The step's
batch preparation (``TrainStep._prepare``, its blocking copies in) stays
outside the check.

Needs a card: marked ``card`` and skipped without one. Run on the card with
``python -m pytest --noconftest -m card tests/test_torch_host_syncs.py``.
This file imports no JAX.
"""

import pytest
import torch

from awsegbench_torch.models import create_model
from awsegbench_torch.train.step import TrainStep
from awsegbench_torch.train.trainer import train_step

B, H, W, C = 2, 64, 128, 5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda', 0)


@pytest.mark.card
def test_train_step_never_waits_for_the_card(card):
    model = create_model({'type': 'ensemble', 'num_classes': C,
                          'include_depth': True}, device=card, seed=0)
    step = TrainStep(model, device=card)
    g = torch.Generator(card).manual_seed(0)
    images = torch.randint(0, 256, (B, H, W, 3), generator=g, device=card,
                           dtype=torch.uint8)
    labels = torch.randint(0, C, (B, H, W), generator=g, device=card)
    weather_ids = torch.tensor([1, 2], device=card)
    for _ in range(2):                  # kernels built, constants made
        step(images, labels, weather_ids, generator=g)
    loss_fn, image, targets, fog, seeds, aspp_mask = step._prepare(
        images, labels, weather_ids, g, {}, None, False)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        loss = train_step(step.model, step.optimizer, loss_fn, step.policy,
                          image, targets, fog, seeds.pop('seed'), aspp_mask,
                          g, seeds, mesh=step.mesh)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(loss['total_loss'])
