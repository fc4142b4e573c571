"""Faults planted in the port's timed path, for the tests and for the
readings that set a cell's limits: each must make ``correct`` false. Each
driver names the faults its cells can have (``drivers/<kind>.py``'s
``FAULTS``); this module plants them.

* ``unchanged``: the step returns its state unchanged (the sweep's
  ``accumulate`` adds nothing; the train step's optimiser moves nothing).
* ``half_batch``: half of each batch is left out and the mean taken over
  the rest (the sweep accumulates the first half of the rows; the train
  step's forward, loss and backward see the first half).
* ``altered``: an answer is altered where it is produced (the model's
  logits of each batch's first row come out 1.5 times too large: the
  sweep's confidences, the train step's loss and a served request's
  logits are wrong). The model is the class of the port's model that the
  configuration builds (``common/port.py::skeleton``).

One card runs each cell, so no fault of the exchange between cards
applies.
"""

from __future__ import annotations

import contextlib
import functools


def _alter_first_row(out):
    out = dict(out)
    seg = out['segmentation'].clone()
    seg[0] = seg[0] * 1.5
    out['segmentation'] = seg
    return out


def _patches(name: str, config):
    """(object, attribute, replacement) of the fault ``name`` in a run of
    ``config``."""
    from awsegbench_torch.eval.evaluator import Evaluator
    from awsegbench_torch.serving import ServingModel
    from awsegbench_torch.train import optim, step
    if name == 'unchanged':
        return [(Evaluator, 'accumulate', lambda self, *a, **k: None),
                (optim.Optimizer, 'step', lambda self: None)]
    if name == 'half_batch':
        accumulate, train_step = Evaluator.accumulate, step.train_step

        def acc_half(self, acc, outputs, labels, weather_ids,
                     sample_mask=None):
            h = max(1, labels.shape[0] // 2)
            return accumulate(self, acc, {k: v[:h] for k, v in
                                          outputs.items()},
                              labels[:h], weather_ids[:h], sample_mask)

        def step_half(model, optimizer, loss_fn, policy, image, targets,
                      fog, seed, aspp_mask=None, *args, **kwargs):
            h = max(1, image.shape[0] // 2)
            return train_step(model, optimizer, loss_fn, policy, image[:h],
                              {k: v[:h] for k, v in targets.items()},
                              None if fog is None else fog[:h], seed,
                              None if aspp_mask is None else aspp_mask[:h],
                              *args, **kwargs)
        return [(Evaluator, 'accumulate', acc_half),
                (step, 'train_step', step_half)]
    if name == 'altered':
        from .common.port import skeleton
        model_class = type(skeleton(config))
        forward, predict = model_class.forward, ServingModel.predict

        @functools.wraps(forward)           # the train step reads its keywords
        def forward_altered(self, *a, **k):
            return _alter_first_row(forward(self, *a, **k))

        @functools.wraps(predict)
        def predict_altered(self, *a, **k):
            return _alter_first_row(predict(self, *a, **k))
        return [(model_class, 'forward', forward_altered),
                (ServingModel, 'predict', predict_altered)]
    raise ValueError(f'unknown fault {name!r}')


@contextlib.contextmanager
def planted(name: str | None, config):
    """Plants the fault ``name`` (None: none) in the port, for a run of the
    configuration ``config``, while entered."""
    if name is None:
        yield
        return
    patches = _patches(name, config)
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    for obj, attr, fn in patches:
        setattr(obj, attr, fn)
    try:
        yield
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
