"""One adapter per model type the port's factory builds:
``models/<type>.py``, found by a configuration's ``model.type``
(``adapter``). Its plain reference is built by
``reference/builders/<type>.py`` (``reference/model.py``), which the
adapter never supplies, so the reference cannot come from the port. A new
type adds those two files and edits none. An adapter holds:

* ``skeleton(config)``: the port's model on the meta device
  (``common/port.py::build`` loads the weights into it);
* ``OUTPUTS``: the logits the sweep compares with the reference;
  ``MEMBERS``: the two members' logits whose disagreement the sweep
  accumulates, or ``()`` for a single model;
* ``sizes(model)``: the configuration file's size sections as the built
  model has them, and ``model``'s ``num_classes``;
* ``forward_flops(config, height, width)``: one image's forward FLOPs;
* ``spans(model)``: the ``(object, method, span name)`` triples the sweep
  sets on the built model when traced.

An initialisation the model needs (a leaf set to fixed values) is made by
the type's own code on both sides: in its ``skeleton`` and in its
reference builder."""

from __future__ import annotations

import importlib
from typing import Any, Mapping


def adapter(config: Mapping[str, Any]):
    """The adapter module ``portbench/models/<model.type>.py``."""
    kind = config['model']['type']
    name = f'{__name__}.{kind}'
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        raise ModuleNotFoundError(
            f'no adapter for model type {kind!r}: add '
            f'portbench/models/{kind}.py', name=name) from None
