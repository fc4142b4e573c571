"""One driver per kind of timed path: ``sweep`` (``Evaluator.run``),
``train`` (``TrainStep``), ``serve`` (``ServingModel.predict``).

A driver module holds ``Driver(config, traffic, seed, device, traced)``
with ``setup()`` (inputs and weights from the seed, the program built and
warmed up; spans set when ``traced``), ``window(seconds=…)`` or
``window(iterations=…)`` (the timed window; returns its end-to-end
metrics), ``trace_context(trace)`` (what the per-layer readers read),
``check(limits)`` (the numbers compared with the plain reference, each
with its limit) and ``control()`` (the same numbers for the reference fed
fp8 operands in the program's place), and the counts ``attempted`` and
``failed`` and the ``notes`` a run prints to standard error; and
``FAULTS``, the names of the faults (``faults.py``) that its cells can
have, each of which must make ``correct`` false. The sweep runs any model
type with an adapter (``portbench/models/``); the train and serve drivers
run the ensemble and refuse any other type when constructed."""
