"""PyTorch/CUDA port of ``awsegbench`` for one NVIDIA H100.

The JAX package beside it stays the reference; this package mirrors its
module names (``ops/attention.py`` ↔ ``ops/attention.py`` and so on) and
keeps its public layouts (NHWC images, ``[G, N, D]`` attention) so the two
can be held against each other on the same inputs.

The TPU kernels on the eval and train paths are hand-written CUDA C++ in
``csrc/``, built with ``nvcc`` at first use (``_build.py``). Each wrapper
dispatches on the device of the tensor it is given: a CPU tensor goes to the
plain PyTorch version of the same function, a CUDA tensor launches the
kernel (or raises).

Entry points (``models.factory.create_model``, ``eval.step.EvalStep``,
``eval.evaluator.Evaluator``, ``train.step.TrainStep``,
``weather.corruption.corrupt_batch``) run on ``device='cuda'`` unless the
caller asks for ``device='cpu'``.
"""

from ._device import resolve_device

__all__ = ['resolve_device']
