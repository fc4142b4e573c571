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
caller asks for ``device='cpu'``. Importing the package or any of its
subpackages builds no kernel; the top-level names below are imported on
first use.

The package exports the JAX package's top-level names; its
``_JAX_AVAILABLE`` and ``_TORCH_AVAILABLE`` flags have no counterpart
(the port needs torch and has no stand-in classes).
"""

from ._device import resolve_device

# The top-level names are imported on first use, so a process that loads a
# serving artifact (``serving.py``) imports the kernel ops and not the
# models, losses or trainer.
_LAZY = {
    "SegFormerModel": ".models.segformer",
    "DeepLabV3PlusModel": ".models.deeplab",
    "EnsembleModel": ".models.ensemble",
    "FogDensityAwareLoss": ".losses.fog_density",
    "AdverseWeatherTrainer": ".train.trainer",
    "RobustnessMetrics": ".metrics.robustness",
    "Config": ".utils.config",
}

__all__ = [*_LAZY, "resolve_device"]


def __getattr__(name: str):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
