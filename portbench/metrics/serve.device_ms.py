"""Device ms per request of the served program
(``serving.py::ServingModel.predict``: the copy in, the exported graph's
operations and the custom ops K1 and K2)."""

from portbench.common.read import span_ms


def read(ctx):
    return span_ms(ctx, 'serve.predict')
