"""Known-bad capture fixture: a closure the capture key does not name
(RC002).

Analyzed by tests/test_torch_lint.py as AST only, beside the port's
runtime/graphs.py — never imported, never run. Line numbers are asserted
exactly; edit with care.
"""
import functools

from stable_diffusion_webui_distributed_tpu_torch.runtime.graphs import (
    GraphCache,
)


class Engine:
    def __init__(self):
        self._graphs = GraphCache()

    def denoise(self, payload, x, binding, bucketer):
        scale = payload.cfg_scale
        steps = bucketer.bucket_steps(payload.steps)

        def guided(run, call, scalars):  # RC002: 'scale' is not in the key
            return call["x"] * scale

        def counted(n, run, call, scalars):  # RC002: partial binds 'steps'
            return call["x"] * n

        a = self._graphs.run(("guided",), "unet", guided, {}, {"x": x},
                             [0.5], binding).clone()
        b = self._graphs.run(("counted", 20), "unet",
                             functools.partial(counted, steps), {},
                             {"x": x}, [0.5], binding).clone()
        return a + b
