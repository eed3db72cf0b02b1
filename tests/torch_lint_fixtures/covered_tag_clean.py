"""Clean capture fixture: the engine's covered-tag pattern.

The engine's tags (``pipeline/engine.py`` ``_make_denoise_fn``) carry the
precision's flags and the ids of the ControlNet modules its closures read;
the closures are captured through wrappers (``graphed`` -> ``one`` ->
``GraphCache.run``) with ``functools.partial`` and a lambda. Analyzed by
tests/test_torch_lint.py as AST only, beside the port's
runtime/graphs.py — never imported, never run: zero findings.
"""
import functools

import torch

from stable_diffusion_webui_distributed_tpu_torch.runtime.graphs import (
    GraphCache,
)


class Engine:
    def __init__(self, unet, bucketer):
        self.unet = unet
        self.bucketer = bucketer
        self._graphs = GraphCache()

    def denoise_fn(self, payload, modules, binding):
        prec = self.bucketer.bucket_precision(payload.precision)
        width = self.bucketer.bucket_shape(payload.width)

        def residuals(active, run, call, scalars):
            rs = None
            for k in active:
                r = modules[k](call["x"], scalars[:1], run["ctx"])
                rs = r if rs is None else [a + b for a, b in zip(rs, r)]
            return rs

        def evaluate(active, run, call, scalars):
            if "inpaint" in run:
                call = dict(call, x=torch.cat([call["x"], run["inpaint"]]))
            return self.unet(call["x"], scalars[:1], run["ctx"],
                             residuals(active, run, call, scalars),
                             precision=prec, width=width)

        def one(tag, fn, run, call, scalars):
            return self._graphs.run(tag, "unet", fn, run, call, scalars,
                                    binding)

        def graphed(tag, fn, run, call, scalars):
            return one(tag, functools.partial(fn, 0), run, call, scalars)

        def denoise(x, t, active, run):
            tag = ("unet", prec.flags, width,
                   tuple((k, id(modules[k])) for k in active))
            out = graphed(tag, lambda r, *a: evaluate(active, *a), run,
                          {"x": x}, [t])
            return out.float()

        return denoise
