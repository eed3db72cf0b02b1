"""Known-bad capture fixture: a tensor of the capture escapes (TP004).

Analyzed by tests/test_torch_lint.py as AST only, beside the port's
runtime/graphs.py — never imported, never run. Line numbers are asserted
exactly; edit with care.
"""
import torch

from stable_diffusion_webui_distributed_tpu_torch.runtime.graphs import (
    GraphCache,
)


class Denoiser:
    def __init__(self):
        self.graphs = GraphCache()
        self.last = None
        self.history = []
        self.shape = None

    def _eval(self, run, call, scalars):
        out = call["x"] * scalars[:1]
        self.last = out  # TP004: the pool's tensor, kept on self
        self.history.append(torch.zeros(4))  # TP004: made in the capture
        self.shape = out.shape  # fine: a shape is a host fact
        return out

    def step(self, x, t, binding):
        return self.graphs.run(("unet",), "unet", self._eval, {}, {"x": x},
                               [t], binding)
