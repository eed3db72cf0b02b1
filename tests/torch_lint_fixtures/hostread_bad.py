"""Known-bad capture fixture: host reads of a tensor (TP002).

Analyzed by tests/test_torch_lint.py as AST only, beside the port's
runtime/graphs.py — never imported, never run. Line numbers are asserted
exactly; edit with care.
"""
import torch

from stable_diffusion_webui_distributed_tpu_torch.runtime.graphs import (
    GraphCache,
)


class Evaluator:
    def __init__(self):
        self.graphs = GraphCache()

    def _branchy(self, run, call, scalars):
        if scalars[0] > 0.5:  # TP002: a branch on a tensor's value
            return call["x"]
        return -call["x"]

    def _synced(self, run, call, scalars):
        t = scalars[0].item()  # TP002: .item() waits inside the capture
        return call["x"] * t

    def _gated(self, run, call, scalars):
        if "mask" in run:  # fine: the input dict's keys are the key's
            return call["x"] * run["mask"]
        if run.get("bias") is not None:  # fine: a None check
            return call["x"] + run["bias"]
        if call["x"].shape[0] > 2:  # fine: a shape is a host fact
            return call["x"]
        return call["x"] * bool(scalars[1])  # TP002: bool() of a tensor

    def evaluate(self, kind, x, t, binding):
        fn = {"branchy": self._branchy, "synced": self._synced}.get(kind)
        if fn is None:
            return self.graphs.run(("gated",), "unet", self._gated, {},
                                   {"x": x}, [t, 1.0], binding)
        out = self.graphs.run(("branchy",), "unet", self._branchy, {},
                              {"x": x}, [t], binding).clone()
        return self.graphs.run(("synced",), "unet", self._synced, {},
                               {"x": out}, [t], binding)


def by_hand(fn, static_x):
    graph = torch.cuda.CUDAGraph()
    graph.capture_begin()
    static_y = fn(static_x)
    total = static_y.sum().tolist()  # TP002: a read back in the region
    graph.capture_end()
    return graph, static_y, total
