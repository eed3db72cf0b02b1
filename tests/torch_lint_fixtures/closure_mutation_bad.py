"""Known-bad capture fixture: mutation of closed-over state (TP003).

Analyzed by tests/test_torch_lint.py as AST only, beside the port's
runtime/graphs.py — never imported, never run. Line numbers are asserted
exactly; edit with care.
"""
from stable_diffusion_webui_distributed_tpu_torch.runtime.graphs import (
    GraphCache,
)

STATS = {"evaluations": 0}


def make_step(cache: GraphCache, binding):
    history = {}
    calls = 0

    def evaluate(run, call, scalars):
        nonlocal calls
        calls += 1  # TP003: counts the capture, never a replay
        history["last"] = scalars  # TP003: closed-over dict
        STATS["evaluations"] += 1  # TP003: module state
        out = {"y": call["x"] * 2}
        out["scale"] = scalars[:1]  # fine: a local of the body
        return out["y"]

    def step(x, t):
        return cache.run(("unet",), "unet", evaluate, {}, {"x": x}, [t],
                         binding)

    return step
