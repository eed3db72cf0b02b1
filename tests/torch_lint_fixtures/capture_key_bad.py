"""Known-bad capture fixture: a request-derived capture key (RC001).

Analyzed by tests/test_torch_lint.py as AST only, beside the port's
runtime/graphs.py — never imported, never run. Line numbers are asserted
exactly; edit with care.
"""
from stable_diffusion_webui_distributed_tpu_torch.runtime.graphs import (
    GraphCache,
)


def _unet(run, call, scalars):
    return call["x"] * scalars[:1]


class Server:
    def __init__(self):
        self.graphs = GraphCache()

    def render(self, payload, x, binding):
        tag = ("unet", payload.steps)
        return self.graphs.run(tag, "unet", _unet, {}, {"x": x},  # RC001
                               [0.5], binding)  # (a capture per step count)

    def render_bucketed(self, payload, x, binding, bucketer):
        # fine: the ladder bounds the key space
        tag = ("unet", bucketer.bucket_batch(payload.steps))
        return self.graphs.run(tag, "unet", _unet, {}, {"x": x}, [0.5],
                               binding)


def wrapper(graphs: GraphCache, tag, x, binding):
    # a wrapper passes its tag on: what its callers pass is a key too
    return graphs.run(tag, "unet", _unet, {}, {"x": x}, [0.5], binding)


def serve(payload, graphs: GraphCache, x, binding):
    return wrapper(graphs, ("w", payload.width), x, binding)  # RC001
