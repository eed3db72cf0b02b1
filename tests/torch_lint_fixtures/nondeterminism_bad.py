"""Known-bad capture fixture: host nondeterminism (TP001).

Analyzed by tests/test_torch_lint.py as AST only, beside the port's
runtime/graphs.py — never imported, never run. Line numbers are asserted
exactly; edit with care.
"""
import random
import time

import torch

from stable_diffusion_webui_distributed_tpu_torch.runtime.graphs import (
    GraphCache,
)

CACHE = GraphCache()


def stamped(run, call, scalars):
    return call["x"] * time.time()  # TP001: the capture's clock, replayed


def noisy(run, call, scalars):
    return call["x"] + torch.randn_like(call["x"])  # TP001: no generator


def jittered(run, call, scalars):
    return call["x"] * random.random()  # TP001: one host draw, replayed


def seeded(gen, run, call, scalars):
    # fine: a draw through an explicit generator
    return call["x"] + torch.randn(call["x"].shape, generator=gen)


def step(x, t, binding, gen):
    a = CACHE.run(("a",), "unet", stamped, {}, {"x": x}, [t], binding)
    x = a.clone()
    b = CACHE.run(("b",), "unet", noisy, {}, {"x": x}, [t], binding)
    x = b.clone()
    c = CACHE.run(("c",), "unet", jittered, {}, {"x": x}, [t], binding)
    x = c.clone()
    return CACHE.run(("d",), "unet", lambda *a: seeded(gen, *a), {},
                     {"x": x}, [t], binding)


def by_hand(model, static_x):
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_y = model(static_x) * time.perf_counter()  # TP001: region
    return graph, static_y
