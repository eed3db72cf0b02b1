"""Known-bad capture fixture: a replay's output read after the next
replay (DN001).

Analyzed by tests/test_torch_lint.py as AST only, beside the port's
runtime/graphs.py — never imported, never run. Line numbers are asserted
exactly; edit with care.
"""
from stable_diffusion_webui_distributed_tpu_torch.runtime.graphs import (
    GraphCache,
)


def _unet(run, call, scalars):
    return call["x"] * scalars[:1]


def two_evaluations(cache: GraphCache, x, binding):
    uncond = cache.run(("u",), "unet", _unet, {}, {"x": x}, [0.1], binding)
    cond = cache.run(("c",), "unet", _unet, {}, {"x": x}, [0.2], binding)
    return uncond + cond  # DN001: the second replay may overwrite uncond


def loop_carried(cache: GraphCache, x, binding):
    prev = cache.run(("s",), "unet", _unet, {}, {"x": x}, [0.3], binding)
    for t in (0.2, 0.1):
        cur = cache.run(("s",), "unet", _unet, {}, {"x": x}, [t], binding)
        x = cur - prev  # DN001: cur's replay may overwrite prev
        prev = cur  # an alias of cur: dead after the next iteration's run
    return x


def consumed_ok(cache: GraphCache, x, binding):
    # fine: each output is cloned (or read) before the next replay, and
    # passing it into the next replay reads it before the replay runs
    first = cache.run(("u",), "unet", _unet, {}, {"x": x}, [0.1], binding)
    kept = first.clone()
    second = cache.run(("c",), "unet", _unet, {}, {"x": first}, [0.2],
                       binding)
    return kept + second
