"""PyTorch/CUDA port of ``stable_diffusion_webui_distributed_tpu``.

A second package beside the JAX one, which stays the reference the port is
held against. The layout mirrors the JAX package (``models/``, ``ops/``,
``runtime/``, ``samplers/``, ``pipeline/``, ``server/``) so each module's
counterpart is easy to find. The port imports ``torch``, numpy, pydantic,
PIL and the standard library, and nothing of JAX or of the JAX package.

Entry points (:class:`~.pipeline.engine.Engine`, the server, the CLI) run on
``cuda`` unless the caller passes ``device="cpu"``; with no device given and
no GPU present they raise.
"""
