"""Executors over the engine's stages (:mod:`.stage_graph`)."""
