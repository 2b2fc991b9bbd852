"""Seconds of the set-up's chunks that captured a CUDA graph (their
``ChunkResult.dt_s`` where ``compiled``)."""


def read(run):
    return run.get("capture_s")
