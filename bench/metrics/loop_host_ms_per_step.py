"""Host milliseconds a step spent enqueueing the chunked loop's chunks in the
window: the sum of ``ChunkResult.host_s`` over the window's steps."""


def read(run):
    if not run.get("steps"):
        return None
    return run["host_s"] / run["steps"] * 1e3
