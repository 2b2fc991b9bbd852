"""95th percentile, over every batch of the window, of the time from handing
the batch to ``ServeEngine.run`` to its outputs as host numpy (host clock)."""


def read(run):
    v = run.get("latency_p95_s")
    return None if v is None else v * 1e3
