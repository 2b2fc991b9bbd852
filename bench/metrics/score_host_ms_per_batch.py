"""Host milliseconds a batch spent inside ``ServeEngine.run`` in the window
(the call's return, before the outputs are read)."""


def read(run):
    h = run.get("host_s")
    if not run.get("batches") or not isinstance(h, list):
        return None
    return sum(h) / len(h) * 1e3
