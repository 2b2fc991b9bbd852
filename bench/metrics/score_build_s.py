"""Seconds the program took to lower the model (the benchmark's span around
``core/lower.lower``) and to build and gate its engine
(``BuiltEngine.timings``: ``compile_s`` and ``gate_s``)."""


def read(run):
    t = run.get("build_s")
    if not t:
        return None
    return t["lower_s"] + t.get("compile_s", 0.0) + t.get("gate_s", 0.0)
