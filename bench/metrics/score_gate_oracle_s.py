"""Seconds the build's gate spent in the numpy oracle (``DaisProgram.run``):
``BuiltEngine.timings["gate_oracle_s"]`` from ``verify_engine``, passed on
by the family with the build's other timings."""


def read(run):
    return (run.get("build_s") or {}).get("gate_oracle_s")
