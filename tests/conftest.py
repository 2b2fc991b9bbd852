import os

# Smoke tests and benches must see exactly ONE device — the 512-device
# override belongs to launch/dryrun.py only (it sets XLA_FLAGS itself,
# before any jax import, in its own process).
os.environ.pop("XLA_FLAGS", None)

import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))  # for _hyp_compat


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running test (dry-runs, full sweeps)")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA sm_90 card (H100); skips without one")
