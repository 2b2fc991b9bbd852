def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA sm_90 card (H100); skips without one")
