def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'cuda: needs a CUDA card; skips without one')
    config.addinivalue_line(
        'markers', 'slow: minutes on the CPU; deselected from tier-1')
