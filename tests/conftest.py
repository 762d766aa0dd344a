import os
import sys

# Tests run on the single real CPU device (the 512-device env var is set
# ONLY inside launch/dryrun.py and the dry-run subprocess tests).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; the test skips without one")
