"""Pytest set-up for the benchmark's own tests: the checkout on sys.path and
the `cuda` marker of tests that need a card (they decide in a fixture)."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card (skips without one)")
