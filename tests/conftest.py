"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests must see 1 CPU device
(only launch/dryrun.py fakes 512).  Multi-device tests run in subprocesses.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax
import numpy as np
import pytest

from repro.core.types import RouterConfig


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cache: GreenCache prefix-KV / semantic caching tests "
        "(run the subset with -m cache)")
    config.addinivalue_line(
        "markers",
        "disagg: disaggregated prefill/decode serving tests — migration "
        "correctness, fault injection, unified equivalence "
        "(run the subset with -m disagg)")
    config.addinivalue_line(
        "markers",
        "costmodel: predictive energy cost model tests — analytic prior, "
        "RLS calibration, governor reconciliation, admission planner "
        "(run the subset with -m costmodel)")
    config.addinivalue_line(
        "markers",
        "scenario: scenario-lab tests — generator determinism, closed-loop "
        "GreenServ-vs-random economics, flash-crowd liveness, pool-churn "
        "durability (run the subset with -m scenario)")
    config.addinivalue_line(
        "markers",
        "fleet: fleet subsystem tests — device-resident router state "
        "(zero-transfer routing), sharded pool all-reduce, heartbeat "
        "fail-over, fleet checkpointing (run the subset with -m fleet)")
    config.addinivalue_line(
        "markers",
        "chaos: reliability-layer tests — deadlines/retries, per-arm "
        "circuit breakers, fault injection, governor charge hygiene "
        "under failure (run the subset with -m chaos)")
    config.addinivalue_line(
        "markers",
        "port: PyTorch port parity tests (run the subset with -m port)")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture()
def router_config():
    return RouterConfig(lam=0.4, max_arms=24, energy_scale_wh=0.3)


@pytest.fixture(scope="session")
def prng():
    return jax.random.PRNGKey(0)
