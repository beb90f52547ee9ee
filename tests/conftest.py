"""Test harness configuration.

Runs the whole suite on CPU with 8 virtual devices so the distributed
(mesh/shard_map) paths are unit-testable on a single host — the gap the
reference leaves open (its unit binary is single-process; multi-rank
coverage only via MPI example programs, SURVEY.md §4).
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from _cpu_backend import force_cpu  # noqa: E402

force_cpu(8)

import jax  # noqa: E402

# persistent compilation cache makes repeated test runs cheap (eager setup
# ops compile one XLA executable per shape bucket)
jax.config.update("jax_compilation_cache_dir", "/tmp/amgx_tpu_jax_cache")
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_enable_xla_caches",
                  "xla_gpu_per_fusion_autotune_cache_dir")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavyweight tests excluded from the tier-1 budgeted run "
        "(`-m 'not slow'`); run them with `-m slow` on a capable rig")
    config.addinivalue_line(
        "markers",
        "card: needs the CUDA card (skips without one); run on the card "
        "as tests/test_torch_card.py says")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
