"""Test configuration.

x64 is enabled so the fp64 sparse-Cholesky path matches the paper's CPU
baselines bit-closely; model/kernel code pins its own dtypes (f32/bf16)
explicitly, so this does not change their behaviour.

NOTE: XLA_FLAGS / device-count tricks are deliberately NOT set here — smoke
tests and benches must see the single real CPU device.  Only
launch/dryrun.py forces 512 placeholder devices (in its own process).
"""
import jax

jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips with a reason without one")
