"""The port's example twins (``examples/*_torch.py``) run on the host.

Each twin of a reference example (``quickstart.py``, ``sparse_solver.py``,
``moe_dispatch.py``, ``serve_lm.py``) runs with ``--device cpu`` in a
process of its own and must exit 0 after its own checks (each asserts its
results and prints a closing ✓ line); without ``--device`` it runs on the
card, so with no card it must refuse.
"""
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = {"quickstart_torch.py": "warm plan cache: hit=True",
            "sparse_solver_torch.py": "solved ✓",
            "moe_dispatch_torch.py": "warm hit=True",
            "serve_lm_torch.py": "served 4 sequences ✓"}


def _run(name, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, os.path.join(ROOT, "examples",
                                                        name), *args],
                          capture_output=True, text=True, env=env,
                          timeout=300)


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_runs_on_the_host(name):
    r = _run(name, "--device", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    assert EXAMPLES[name] in r.stdout


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_defaults_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = _run(name)
    assert r.returncode != 0
    assert "device='cpu'" in r.stderr
