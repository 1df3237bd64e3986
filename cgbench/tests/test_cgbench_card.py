"""A whole traced run on the card at a test size: the last line's
device figures come from the card's own events.  Needs a CUDA card:

    python -m pytest --noconftest -p no:cacheprovider -q \
        cgbench/tests/test_cgbench_card.py
"""

import dataclasses

import pytest
import torch

from cgbench import harness, spec

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on "
                    "the card")


@pytest.mark.parametrize("name", ["p2d2048-cg-f64-1000it",
                                  "p3d512-cg-f64-rtol1e-6"])
def test_traced_run_on_the_card(card, name):
    c = spec.load_cell(name)
    n = 256 if c.config["dim"] == 2 else 64
    cell = dataclasses.replace(c, config=dict(c.config, n=n))
    out = harness.run(cell, 2 ** 31 + 11, 1.0, True, device="cuda")
    line = harness.result_line(out, True)
    assert line["correct"] is True
    dev = line["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert dev["platform"] == "gpu" and dev["memory_peak_bytes"] > 0
    assert line["metrics"] and line["breakdown"]["device_ops"]
