"""The port's obs isolation fixture.

``tests/conftest.py`` resets only ``repro.obs``; the port keeps its own
registry, recorder, flight ring, SLO breach log and obs server
(``repro_torch.obs``). A test module that drives the port's instrumented
paths imports ``torch_obs_isolation`` (autouse): the port's build tally is
restored and its obs state torn down before and after every test, so a
test sees exactly what it emitted."""

import pytest

from repro_torch import obs
from repro_torch.core import tracecount


def _reset():
    obs.reset_operational()
    obs.reset_metrics()


@pytest.fixture(autouse=True)
def torch_obs_isolation():
    tally = tracecount.GLOBAL["traces"]
    _reset()
    yield
    tracecount.GLOBAL["traces"] = tally
    _reset()
