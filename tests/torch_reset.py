"""Both packages' process-wide observability state, put back to dormant.

ndtimeline's manager, telemetry, the alert engine, the time-series store,
the cost auditor and the active calibration table are module globals in
both packages.  A test file that leaves any of them live changes a later
file on the same xdist worker: with the JAX package's ndtimeline left
active, every reference ``BasicOptimizer.step`` and
``DistributedOptimizer.step`` reaches a ``jax.core`` call this jax does
not have, and raises.  So every port test file that runs a reference train
step or optimizer, and every observability test file, resets them around
each test: it imports ``reset_all`` or the two autouse fixtures below::

    from torch_reset import dormant_module, dormant_test  # noqa: F401

``dormant_module`` resets before the module's own module-scoped fixtures
run (pytest runs autouse fixtures first within a scope), ``dormant_test``
before and after every test.
"""

import pytest

from vescale_tpu import ndtimeline as ref_nd
from vescale_tpu import telemetry as ref_tel
from vescale_tpu.telemetry import alerts as ref_alerts
from vescale_tpu.telemetry import calibrate as ref_cal
from vescale_tpu.telemetry import costaudit as ref_ca
from vescale_tpu.telemetry import timeseries as ref_ts

from vescale_tpu_torch import ndtimeline as nd
from vescale_tpu_torch import telemetry as tel
from vescale_tpu_torch.telemetry import alerts, calibrate, costaudit, timeseries


def reset_all() -> None:
    """Both packages back to their dormant state."""
    for pkg_tel, pkg_nd, pkg_ca, pkg_al, pkg_ts, pkg_cal in (
            (ref_tel, ref_nd, ref_ca, ref_alerts, ref_ts, ref_cal),
            (tel, nd, costaudit, alerts, timeseries, calibrate)):
        pkg_tel.shutdown()
        pkg_ca.deactivate()
        pkg_al.deactivate()
        pkg_ts.deactivate()
        pkg_al.clear_fallback_warned()
        pkg_cal.reset_active()
        pkg_nd.api.deinit_ndtimers()


def all_dormant() -> bool:
    return not any((ref_tel.is_active(), tel.is_active(), ref_nd.api.is_active(),
                    nd.api.is_active(), ref_alerts.is_active(), alerts.is_active(),
                    ref_ts.is_active(), timeseries.is_active(), ref_ca.is_active(),
                    costaudit.is_active()))


@pytest.fixture(scope="module", autouse=True)
def dormant_module():
    reset_all()
    yield
    reset_all()


@pytest.fixture(autouse=True)
def dormant_test():
    reset_all()
    yield
    reset_all()
