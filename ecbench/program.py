"""What the program under test declares, for readers of counters it may
lack: a checkout from before a family existed reads such a metric as
nothing (None), where the registry would refuse the undeclared name."""

from __future__ import annotations


def declared(specs: dict) -> dict:
    """The entries of a reader's ``COUNTERS`` (``key: (type, family,
    labels, attribute)``) whose family the port's registry declares."""
    from noise_ec_tpu_torch.obs.registry import METRICS

    return {key: spec for key, spec in specs.items()
            if METRICS.get(spec[1], ("",))[0] == spec[0]}
