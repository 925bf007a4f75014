"""Compatibility shim: the metrics primitives moved to ``obs.metrics``.

Existing imports (``from noise_ec_tpu_torch.utils.metrics import Counters,
Timer``) keep working; new code should import from :mod:`noise_ec_tpu_torch.obs`
directly, where histograms and the labeled registry also live.
"""

from noise_ec_tpu_torch.obs.metrics import Counters, Histogram, Timer

__all__ = ["Counters", "Histogram", "Timer"]
