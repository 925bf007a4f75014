"""Logging setup: leveled, stderr-forced, like the reference's glog.

Port of ``noise_ec_tpu.utils.logging``; the root logger is the port's
(``noise_ec_tpu_torch``), which every module of the port logs under.

The reference forces ``logtostderr`` programmatically before flag parsing
(main.go:118) and logs through glog's Infof/Errorf. ``setup_logging`` gives
the same shape — leveled stderr lines with timestamps — via stdlib logging.
"""

from __future__ import annotations

import logging
import sys

__all__ = ["setup_logging"]


def setup_logging(level: int = logging.INFO) -> logging.Logger:
    root = logging.getLogger("noise_ec_tpu_torch")
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter(
                "%(levelname).1s%(asctime)s %(name)s] %(message)s",
                datefmt="%m%d %H:%M:%S",
            )
        )
        root.addHandler(handler)
    root.setLevel(level)
    return root
