"""Host utilities of the port: logging setup."""

from noise_ec_tpu_torch.utils.logging import setup_logging

__all__ = ["setup_logging"]
