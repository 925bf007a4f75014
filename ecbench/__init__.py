"""The benchmark of the PyTorch and CUDA port (``noise_ec_tpu_torch``):
see README.md."""
