"""setup_s: seconds from the start of the process to the window:
loading, data made on the device, the kernels built or loaded, warm-up."""


def read(run):
    return run.setup_s
