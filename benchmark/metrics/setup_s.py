"""Set-up, from the start of the process to the start of the measured
window: imports, the kernel library (built in the first run of a
checkout), the mask, preprocessing, the operand ring, captures, warm-up."""


def read(run):
    return run.setup_s or None
