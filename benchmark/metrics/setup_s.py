"""Process start to the first timed request: interpreter, torch, the CUDA
context, building or loading the kernels, the frames, the warm-up."""


def read(run):
    return run.setup_s
