"""setup_s: seconds from the process's start to the window's start
(imports, the CUDA context, loading or building the kernels, the
inputs, the warm-up job)."""


def read(run):
    return run.setup_s
