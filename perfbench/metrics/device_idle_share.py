"""device_idle_share: the share of the traced window in which no
kernel, copy or fill ran on the card (``torch.profiler``'s CUDA
activity)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 1.0 - run.trace.busy_s / run.trace.window_s
