"""Share of the traced window, in %, in which no kernel, copy or fill ran
on the card (the union of device work from the profiler's trace)."""


def read(run):
    if run.device is None or not run.device["busy_s"]:
        return None
    return 100.0 * (1.0 - run.device["busy_s"] / run.device["window_s"])
