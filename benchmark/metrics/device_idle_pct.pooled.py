"""device_idle_pct.pooled: the share of the pooled orbit's traced window in
which no kernel, copy or fill ran on the card."""


def read(run):
    t = run.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s)
