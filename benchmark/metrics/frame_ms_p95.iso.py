"""frame_ms_p95.iso: the 95th percentile of every frame's latency in the
isovalue sweep's window, from its issue to its own sync, by the host
clock."""
from vrbench.harness import percentile


def read(run):
    return 1e3 * percentile(run.window.latencies, 95)
