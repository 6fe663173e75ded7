"""call_ms_p95: the 95th percentile of the wall time of every call of the
window, from its start to its synchronise (statistics.quantiles, the
exclusive method)."""
import statistics


def read(w):
    if len(w.calls) < 2:
        return None
    times = [(end - start) * 1e3 for start, end in w.calls]
    return statistics.quantiles(times, n=20)[18]
