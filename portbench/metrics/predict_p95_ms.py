"""Serving tail: the 95th percentile over all requests of the window, from
the start of a request's upload to its detections on the host."""

import statistics


def read(run):
    if run.entry != "serve" or len(run.latencies_s) < 2:
        return None
    return statistics.quantiles(run.latencies_s, n=20,
                                method="inclusive")[18] * 1e3
