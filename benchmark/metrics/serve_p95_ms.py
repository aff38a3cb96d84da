"""``serve_p95_ms``: the 95th percentile (numpy's linear rule) of every
request of the window, each timed from the hand-over of its host image to
its scores on the host."""

import numpy as np


def read(run, name):
    if run["kind"] != "serve" or not run["latencies_s"]:
        return None
    return float(np.percentile(np.asarray(run["latencies_s"]), 95)) * 1e3
