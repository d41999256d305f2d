"""The 95th percentile of the alert latency where the standing workload has
no reach query: from the handing of each batch to each event's results on
the host, over every event of the window."""
import numpy as np


def read(ctx):
    if not ctx.alert_ms:
        return None
    return float(np.percentile(ctx.alert_ms, 95))
