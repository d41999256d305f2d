"""The 95th percentile, over every subscription event of the window, of the
time from the handing of the due batch to that event's results on the host
(the subscription's callback, which fires after the results' host copies)."""
import numpy as np


def read(ctx):
    if not ctx.alert_ms:
        return None
    return float(np.percentile(ctx.alert_ms, 95))
