"""dispatch_ms.serve: the median host time from the call of the served
forward to its return, before the synchronize that ends the request, over
the trace run's untraced window."""

import statistics


def read(run):
    if run['kind'] != 'serve' or not run['dispatch_ms']:
        return None
    return statistics.median(run['dispatch_ms'])
