"""dispatch_ms.train: the median host time from the call of the train
step to its return, with no synchronize inside, over the trace run's
untraced window."""

import statistics


def read(run):
    if run['kind'] != 'train' or not run['dispatch_ms']:
        return None
    return statistics.median(run['dispatch_ms'])
