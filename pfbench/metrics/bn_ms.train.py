"""bn_ms.train: device ms a traced step of the kernels in the 'batch
norm' category (forward and backward)."""


def read(run):
    if run['kind'] != 'train':
        return None
    seconds = run['summary']['category_s'].get('batch norm')
    return None if seconds is None else 1e3 * seconds / run['units']
