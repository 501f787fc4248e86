"""idle_share.train: the share of the traced steps' window in which no
kernel, copy or memset ran on the card."""


def read(run):
    if run['kind'] != 'train':
        return None
    s = run['summary']
    return 100.0 * (1.0 - s['busy_s'] / s['window_s'])
