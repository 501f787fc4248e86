"""idle_share.serve: the share of the traced requests' window in which no
kernel, copy or memset ran on the card."""


def read(run):
    if run['kind'] != 'serve':
        return None
    s = run['summary']
    return 100.0 * (1.0 - s['busy_s'] / s['window_s'])
