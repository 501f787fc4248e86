"""serve_mfu: the served forward's conv and dense operations per second
(counted from the configuration's layer list) over the card's dense int8
peak, from the trace run's untraced window on the host clock."""

from pfbench import peaks


def read(run):
    if run['kind'] != 'serve':
        return None
    return 100.0 * run['img_s'] * run['forward_flops'] / peaks.INT8_TENSOR_OPS_S
