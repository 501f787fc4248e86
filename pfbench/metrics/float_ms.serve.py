"""float_ms.serve: device ms a traced request of every kernel, copy and
memset but the int8 serving kernel: BN, ReLU, the residual adds, the
pools, the casts."""

from pfbench import tracing


def read(run):
    if run['kind'] != 'serve':
        return None
    total = sum(run['summary']['kernel_s'].values())
    int8, _ = tracing.kernel_seconds(run['summary'], 'int8_conv_wgmma')
    return 1e3 * (total - int8) / run['units']
