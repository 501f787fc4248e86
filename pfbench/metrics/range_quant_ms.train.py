"""range_quant_ms.train: device ms a traced step of the kernels launched
inside the benchmark's span around each call of the plain
``fake_quant_with_range`` (the range quant policy's activation quantizer;
its backward runs outside the span and is not counted)."""

from pfbench import tracing


def read(run):
    if run['kind'] != 'train':
        return None
    seconds = tracing.range_seconds(run['summary'], 'range_quant')
    return None if seconds is None else 1e3 * seconds / run['units']
