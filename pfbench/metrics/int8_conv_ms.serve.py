"""int8_conv_ms.serve: device ms a traced request of the int8 serving
kernel (``int8_conv_wgmma``, csrc/int8_conv.cu).  Its records are checked
against the launches the program counted (``int8_ops.counters()``): where
the profiler lost records, the time is the records' mean times the
launches, and the loss is printed."""

import sys

from pfbench import tracing

KERNEL = 'int8_conv_wgmma'


def device_seconds(run):
    """The kernel's device seconds over the traced requests, made whole
    where records were lost; None without records."""
    seconds, records = tracing.kernel_seconds(run['summary'], KERNEL)
    if not records:
        return None
    launches = run['counters'].get('int8', {}).get('int8_conv', records)
    if records != launches:
        print('pfbench: %s: %d records for %d launches counted' % (KERNEL, records, launches),
              file=sys.stderr)
        seconds *= launches / records
    return seconds


def read(run):
    if run['kind'] != 'serve':
        return None
    seconds = device_seconds(run)
    return None if seconds is None else 1e3 * seconds / run['units']
