"""int8_conv_roofline: the least time of the int8 sites of a forward
(each site's input read once, its codes read once, its output written
once, or its int8 operations at the peak, whichever is longer; summed
over the sites from the configuration's layer list, K = kh kw C unpadded)
over the int8 kernel's device time a request."""

import importlib.util
import os


def _kernel_reader():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), 'int8_conv_ms.serve.py')
    spec = importlib.util.spec_from_file_location('pfbench_int8_conv_ms_serve', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read(run):
    if run['kind'] != 'serve':
        return None
    seconds = _kernel_reader().device_seconds(run)
    if not seconds:
        return None
    return 100.0 * run['int8_bound_ms'] / (1e3 * seconds / run['units'])
