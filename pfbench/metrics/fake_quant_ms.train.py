"""fake_quant_ms.train: device ms a traced step of the hand-written
fake-quant kernels (csrc/fake_quant.cu).  The launches the program counted
over the traced steps are printed beside it."""

import sys


def read(run):
    if run['kind'] != 'train':
        return None
    seconds = run['summary']['category_s'].get('fake-quant kernels')
    if seconds is None:
        return None
    records = sum(n for k, n in run['summary']['records'].items()
                  if any(s in k for s in ('minmax_partials', 'group_quantize', 'tensor_minmax',
                                          'tensor_quantize', 'column_group')))
    print('pfbench: fake_quant_ms.train: %d kernel records, launches counted %s'
          % (records, run['counters'].get('fake_quant')), file=sys.stderr)
    return 1e3 * seconds / run['units']
