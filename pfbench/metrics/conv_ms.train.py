"""conv_ms.train: device ms a traced step of the convs and matmuls
(cuDNN, cuBLAS), depthwise convs included, forward and backward."""


def read(run):
    if run['kind'] != 'train':
        return None
    cats = run['summary']['category_s']
    parts = [cats[k] for k in ('conv/matmul (cuDNN, cuBLAS)', 'depthwise conv') if k in cats]
    return 1e3 * sum(parts) / run['units'] if parts else None
