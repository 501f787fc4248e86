"""train_mfu: the whole train step's model operations per second (3x the
forward's conv and dense operations, counted from the configuration's
layer list) over the card's dense bf16 peak, from the trace run's
untraced window on the host clock."""

from pfbench import peaks


def read(run):
    if run['kind'] != 'train':
        return None
    return 100.0 * run['img_s'] * run['train_flops'] / peaks.BF16_TENSOR_OPS_S
