"""The rank side of the data-parallel tests (tests/test_torch_dist_*.py): the
functions that ``pocketflow_tpu_torch.tools.launch.spawn`` runs in each gloo
CPU rank.  Nothing here imports JAX, so that a rank starts in seconds; the
JAX side of each comparison stays in the test process.

Each step case takes one train step of a port learner from a bridged JAX
state on this rank's rows of a global batch (rank r takes rows r*B..(r+1)*B)
and returns the state after it as a flat dict keyed as the JAX package's
('conv_init/kernel', 'conv_init/bn/bn/mean', 'extra/act_max'), with the
step's loss (the ranks' mean), the collectives it issued and a checksum of
every parameter, buffer and `extra` tensor.
"""

import hashlib
import importlib

import numpy as np
import torch

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.core import mesh

# case -> (net module, learner, the step it starts from, whether the step's
# loss is compared)
CASES = {
    'full-prec': ('resnet_at_cifar10', 'full-prec', 0, True),
    'ghost-bn': ('resnet_at_cifar10', 'full-prec', 0, True),
    'act8': ('convnet_at_fmnist', 'uniform', 0, True),
    'uniform-tf': ('mobilenet_at_ilsvrc12', 'uniform-tf', 1, False),
    'non-uniform': ('resnet_at_cifar10', 'non-uniform', 0, False),
}


def _register_flags():
    import pocketflow_tpu_torch.learners.nonuniform_quantization.learner  # noqa: F401
    import pocketflow_tpu_torch.learners.uniform_quantization.learner  # noqa: F401
    import pocketflow_tpu_torch.learners.uniform_quantization_tf.learner  # noqa: F401
    for net in ('convnet_at_fmnist', 'mobilenet_at_ilsvrc12', 'resnet_at_cifar10'):
        importlib.import_module('pocketflow_tpu_torch.nets.' + net)


def _deterministic_augment(dataset):
    cls = type(dataset)
    dataset.augment_xy = lambda batch, rng, is_train: cls.augment_xy(dataset, batch, rng, False)


def flat_port_state(state, with_extra: bool):
    """A TrainState's parameters, BN statistics and (with_extra) extra as
    one flat dict of numpy arrays under the JAX package's paths."""
    out = {k: v.detach().numpy().copy() for k, v in state.params.items()}
    out.update({k: v.numpy().copy() for k, v in state.batch_stats.items()})
    if with_extra:
        for key, value in state.extra.items():
            if isinstance(value, dict):
                out.update({'extra/%s/%s' % (key, p): v.detach().numpy().copy()
                            for p, v in value.items()})
            else:
                out['extra/' + key] = value.detach().numpy().copy()
    return out


def checksum(state) -> str:
    """sha256 of every parameter, buffer and extra tensor, in order."""
    digest = hashlib.sha256()
    for name, tensor in sorted({**state.params, **state.batch_stats}.items()):
        digest.update(name.encode())
        digest.update(tensor.detach().contiguous().numpy().tobytes())
    stack = [state.extra]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node[k] for k in sorted(node, reverse=True))
        elif isinstance(node, torch.Tensor):
            digest.update(node.detach().contiguous().numpy().tobytes())
    return digest.hexdigest()


def port_learner(case: str, snapshot):
    """(learner, state at the snapshot, train step) of a case, on the CPU."""
    from pocketflow_tpu_torch.core.bridge import extra_from_jax, load_jax_numpy
    net, kind, start_step, _ = CASES[case]
    helper = importlib.import_module('pocketflow_tpu_torch.nets.' + net).ModelHelper()
    if kind == 'full-prec':
        from pocketflow_tpu_torch.learners.full_precision import FullPrecLearner
        learner = FullPrecLearner(None, helper, device='cpu')
        _deterministic_augment(learner.dataset_train)
        state, tx, _ = learner.init_state()
        step = learner.build_train_step(tx)
    elif kind == 'uniform':
        from pocketflow_tpu_torch.learners.uniform_quantization.learner import (
            UniformQuantLearner)
        learner = UniformQuantLearner(None, helper, device='cpu')
        _deterministic_augment(learner.dataset_train)
        state, tx, _ = learner.init_state_quant()
        step = learner.build_quant_train_step(tx)
    elif kind == 'uniform-tf':
        from pocketflow_tpu_torch.learners.uniform_quantization_tf.learner import (
            UniformQuantTFLearner)
        learner = UniformQuantTFLearner(None, helper, device='cpu')
        _deterministic_augment(learner.dataset_train)
        state, tx, _ = learner.init_state_quant()
        state.extra = extra_from_jax(snapshot['extra'])
        step = learner.build_qat_train_step(tx, freeze_bn=False)
    else:
        from pocketflow_tpu_torch.learners.nonuniform_quantization.learner import (
            NonUniformQuantLearner)
        learner = NonUniformQuantLearner(None, helper, device='cpu')
        _deterministic_augment(learner.dataset_train)
        state, tx, _ = learner.init_state_quant()
        state.extra = extra_from_jax(snapshot['extra'])
        state.optimizer = tx.init(state.model, list(state.extra['codebooks'].values()))
        step = learner.build_quant_train_step(tx)
    load_jax_numpy(state.model, snapshot['params'], snapshot['batch_stats'])
    state.step = start_step
    return learner, state, step


def port_step(case: str, flags, snapshot, images, labels):
    """One step of `case` on this rank's rows of (images, labels)."""
    _register_flags()
    with FLAGS.scope(**flags):
        learner, state, step = port_learner(case, snapshot)
        rows = mesh.shard_rows(len(images))
        batch = learner.put_batch({'image': images[rows], 'label': labels[rows]})
        mesh.reset_counters()
        state, metrics = step(state, batch, None)
        counts = mesh.counters()
        loss = learner.global_scalars(metrics)['loss']
        with_extra = CASES[case][1] in ('uniform-tf', 'non-uniform')
        return {'state': flat_port_state(state, with_extra), 'loss': loss, 'counts': counts,
                'checksum': checksum(state), 'world': mesh.num_workers()}


def sync_bn(x, dy, scale, bias, epsilon):
    """The sync-BN Function on this rank's rows of float64 (x, dy): (y,
    dx, the local dscale and dbias, running mean and var) of its rows."""
    from pocketflow_tpu_torch.nn.layers import _SyncBatchNorm
    rows = mesh.shard_rows(x.shape[0])
    xr = torch.from_numpy(x[rows]).requires_grad_(True)
    s = torch.from_numpy(scale).requires_grad_(True)
    b = torch.from_numpy(bias).requires_grad_(True)
    y, mean, var = _SyncBatchNorm.apply(xr, s, b, epsilon, torch.float64)
    (y * torch.from_numpy(dy[rows])).sum().backward()
    return {'y': y.detach().numpy(), 'dx': xr.grad.numpy(), 'dscale': s.grad.numpy(),
            'dbias': b.grad.numpy(), 'mean': mean.numpy(), 'var': var.numpy()}


def mesh_helpers(seed: int):
    """broadcast_from_primary of a tree whose leaves differ by rank, a
    barrier, the (min, max) reduction and the mean all-reduce, with the
    collectives each issued."""
    rank = mesh.worker_rank()
    rng = np.random.default_rng(seed + rank)
    tree = {'t': torch.from_numpy(rng.standard_normal((3, 4)).astype(np.float32)),
            'a': rng.integers(0, 100, 5), 'nested': [float(rank), {'b': np.float32(rank + 0.5)}]}
    sent = tree['t'].clone().numpy()
    mesh.reset_counters()
    out = mesh.broadcast_from_primary(tree)
    counts_bcast = mesh.counters()
    mesh.auto_barrier()
    lo_hi = torch.tensor([[-1.0 - rank, 2.0 + rank], [float(rank), float(rank)]])
    mesh.all_reduce_minmax_(lo_hi)
    mean = torch.tensor([float(rank), 10.0 * rank])
    mesh.all_reduce_mean_([mean])
    return {'tree': {'t': out['t'].numpy(), 'a': out['a'], 'nested0': out['nested'][0],
                     'nested_b': out['nested'][1]['b']},
            'sent': {'t': sent}, 'counts_bcast': counts_bcast,
            'counts': mesh.counters(), 'lo_hi': lo_hi.numpy(), 'mean': mean.numpy(),
            'rank': rank, 'world': mesh.num_workers(),
            'primary': mesh.is_primary_worker(), 'local_primary': mesh.is_primary_worker('local')}


def dataset_batches(flags, nb_batches: int):
    """This rank's first `nb_batches` train and eval batches of ConvNet @
    FMNIST's datasets (its shards), and the sha1 of each image of one pass
    over each shard."""
    from pocketflow_tpu_torch.nets.convnet_at_fmnist import ModelHelper
    out = {}
    with FLAGS.scope(**flags):
        helper = ModelHelper()
        for name, dataset in (('train', helper.build_dataset_train()),
                              ('eval', helper.build_dataset_eval())):
            iterator = dataset.build()
            batches = [next(iterator) for _ in range(nb_batches)]
            out[name] = {'image': np.concatenate([b['image'] for b in batches]),
                         'label': np.concatenate([b['label'] for b in batches]),
                         'shard': (dataset.shard_id, dataset.nb_shards),
                         'loaded': dataset.nb_smpls_loaded}
            out[name]['sha1'] = [hashlib.sha1(img.tobytes()).hexdigest()
                                 for img in out[name]['image']]
    return out


def main_rank(argv, poison_rewards: bool = False):
    """main.main(argv) on this rank (CPU), recording the checkpoint files it
    wrote, the last eval loop's means, the teacher it restored (a checksum)
    and, for a weight-sparsification search, the ratios before and after the
    broadcast of rank 0's choice.  With `poison_rewards`, the search's
    rewards are replaced: they fall from roll-out to roll-out on rank 0 (its
    best is the first) and rise on rank 1 (its best is the last)."""
    from pocketflow_tpu_torch import main as main_lib
    from pocketflow_tpu_torch.core import checkpoint as ckpt_lib
    from pocketflow_tpu_torch.learners import abstract_learner
    from pocketflow_tpu_torch.learners.weight_sparsification import pr_optimizer, rl_helper
    record = {'writes': [], 'eval': None, 'ratios': []}
    save = ckpt_lib.torch.save

    def counted_save(obj, path, *args, **kwargs):
        record['writes'].append(str(path))
        return save(obj, path, *args, **kwargs)

    eval_loop = abstract_learner.AbstractLearner.run_eval_loop

    def recorded_eval(self, *args, **kwargs):
        record['eval'] = eval_loop(self, *args, **kwargs)
        return record['eval']

    broadcast = mesh.broadcast_from_primary

    def recorded_broadcast(tree):  # the search's ratios are its only numpy array
        if not isinstance(tree, np.ndarray):
            return broadcast(tree)
        before = np.array(tree, copy=True)
        after = broadcast(tree)
        record['ratios'].append((before, np.array(after)))
        return after

    calc_reward = rl_helper.RLHelper.calc_reward
    ckpt_lib.torch.save = counted_save
    abstract_learner.AbstractLearner.run_eval_loop = recorded_eval
    pr_optimizer.mesh.broadcast_from_primary = recorded_broadcast
    if poison_rewards:
        sign = 1.0 if mesh.worker_rank() == 1 else -1.0
        calls = []
        rl_helper.RLHelper.calc_reward = lambda self, acc: sign * len(calls.append(0) or calls)
    try:
        learner = main_lib.main(list(argv), device='cpu')
    finally:
        ckpt_lib.torch.save = save
        abstract_learner.AbstractLearner.run_eval_loop = eval_loop
        pr_optimizer.mesh.broadcast_from_primary = broadcast
        rl_helper.RLHelper.calc_reward = calc_reward
    teacher = getattr(learner, 'helper_dst', None)
    if teacher is not None:
        digest = hashlib.sha256()
        for name, tensor in sorted(teacher.model.state_dict().items()):
            digest.update(name.encode() + tensor.numpy().tobytes())
        record['teacher'] = digest.hexdigest()
    record['pairs'] = getattr(learner, 'var_names_n_prune_ratios', None)
    return record


def detection_list(helper):
    """The detections a helper scored last, image by image, as tuples
    (class, score, box), with its ground truths' checksum."""
    dets = [[(d['class'], d['score'], tuple(float(v) for v in d['box'])) for d in image]
            for image in helper._detections]
    digest = hashlib.sha256(b''.join(np.asarray(g, np.float32).tobytes()
                                     for g in helper._groundtruth)).hexdigest()
    return dets, digest


def detection_rank(argv):
    """main.main(argv) on this rank (CPU) for a detector, recording the
    checkpoint files it wrote, the mAP its evaluate() reported with the
    detections it scored (``detection_list``), and at each
    save the zero input channels of every conv kernel with at least 8 of
    them (a list of bool arrays by path)."""
    from pocketflow_tpu_torch import main as main_lib
    from pocketflow_tpu_torch.core import checkpoint as ckpt_lib
    from pocketflow_tpu_torch.learners import abstract_learner
    record = {'writes': [], 'maps': [], 'zeros': []}
    save = ckpt_lib.torch.save
    eval_map = abstract_learner.AbstractLearner.eval_map
    save_model = abstract_learner.AbstractLearner.save_model

    def counted_save(obj, path, *args, **kwargs):
        record['writes'].append(str(path))
        return save(obj, path, *args, **kwargs)

    def recorded_map(self, *args, **kwargs):
        record['maps'].append(eval_map(self, *args, **kwargs))
        record['detections'] = detection_list(self.model_helper)
        return record['maps'][-1]

    def recorded_save_model(self, state, *args, **kwargs):
        zeros = {}
        for name, param in state.params.items():
            if name.endswith('/kernel') and param.dim() == 4 and param.shape[2] >= 8:
                norms = param.detach().permute(2, 0, 1, 3).reshape(param.shape[2], -1).norm(dim=1)
                zeros[name] = (norms == 0).numpy()
        record['zeros'].append(zeros)
        return save_model(self, state, *args, **kwargs)

    ckpt_lib.torch.save = counted_save
    abstract_learner.AbstractLearner.eval_map = recorded_map
    abstract_learner.AbstractLearner.save_model = recorded_save_model
    try:
        main_lib.main(list(argv), device='cpu')
    finally:
        ckpt_lib.torch.save = save
        abstract_learner.AbstractLearner.eval_map = eval_map
        abstract_learner.AbstractLearner.save_model = save_model
    return record
