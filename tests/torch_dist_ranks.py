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


def remat_step(flags, images, labels, modes):
    """One full-prec ResNet-20 step with exact sync-BN on this rank's rows,
    from the learner's seeded init, under each --remat_blocks mode of
    `modes`: {mode: the checksum of the state after it and the collectives
    it ran}."""
    from pocketflow_tpu_torch.learners.full_precision import FullPrecLearner
    from pocketflow_tpu_torch.nets.resnet_at_cifar10 import ModelHelper
    _register_flags()
    out = {}
    for mode in modes:
        with FLAGS.scope(**flags, remat_blocks=mode):
            learner = FullPrecLearner(None, ModelHelper(), device='cpu')
            _deterministic_augment(learner.dataset_train)
            state, tx, _ = learner.init_state()
            step = learner.build_train_step(tx)
            rows = mesh.shard_rows(len(images))
            batch = learner.put_batch({'image': images[rows], 'label': labels[rows]})
            mesh.reset_counters()
            state, _ = step(state, batch, None)
            out[mode] = {'checksum': checksum(state), 'counts': mesh.counters()}
    return out


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


# ---------------------------------------------------------------------------
# tensor parallelism (tests/test_torch_tp_*.py)
# ---------------------------------------------------------------------------

def _tp_learner(kind: str):
    """(learner, state, step) of a ConvNet @ FMNIST learner on the CPU under
    the flags in scope: 'full-prec', 'uniform', 'uniform-tf' or 'non-uniform'."""
    from pocketflow_tpu_torch.nets.convnet_at_fmnist import ModelHelper
    if kind == 'full-prec':
        from pocketflow_tpu_torch.learners.full_precision import FullPrecLearner
        learner = FullPrecLearner(None, ModelHelper(), device='cpu')
        _deterministic_augment(learner.dataset_train)
        state, tx, _ = learner.init_state()
        return learner, state, learner.build_train_step(tx)
    if kind == 'non-uniform':
        from pocketflow_tpu_torch.learners.nonuniform_quantization.learner import (
            NonUniformQuantLearner)
        learner = NonUniformQuantLearner(None, ModelHelper(), device='cpu')
        _deterministic_augment(learner.dataset_train)
        state, tx, _ = learner.init_state_quant()
        return learner, state, learner.build_quant_train_step(tx)
    if kind == 'uniform-tf':
        from pocketflow_tpu_torch.learners.uniform_quantization_tf.learner import (
            UniformQuantTFLearner)
        learner = UniformQuantTFLearner(None, ModelHelper(), device='cpu')
        _deterministic_augment(learner.dataset_train)
        state, tx, _ = learner.init_state_quant()
        return learner, state, learner.build_qat_train_step(tx, freeze_bn=False)
    from pocketflow_tpu_torch.learners.uniform_quantization.learner import UniformQuantLearner
    learner = UniformQuantLearner(None, ModelHelper(), device='cpu')
    _deterministic_augment(learner.dataset_train)
    state, tx, _ = learner.init_state_quant()
    return learner, state, learner.build_quant_train_step(tx)


def tp_step(kind: str, flags, snapshot, images, labels, start_step: int = 0):
    """One step of `kind` on this rank's rows of (images, labels) from the
    bridged snapshot (with its 'extra', where it has one) at `start_step`,
    under the mesh of `flags`: the full state after it (gathered over the
    model group, 'extra/...' the learner's extra) under the JAX paths, the
    step's loss,
    this rank's replicated tensors (parameters and buffers), the shapes of
    its shards and of their momentum, the collectives and launches of the
    step, its place on the mesh."""
    from pocketflow_tpu_torch.core.bridge import load_jax_numpy
    from pocketflow_tpu_torch.nn import layers
    from pocketflow_tpu_torch.ops import fake_quant as fq
    _register_flags()
    with FLAGS.scope(**flags):
        learner, state, step = _tp_learner(kind)
        load_jax_numpy(state.model, snapshot['params'], snapshot['batch_stats'])
        if 'extra' in snapshot:
            from pocketflow_tpu_torch.core.bridge import extra_from_jax
            state.extra = {**state.extra, **extra_from_jax(snapshot['extra'])}
            if 'codebooks' in snapshot['extra']:  # the optimizer over the new codebooks
                state.optimizer = learner._tx.init(
                    state.model, list(state.extra['codebooks'].values()))
        state.step = start_step
        rows = mesh.shard_rows(len(images))
        batch = learner.put_batch({'image': images[rows], 'label': labels[rows]})
        mesh.reset_counters()
        fq.reset_counters()
        state, metrics = step(state, batch, None)
        counts, launches = mesh.counters(), fq.counters()
        loss = learner.global_scalars(metrics)['loss']
        local = state.model.state_dict(keep_vars=True)
        full = {k.replace('.', '/'): v.numpy().copy()
                for k, v in layers.full_state_dict(state.model).items()}
        if 'extra' in snapshot:
            flat = flat_port_state(state, True)
            full.update({k: v for k, v in flat.items()
                         if k.startswith('extra/') and k.split('/')[1] in snapshot['extra']})
        from pocketflow_tpu_torch.core.bridge import to_jax_numpy
        jax_params, _ = to_jax_numpy(state.model)  # the full arrays, gathered
        bridged = bool(np.array_equal(jax_params['fc3']['kernel'], full['fc3/kernel']))
        return {
            'state': full, 'bridged': bridged,
            'loss': loss, 'counts': counts, 'launches': launches,
            'replicated': {k: v.detach().numpy().copy() for k, v in local.items()
                           if not isinstance(v, mesh.ModelShard)},
            'shards': {k: tuple(v.shape) for k, v in local.items()
                       if isinstance(v, mesh.ModelShard)},
            'momentum': {name: tuple(state.optimizer.state[p]['momentum_buffer'].shape)
                         for name, p in state.model.named_parameters()
                         if isinstance(p, mesh.ModelShard)},
            'place': (mesh.data_rank(), mesh.model_rank(), mesh.num_workers(),
                      mesh.model_size()),
            'global_batch': learner.global_batch_size}


def tp_guard(flags, learners):
    """Each learner of `learners` ({name: extra flags}) built under the mesh
    of `flags` and trained: {name: the NotImplementedError's message, or
    None where it trained}."""
    from pocketflow_tpu_torch.learners.learner_utils import create_learner
    from pocketflow_tpu_torch.nets.convnet_at_fmnist import ModelHelper
    import pocketflow_tpu_torch.learners.channel_pruning.learner  # noqa: F401
    import pocketflow_tpu_torch.learners.channel_pruning_gpu.learner  # noqa: F401
    import pocketflow_tpu_torch.learners.channel_pruning_rmt.learner  # noqa: F401
    import pocketflow_tpu_torch.learners.discr_channel_pruning.learner  # noqa: F401
    import pocketflow_tpu_torch.learners.weight_sparsification.learner  # noqa: F401
    _register_flags()
    out = {}
    for name, extra in learners.items():
        with FLAGS.scope(**flags, **extra):
            learner = create_learner(None, ModelHelper(), learner_name=name.split('@')[0],
                                     device='cpu')
            try:
                learner.train()
                out[name] = None
            except NotImplementedError as exc:
                out[name] = str(exc)
    return out


def tp_layers(seed: int):
    """A column-parallel PFConv and PFDense in float64 on this rank: the
    forward of random inputs through each, and the gradients of a random
    cotangent, against the same layers unsharded on this rank (no
    collective): max |difference| of the output, the input's gradient and
    the kernel's (this rank's columns)."""
    from pocketflow_tpu_torch.nn import layers
    torch.manual_seed(seed)
    out = {}
    for name, make, x_shape in (
            ('conv', lambda: layers.PFConv(64, 1024, (3, 3), (2, 2), dtype=torch.float64),
             (2, 64, 6, 6)),
            ('dense', lambda: layers.PFDense(256, 512, dtype=torch.float64), (3, 256))):
        full = make().double()
        full.reset_parameters(torch.Generator().manual_seed(seed))
        with torch.no_grad():
            full.bias.copy_(torch.randn(full.bias.shape, generator=torch.Generator().manual_seed(1),
                                        dtype=torch.float64))
        sharded = make().double()
        sharded.load_state_dict(full.state_dict())
        assert layers.shard_model_(sharded) == ['kernel']
        x = torch.randn(x_shape, dtype=torch.float64, generator=torch.Generator().manual_seed(2))
        if x.dim() == 4:
            x = x.contiguous(memory_format=torch.channels_last)
        x_full = x.clone().requires_grad_(True)
        x_tp = x.clone().requires_grad_(True)
        y_full = full(x_full)
        y_tp = sharded(x_tp)
        dy = torch.randn(y_full.shape, dtype=torch.float64,
                         generator=torch.Generator().manual_seed(3))
        (y_full * dy).sum().backward()
        (y_tp * dy).sum().backward()
        width = sharded.kernel.shape[-1]
        cols = slice(mesh.model_rank() * width, (mesh.model_rank() + 1) * width)
        out[name] = {'y': float((y_tp - y_full).abs().max()),
                     'dx': float((x_tp.grad - x_full.grad).abs().max()),
                     'dkernel': float((sharded.kernel.grad - full.kernel.grad[..., cols])
                                      .abs().max()),
                     'dbias': float((sharded.bias.grad - full.bias.grad).abs().max()),
                     'kernel_shape': tuple(sharded.kernel.shape)}
    return out


def tp_fake_quant(weights, bits):
    """This rank's shard of each weight (the JAX rule's; the rest whole)
    through the plain model-axis fake-quant: each result gathered back to
    the full weight, with the collectives."""
    from pocketflow_tpu_torch.ops import fake_quant as fq
    xs, placements = [], []
    for w in weights:
        full = torch.from_numpy(w)
        placement = mesh.infer_tp_sharding(full)
        placements.append(placement)
        xs.append(mesh.shard_tensor(full, placement))
    mesh.reset_counters()
    bits_t = torch.tensor(bits, dtype=torch.float32)
    out = fq.fake_quant_per_tensor_group_global(xs, bits_t)
    counts = mesh.counters()
    # the bucket routes on the same shards (held as ModelShards, as the
    # policy passes them): channel buckets are a shard's own columns, split
    # buckets are taken over the gathered kernel
    params = [mesh.ModelShard(x) if p.axis is not None else x for x, p in zip(xs, placements)]
    buckets = {}
    for kind in ('channel', 'split'):
        mesh.reset_counters()
        got = fq.fake_quant_bucket_group(params, bits_t, kind, 256)
        buckets[kind] = {'counts': mesh.counters()}
        buckets[kind]['out'] = [mesh.gather_tensor(q.detach(), p).numpy()
                                for q, p in zip(got, placements)]
    return {'out': [mesh.gather_tensor(q, p).numpy() for q, p in zip(out, placements)],
            'sharded': [p.axis is not None for p in placements], 'counts': counts,
            'buckets': buckets}


def _full_state(state):
    """A train state in full (the shards gathered): parameters and buffers
    and SGD momentum (by parameter index) as numpy arrays, and the step."""
    from pocketflow_tpu_torch.core import checkpoint as ckpt_lib
    from pocketflow_tpu_torch.nn import layers
    opt = ckpt_lib.full_optimizer_state(state.optimizer)
    return {'model': {k: v.numpy().copy() for k, v in layers.full_state_dict(state.model).items()},
            'momentum': {i: b['momentum_buffer'].numpy().copy() for i, b in opt['state'].items()},
            'step': state.step}


def tp_main_rank(argv):
    """main.main(argv) on this rank (CPU): the full state at each save, with
    the files each rank wrote under the save directory's parent
    (torch.save's and the sharded backend's), and the storages of the
    tensors handed to dcp.async_save that a live parameter, buffer or
    momentum held at the save ('shared')."""
    import torch.distributed.checkpoint as dcp
    from pocketflow_tpu_torch import main as main_lib
    from pocketflow_tpu_torch.core import checkpoint as ckpt_lib
    from pocketflow_tpu_torch.learners import abstract_learner
    record = {'saves': [], 'writes': [], 'shared': []}
    live = set()
    save_model = abstract_learner.AbstractLearner.save_model
    save = ckpt_lib.torch.save
    async_save = dcp.async_save

    def recorded_save_model(self, state, *args, **kwargs):
        record['saves'].append(_full_state(state))
        live.clear()
        live.update(t.untyped_storage().data_ptr() for t in state.model.state_dict().values())
        live.update(b.untyped_storage().data_ptr() for buffers in state.optimizer.state.values()
                    for b in buffers.values() if torch.is_tensor(b))
        return save_model(self, state, *args, **kwargs)

    def counted_save(obj, path, *args, **kwargs):
        record['writes'].append(str(path))
        return save(obj, path, *args, **kwargs)

    def recorded_async_save(state_dict, *args, **kwargs):
        record['shared'] += [key for key, t in state_dict.items()
                             if t.untyped_storage().data_ptr() in live]
        return async_save(state_dict, *args, **kwargs)

    abstract_learner.AbstractLearner.save_model = recorded_save_model
    ckpt_lib.torch.save = counted_save
    dcp.async_save = recorded_async_save
    try:
        main_lib.main(list(argv), device='cpu')
    finally:
        abstract_learner.AbstractLearner.save_model = save_model
        ckpt_lib.torch.save = save
        dcp.async_save = async_save
    return record


def tp_restore(flags):
    """A full-prec ConvNet @ FMNIST learner under the mesh of `flags`
    restored from the newest checkpoint under --save_path: its full state,
    this rank's shapes of fc3's kernel and momentum, and restore_intersecting
    into a fresh model of the mesh (the count, the parameters', and whether
    each equals the restored one)."""
    from pocketflow_tpu_torch.learners.full_precision import FullPrecLearner
    from pocketflow_tpu_torch.nets.convnet_at_fmnist import ModelHelper
    _register_flags()
    with FLAGS.scope(**flags):
        learner = FullPrecLearner(None, ModelHelper(), device='cpu')
        state, _, _ = learner.init_state()
        state = learner.restore_model(state)
        out = _full_state(state)
        # restore_intersecting into a fresh model of this mesh: every parameter, a
        # shard its slice
        from pocketflow_tpu_torch.core import checkpoint as ckpt_lib
        from pocketflow_tpu_torch.nn import layers
        fresh = learner.create_model()
        count = ckpt_lib.restore_intersecting(FLAGS.save_path, fresh)
        grafted = layers.full_state_dict(fresh)
        out['intersecting'] = (count, len(list(fresh.parameters())), all(
            np.array_equal(grafted[name].numpy(), out['model'][name])
            for name, _ in fresh.named_parameters()))
        kernel = state.model.fc3.kernel
        out['fc3'] = (tuple(kernel.shape), tuple(state.optimizer.state[kernel]['momentum_buffer']
                                                 .shape), isinstance(kernel, mesh.ModelShard))
        return out


def tp_mesh_helpers(mesh_shape: str):
    """The 2-D mesh's helpers on this rank under `mesh_shape`: its place,
    the model group's gather (a row-major and a channels-last tensor along
    their last and channel axes), sum and max, the data group's sum and
    rows, a dataset's shard, the broadcasts of a shard and of a replicated
    tensor, with the collectives each issued."""
    with FLAGS.scope(mesh_shape=mesh_shape):
        mesh.setup_groups()
        rank = mesh.worker_rank()
        out = {'place': (mesh.world_size(), mesh.num_workers(), mesh.model_size(),
                         mesh.data_rank(), mesh.model_rank())}
        mesh.reset_counters()
        row = torch.full((2, 3), float(rank))
        out['gather_rows'] = mesh.all_gather_model(row).numpy()
        act = torch.arange(2 * 3 * 2 * 2, dtype=torch.float32).reshape(2, 3, 2, 2) + 100 * rank
        act = act.contiguous(memory_format=torch.channels_last)
        gathered = mesh.all_gather_model(act, 1)
        out['gather_act'] = gathered.numpy()
        out['gather_act_channels_last'] = gathered.is_contiguous(
            memory_format=torch.channels_last)
        out['sum_model'] = mesh.all_reduce_sum_model_(torch.tensor([float(rank), 1.0])).numpy()
        out['max_model'] = mesh.all_reduce_max_model_(torch.tensor([float(rank), -rank])).numpy()
        out['sum_data'] = mesh.all_reduce_sum_(torch.tensor([float(rank), 1.0])).numpy()
        out['counts'] = mesh.counters()
        out['rows'] = mesh.shard_rows(8)
        from pocketflow_tpu_torch.datasets.fmnist import FMnistDataset
        with FLAGS.scope(synthetic_data=True):
            data = FMnistDataset(is_train=True)
        out['dataset_shard'] = (data.shard_id, data.nb_shards)
        shard = mesh.ModelShard(torch.full((2,), float(rank)))
        plain = torch.full((2,), float(rank))
        mesh.broadcast_from_primary([shard, plain])
        out['broadcast'] = (shard.detach().numpy().copy(), plain.numpy().copy())
        return out


def tp_prune_update(mesh_shape: str, ratio: float):
    """masking.prune_update and calc_prune_ratio on ConvNet @ FMNIST's
    parameters (drawn from one seed on every rank) at a refresh halfway
    through the schedule, once on the full parameters (no collective) and
    once on this rank's shards under `mesh_shape`: the full results, and
    the sharded ones gathered."""
    from pocketflow_tpu_torch.learners.weight_sparsification import masking
    from pocketflow_tpu_torch.nets.convnet_at_fmnist import ModelHelper
    from pocketflow_tpu_torch.nn import layers
    with FLAGS.scope(mesh_shape=mesh_shape, synthetic_data=True):
        mesh.setup_groups()
        model = ModelHelper().create_model()
        model.reset_parameters(torch.Generator().manual_seed(4))
        full = {n: p.detach().clone() for n, p in model.named_parameters()}
        assert layers.shard_model_(model) == ['fc3.kernel']
        shards = dict(model.named_parameters())
        ratios = {name: ratio for name in masking.maskable_paths(full)}
        out = {}
        for label, params in (('full', full), ('tp', shards)):
            extra = masking.build_mask_state(params)
            new_params, new_extra = masking.prune_update(params, extra, 50, 100, ratios)
            gather = {name: mesh.gather_tensor(t, mesh.shard(-1))
                      if isinstance(params[name], mesh.ModelShard) else t
                      for name, t in new_extra['masks'].items()}
            out[label] = {'masks': {k: v.numpy() for k, v in gather.items()},
                          'shapes': masking.maskable_shapes(params),
                          'ratio': float(masking.calc_prune_ratio(
                              {k: (mesh.ModelShard(v) if isinstance(params[k], mesh.ModelShard)
                                   else v) for k, v in new_params.items()}, maskable_only=True))}
        return out


def tp_cpg(flags, images, labels, nb_steps: int = 2):
    """chn-pruned-gpu's PGD and reconstruction steps on ResNet-50 @
    ILSVRC-12 under the mesh of `flags`, on this rank's rows of (images,
    labels), from the learner's seeded state: the full prunable kernels
    after `nb_steps` PGD steps and one reconstruction step (the shards
    gathered), the channel masks, the losses, and the shards' names."""
    from pocketflow_tpu_torch.learners.channel_pruning_gpu import learner as cpg
    from pocketflow_tpu_torch.nets.resnet_at_ilsvrc12 import ModelHelper
    from pocketflow_tpu_torch.nn import layers
    with FLAGS.scope(**flags):
        learner = cpg.ChannelPrunedGpuLearner(None, ModelHelper(resnet_size=50), device='cpu')
        state, _, _ = learner.init_state()
        names = learner.prunable_paths(dict(state.model.named_parameters()))
        pruned = learner.copy_state(state)
        rows = mesh.shard_rows(len(images))
        batch = learner.put_batch({'image': images[rows], 'label': labels[rows]})
        rates = torch.full((len(names),), 0.05)
        percentiles = torch.full((len(names),), 30.0)
        losses = [cpg.pgd_step(learner, state.model, pruned.model, names, rates, percentiles,
                               batch).numpy() for _ in range(nb_steps)]
        masks = learner.masks_of(pruned.model, names)
        params = dict(pruned.model.named_parameters())
        optimizer = cpg.RelativeAdam([params[n] for n in names], 1e-2)
        losses.append(cpg.recon_step(learner, state.model, pruned.model, names, masks,
                                     optimizer, batch).numpy())
        full = layers.full_state_dict(pruned.model)
        return {'kernels': {n: full[n].numpy() for n in names},
                'masks': {n: masks[n].numpy() for n in names},
                'losses': losses,
                'shards': sorted(n for n in names if isinstance(params[n], mesh.ModelShard))}
