"""Learner factory (counterpart of pocketflow_tpu/learners/learner_utils.py).

Maps the --learner flag to a learner class.  The port has ``full-prec``,
``uniform``, ``uniform-tf``, ``non-uniform`` and ``weight-sparse``; the
channel-pruning names of the JAX package raise NotImplementedError with the
ROADMAP item that ports them.
"""

from __future__ import annotations

# learner name -> ROADMAP item ('Modules to port') that ports it
_NOT_PORTED = {
    'channel': 'item 18',
    'chn-pruned-gpu': 'item 18',
    'chn-pruned-rmt': 'item 18',
    'dis-chn-pruned': 'item 18',
}


def create_learner(sm_writer, model_helper, learner_name=None, device='cuda'):
    """Create the learner named `learner_name` (default: FLAGS.learner) on `device`."""
    from pocketflow_tpu_torch.config import FLAGS
    name = learner_name or FLAGS.learner

    if name == 'full-prec':
        from pocketflow_tpu_torch.learners.full_precision import FullPrecLearner
        return FullPrecLearner(sm_writer, model_helper, device)
    if name == 'uniform':
        from pocketflow_tpu_torch.learners.uniform_quantization.learner import UniformQuantLearner
        return UniformQuantLearner(sm_writer, model_helper, device)
    if name == 'uniform-tf':
        from pocketflow_tpu_torch.learners.uniform_quantization_tf.learner import (
            UniformQuantTFLearner)
        return UniformQuantTFLearner(sm_writer, model_helper, device)
    if name == 'non-uniform':
        from pocketflow_tpu_torch.learners.nonuniform_quantization.learner import (
            NonUniformQuantLearner)
        return NonUniformQuantLearner(sm_writer, model_helper, device)
    if name == 'weight-sparse':
        from pocketflow_tpu_torch.learners.weight_sparsification.learner import WeightSparseLearner
        return WeightSparseLearner(sm_writer, model_helper, device)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            "learner %r is not ported yet (ROADMAP 'Modules to port', %s)"
            % (name, _NOT_PORTED[name]))
    raise ValueError('unrecognized learner name: ' + name)
