"""Learner factory (counterpart of pocketflow_tpu/learners/learner_utils.py).

Maps the --learner flag to a learner class: every learner of the JAX
package (``full-prec``, ``uniform``, ``uniform-tf``, ``non-uniform``,
``weight-sparse``, ``channel``, ``chn-pruned-gpu``, ``chn-pruned-rmt``,
``dis-chn-pruned``).
"""

from __future__ import annotations


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
    if name == 'channel':
        from pocketflow_tpu_torch.learners.channel_pruning.learner import ChannelPrunedLearner
        return ChannelPrunedLearner(sm_writer, model_helper, device)
    if name == 'chn-pruned-gpu':
        from pocketflow_tpu_torch.learners.channel_pruning_gpu.learner import (
            ChannelPrunedGpuLearner)
        return ChannelPrunedGpuLearner(sm_writer, model_helper, device)
    if name == 'chn-pruned-rmt':
        from pocketflow_tpu_torch.learners.channel_pruning_rmt.learner import (
            ChannelPrunedRmtLearner)
        return ChannelPrunedRmtLearner(sm_writer, model_helper, device)
    if name == 'dis-chn-pruned':
        from pocketflow_tpu_torch.learners.discr_channel_pruning.learner import (
            DisChnPrunedLearner)
        return DisChnPrunedLearner(sm_writer, model_helper, device)
    raise ValueError('unrecognized learner name: ' + name)
