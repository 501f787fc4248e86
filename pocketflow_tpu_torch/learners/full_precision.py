"""Full-precision learner: trains/evaluates the uncompressed baseline
(counterpart of pocketflow_tpu/learners/full_precision.py)."""

from __future__ import annotations

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.learners.abstract_learner import AbstractLearner, TrainState


class FullPrecLearner(AbstractLearner):
    """Full-precision baseline learner."""

    def __init__(self, sm_writer, model_helper, device='cuda'):
        super().__init__(sm_writer, model_helper, device)
        if FLAGS.enbl_dst:
            raise NotImplementedError(
                "--enbl_dst is not ported yet (ROADMAP 'Modules to port', item 13)")

    def train(self) -> TrainState:
        state, tx, _ = self.init_state()
        if FLAGS.enbl_warm_start:
            state = self.warm_start(state)
        train_step = self.build_train_step(tx)
        eval_step = self.build_eval_step()
        state = self.run_train_loop(
            state, train_step, eval_fn=lambda s: self.run_eval_loop(s, eval_step))
        self.run_eval_loop(state, eval_step)
        return state

    def evaluate(self):
        state, _, _ = self.init_state()
        restored = self.restore_model(state)
        if restored is None:
            raise FileNotFoundError('no checkpoint found under ' + FLAGS.save_path)
        return self.run_eval_loop(restored, self.build_eval_step())
