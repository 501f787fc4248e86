"""Knowledge-distillation helper (counterpart of pocketflow_tpu/learners/distillation_helper.py).

The teacher is a frozen copy of the model restored from the port's own
full-precision checkpoint under ``dirname(--save_path)``; its logits on the
step's augmented images give the soft labels of

    kd_loss = loss_w_dst * CE(softmax(z_t / T), log_softmax(z_s / T))

in fp32, with T = --tempr_dst.  The teacher runs in eval mode under
``torch.no_grad()`` outside the student's compression policy, so it adds no
activation site and launches no fake-quant kernel.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import torch

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.core import checkpoint as ckpt_lib
from pocketflow_tpu_torch.core.metrics import get_logger


class DistillationHelper:
    """Holds the frozen teacher and computes the KD loss term."""

    def __init__(self, model_helper, device,
                 teacher_state: Optional[Dict[str, torch.Tensor]] = None):
        self.model_helper = model_helper
        self.log = get_logger()
        if teacher_state is None:
            teacher_state = self._restore_teacher(device)
        self.model = model_helper.create_model().to(device)
        self.model.load_state_dict(teacher_state)
        self.model.eval().requires_grad_(False)

    @staticmethod
    def _restore_teacher(device) -> Dict[str, torch.Tensor]:
        """The model state of the newest checkpoint under dirname(--save_path)."""
        save_dir = os.path.dirname(FLAGS.save_path) or '.'
        payload = ckpt_lib.restore_latest(FLAGS.save_path, map_location=device)
        if payload is None:
            raise FileNotFoundError(
                'distillation requires a pretrained full-prec checkpoint under ' + save_dir)
        get_logger().info('teacher restored from %s', ckpt_lib.latest_checkpoint(save_dir))
        return payload['model']

    @torch.no_grad()
    def calc_logits(self, images: torch.Tensor) -> torch.Tensor:
        """Teacher forward pass (eval mode, no gradient, no policy)."""
        return self.model_helper.forward_eval(self.model, images)

    @staticmethod
    def calc_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor) -> torch.Tensor:
        """Soft-label cross-entropy at temperature T, scaled by loss_w_dst."""
        tempr = FLAGS.tempr_dst
        teacher_probs = torch.softmax(teacher_logits.to(torch.float32) / tempr, dim=-1)
        student_logp = torch.log_softmax(student_logits.to(torch.float32) / tempr, dim=-1)
        ce = -(teacher_probs * student_logp).sum(dim=-1).mean()
        return FLAGS.loss_w_dst * ce

    def loss_extra_fn(self):
        """Adapter for AbstractLearner.build_train_step(loss_extra_fn=...)."""
        def fn(state, outputs, images, labels) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
            del state, labels
            dst_loss = self.calc_loss(outputs, self.calc_logits(images))
            return dst_loss, {'dst_loss': dst_loss}
        return fn
