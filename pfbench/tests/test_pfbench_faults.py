"""A run whose timed path is broken underneath comes out not correct: the
harness is driven as a run drives it (the look for a card skipped), at a
tiny size on the CPU with the program at float32 (where an unbroken run
agrees with the reference), once for each fault the cell can have: a
state left unchanged, half of the batch left out, an answer altered where
it is produced (the logits, or four channels of one int8 site's output,
which the layers after it may damp)."""

import pytest
import torch

from pfbench import run

from .conftest import sizes

A, B, C = 'resnet50.qat-w4.b256', 'resnet50.int8-serve.b256', 'mobilenet_v1.uqtf-w8a8.b256'


def break_program(monkeypatch, fault):
    from pocketflow_tpu_torch.datasets.abstract import AbstractDataset
    from pocketflow_tpu_torch.learners.abstract_learner import Sgd
    from pocketflow_tpu_torch.nets.abstract_model_helper import AbstractModelHelper
    if fault == 'state_unchanged':
        monkeypatch.setattr(Sgd, 'update', lambda self, optimizer, step: None)
    elif fault == 'half_batch':
        whole = AbstractDataset.augment_xy

        def half(self, batch, generator, is_train):
            images, labels = whole(self, batch, generator, is_train)
            return images[:images.shape[0] // 2], labels[:labels.shape[0] // 2]

        monkeypatch.setattr(AbstractDataset, 'augment_xy', half)
    elif fault == 'answer_altered':
        served = AbstractModelHelper.forward_eval

        def altered(self, model, inputs, policy=None):
            logits = served(self, model, inputs, policy=policy).clone()
            logits[0] = logits[0].roll(1)
            return logits

        monkeypatch.setattr(AbstractModelHelper, 'forward_eval', altered)
    elif fault == 'site_altered':
        from pocketflow_tpu_torch.ops.int8_ops import Int8ServingPolicy
        contract = Int8ServingPolicy.run_contraction

        def scaled(self, path, x, kernel, contract_fn, layer=None):
            y = contract(self, path, x, kernel, contract_fn, layer)
            if y is not None and path == 'stage1_block0/conv1':
                y = y.clone()
                y[:, :4] *= 2
            return y

        monkeypatch.setattr(Int8ServingPolicy, 'run_contraction', scaled)


@pytest.mark.parametrize('cell, fault', [
    (A, None), (A, 'state_unchanged'), (A, 'half_batch'),
    (C, None), (C, 'state_unchanged'), (C, 'half_batch'),
    (B, None), (B, 'answer_altered'), (B, 'site_altered')])
def test_fault_is_caught(root, monkeypatch, cell, fault):
    torch.manual_seed(0)
    break_program(monkeypatch, fault)
    result = run.run_cell(cell, 2 ** 33 + 5, 0.3, False, root=root, device='cpu',
                          sizes=sizes(cell, compute_dtype='float32'))
    assert result['correct'] is (fault is None), result['checks']


@pytest.mark.parametrize('key, value', [('loop', 'open'), ('in_flight', 4)])
def test_serve_refuses_a_load_it_does_not_offer(root, key, value):
    with pytest.raises(SystemExit, match=key):
        run.run_cell(B, 5, 0.1, False, root=root, device='cpu',
                     sizes={**sizes(B), 'traffic.' + key: value})
