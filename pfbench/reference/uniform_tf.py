"""UniformQuantTFLearner's recipe past its quant delay: every conv and
dense kernel fake-quantized per output channel at ``weight_bits``; each
activation site's output (the relu6s, in call order) fake-quantized
against its moving-average range with the zero-point nudge at
``activation_bits``, its batch (min, max) recorded; after the update each
range moves to ema * range + (1 - ema) * batch.  The ranges start at
[0, 6]."""

from __future__ import annotations

from typing import Dict, List

import torch

from pfbench.reference import quant


class Recipe:
    def __init__(self, cfg: Dict, traffic: Dict, device=None, nb_sites: int = 0):
        args = traffic['recipe_args']
        self.weight_bits = int(args['weight_bits'])
        self.activation_bits = int(args['activation_bits'])
        self.ema = float(args['ema_decay'])
        nb_sites = nb_sites or int(args['activation_sites'])
        self.act_min = torch.zeros(nb_sites, device=device)
        self.act_max = torch.full((nb_sites,), 6.0, device=device)
        self.batch: List[torch.Tensor] = []

    def weight_fn(self, path: str, w: torch.Tensor) -> torch.Tensor:
        return quant.minmax_quantize(w, self.weight_bits, per_channel=True)

    def act_fn(self, index: int, y: torch.Tensor) -> torch.Tensor:
        if index != len(self.batch):
            raise RuntimeError('activation site %d out of order' % index)
        self.batch.append(torch.stack([y.detach().min(), y.detach().max()]))
        return quant.range_quantize(y, self.act_min[index], self.act_max[index],
                                    self.activation_bits)

    def extra_leaves(self) -> Dict[str, torch.Tensor]:
        return {'act_min': self.act_min, 'act_max': self.act_max}

    def after_update(self):
        batch = torch.stack(self.batch)
        if batch.shape[0] != self.act_min.shape[0]:
            raise RuntimeError('%d activation sites recorded, %d ranges'
                               % (batch.shape[0], self.act_min.shape[0]))
        self.act_min = self.ema * self.act_min + (1 - self.ema) * batch[:, 0]
        self.act_max = self.ema * self.act_max + (1 - self.ema) * batch[:, 1]
        self.batch = []
