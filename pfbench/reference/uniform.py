"""UniformQuantLearner's recipe: every conv and dense kernel but the first
and the last fake-quantized per tensor at ``weight_bits`` (min/max,
straight-through gradient); activations at 32 bits pass as they are."""

from __future__ import annotations

from typing import Dict

import torch

from pfbench.reference import quant


class Recipe:
    def __init__(self, cfg: Dict, traffic: Dict):
        bits = traffic['recipe_args']
        self.weight_bits = int(bits['weight_bits'])
        self.activation_bits = int(bits.get('activation_bits', 32))
        paths = [layer['p'] for layer in cfg['layers']]
        self.quantized = set(paths[1:-1])

    def weight_fn(self, path: str, w: torch.Tensor) -> torch.Tensor:
        if path not in self.quantized:
            return w
        return quant.minmax_quantize(w, self.weight_bits, per_channel=False)

    def act_fn(self, index: int, y: torch.Tensor) -> torch.Tensor:
        if self.activation_bits >= 32:
            return y
        return quant.minmax_quantize(y, self.activation_bits, per_channel=False)

    def extra_leaves(self) -> Dict[str, torch.Tensor]:
        return {}

    def after_update(self):
        pass
