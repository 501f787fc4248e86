"""Checkpoint metadata sidecar (a copy of pocketflow_tpu/tools/add_metadata.py).

The reference patches old checkpoints with the `images_final`/`logits_final`
graph collections its export tools key on; here the same facts (model name,
input shape, output spec) live in a JSON sidecar beside the checkpoint.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional


def add_metadata(ckpt_path: str, model_name: str, dataset_name: str,
                 input_shape, nb_classes: int,
                 extra: Optional[Dict[str, Any]] = None) -> str:
    """Write `<ckpt>.meta.json` describing the serving interface."""
    meta = {
        'model_name': model_name,
        'dataset_name': dataset_name,
        'input_shape': list(input_shape),   # images_final analogue
        'nb_classes': int(nb_classes),      # logits_final analogue
        'data_format': 'NHWC',
    }
    if extra:
        meta.update(extra)
    path = ckpt_path + '.meta.json'
    with open(path, 'w') as fout:
        json.dump(meta, fout, indent=2)
    return path


def read_metadata(ckpt_path: str) -> Optional[Dict[str, Any]]:
    path = ckpt_path + '.meta.json'
    if not os.path.exists(path):
        return None
    with open(path) as fin:
        return json.load(fin)
