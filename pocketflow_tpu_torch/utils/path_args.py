"""path.conf parsing -> data-path flags (a copy of pocketflow_tpu/utils/path_args.py).

A `key = value` path.conf gives each dataset its data directory; the dataset
comes from the model name ('resnet_at_cifar10' -> 'cifar10') and the value
lands in FLAGS.  The port reads local disks only, so the remote-disk entries
(`data_hdfs_host`, `data_dir_hdfs_*`) are not applied; `data_disk` is, and a
dataset refuses any disk but `local` when it reads its files.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from pocketflow_tpu_torch.config import FLAGS

FLAGS.DEFINE_string('path_conf', './path.conf', 'path configuration file')


def parse_path_conf(path: str) -> Dict[str, str]:
    """Parse `key = value` lines; '#' comments and blanks ignored."""
    conf = {}
    if not os.path.exists(path):
        return conf
    with open(path) as fin:
        for line in fin:
            line = line.split('#', 1)[0].strip()
            if not line or '=' not in line:
                continue
            key, _, value = line.partition('=')
            conf[key.strip()] = value.strip()
    return conf


def dataset_of(model_name: str) -> str:
    """'resnet_at_cifar10' -> 'cifar10'."""
    return model_name.rsplit('_at_', 1)[-1]


def apply_path_conf(model_name: str, conf_path: Optional[str] = None):
    """Set data_dir_local (unless given) and data_disk for the model's dataset."""
    conf = parse_path_conf(conf_path or FLAGS.path_conf)
    if not conf:
        return
    key_local = 'data_dir_local_%s' % dataset_of(model_name)
    if key_local in conf and FLAGS.get('data_dir_local') is None:
        FLAGS.override(data_dir_local=conf[key_local])
    if 'data_disk' in conf:
        FLAGS.override(data_disk=conf['data_disk'])
