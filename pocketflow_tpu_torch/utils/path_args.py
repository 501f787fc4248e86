"""path.conf parsing -> data-path flags (a copy of pocketflow_tpu/utils/path_args.py).

A `key = value` path.conf gives each dataset its data directory; the dataset
comes from the model name ('resnet_at_cifar10' -> 'cifar10') and the values
land in FLAGS: `data_dir_local_<dataset>`, `data_disk`, and for
`data_disk = hdfs` the remote entries `data_hdfs_host` and
`data_dir_hdfs_<dataset>` (``datasets/remote_fs.py`` stages them).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.datasets import remote_fs  # noqa: F401  (registers data_dir_hdfs)

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
    """Set data_dir_local and data_dir_hdfs (each unless given), data_disk
    and data_hdfs_host for the model's dataset."""
    conf = parse_path_conf(conf_path or FLAGS.path_conf)
    if not conf:
        return
    dataset = dataset_of(model_name)
    key_local = 'data_dir_local_%s' % dataset
    if key_local in conf and FLAGS.get('data_dir_local') is None:
        FLAGS.override(data_dir_local=conf[key_local])
    if 'data_disk' in conf:
        FLAGS.override(data_disk=conf['data_disk'])
    if conf.get('data_hdfs_host'):
        FLAGS.override(data_hdfs_host=conf['data_hdfs_host'])
    key_hdfs = 'data_dir_hdfs_%s' % dataset
    if conf.get(key_hdfs) and FLAGS.get('data_dir_hdfs') is None:
        FLAGS.override(data_dir_hdfs=conf[key_hdfs])
