"""The data disk: ``--data_disk=local`` or ``hdfs``
(counterpart of pocketflow_tpu/datasets/remote_fs.py).

``local`` reads ``--data_dir_local`` in place.  ``hdfs`` stages the remote
directory ``data_hdfs_host + data_dir_hdfs`` once into a local cache and
points the readers there: through the ``hdfs dfs`` (or ``hadoop fs``) CLI for
an ``hdfs://`` host, by a copy for a ``file://`` host.  The cache's key is a
hash of the remote URL, so a second run, or a second resolve in one run,
stages nothing.

On each filesystem one process stages (an election on a lock directory);
the others wait for its copy, up to ``--data_stage_timeout`` seconds.  Then
every process meets at the group's barrier (``core/mesh.py``), and a process
that finds no local copy after it refuses to continue.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.core import mesh
from pocketflow_tpu_torch.core.metrics import get_logger

FLAGS.DEFINE_string('data_dir_hdfs', None,
                    'data directory on the remote disk (joined to '
                    '--data_hdfs_host, reference cifar10_dataset.py:92)')
FLAGS.DEFINE_string('data_cache_dir', None,
                    'local cache for staged remote data '
                    '(default ~/.cache/pocketflow_tpu)')
FLAGS.DEFINE_float('data_stage_timeout', 3600.0,
                   'seconds a process waits for another process on the same '
                   'host to finish staging remote data')

# remote URL -> staged local directory: each URL's barrier runs once a process
_RESOLVED: dict = {}


def _cache_root() -> str:
    return FLAGS.get('data_cache_dir') or os.path.join(
        os.path.expanduser('~'), '.cache', 'pocketflow_tpu')


def _stage(remote_url: str, dst: str):
    """Copy the directory `remote_url` to `dst` with its scheme's tool."""
    tmp = dst + '.staging'
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    if remote_url.startswith('file://'):
        src = remote_url[len('file://'):]
        if not os.path.isdir(src):
            raise FileNotFoundError('remote data dir not found: %s' % remote_url)
        shutil.copytree(src, tmp)
    elif remote_url.startswith('hdfs://'):
        hdfs_cli = shutil.which('hdfs') or shutil.which('hadoop')
        if hdfs_cli is None:
            raise RuntimeError(
                'data_disk=hdfs needs the `hdfs` (or `hadoop`) CLI on PATH to stage %s; '
                'install a Hadoop client or copy the data locally and use data_disk=local'
                % remote_url)
        sub = ['dfs'] if os.path.basename(hdfs_cli) == 'hdfs' else ['fs']
        os.makedirs(tmp, exist_ok=True)
        subprocess.run([hdfs_cli, *sub, '-copyToLocal', remote_url + '/*', tmp], check=True)
    else:
        raise ValueError('unsupported remote data scheme: %s (expected hdfs:// or file://)'
                         % remote_url)
    if os.path.exists(dst):  # another process on this host got there first
        shutil.rmtree(tmp)
    else:
        os.replace(tmp, dst)
    get_logger().info('staged remote data %s -> %s', remote_url, dst)


def _stage_elected(remote_url: str, dst: str):
    """One process a filesystem stages (it made the lock directory); the
    others wait until the copy is there and the lock gone."""
    os.makedirs(_cache_root(), exist_ok=True)
    lock = dst + '.lock'
    try:
        os.mkdir(lock)
    except FileExistsError:
        deadline = time.time() + float(FLAGS.get('data_stage_timeout') or 3600.0)
        while time.time() < deadline:
            if os.path.isdir(dst) and not os.path.exists(lock):
                return
            time.sleep(0.5)
        raise RuntimeError(
            'timed out waiting for another process to stage %s into %s (stale lock %s from '
            'a crashed run? remove it and retry)' % (remote_url, dst, lock))
    try:
        if not os.path.isdir(dst):
            _stage(remote_url, dst)
    finally:
        os.rmdir(lock)


def resolve_data_dir() -> Optional[str]:
    """The local directory of the configured data disk: ``--data_dir_local``
    for ``local``; for ``hdfs``, the staged copy of the remote directory (the
    same path on every process)."""
    disk = FLAGS.get('data_disk') or 'local'
    if disk == 'local':
        return FLAGS.get('data_dir_local')
    if disk != 'hdfs':
        raise ValueError('unrecognized data disk: ' + disk)
    host, rdir = FLAGS.get('data_hdfs_host'), FLAGS.get('data_dir_hdfs')
    if not host or not rdir:
        raise ValueError('data_disk=hdfs requires both --data_hdfs_host and --data_dir_hdfs')
    remote_url = host.rstrip('/') + '/' + rdir.lstrip('/')
    if remote_url in _RESOLVED:
        return _RESOLVED[remote_url]
    dst = os.path.join(_cache_root(), hashlib.sha1(remote_url.encode()).hexdigest()[:16])
    if not os.path.isdir(dst):
        _stage_elected(remote_url, dst)
    # every process meets here, whether it staged or found the cache: a
    # barrier only some processes reach would hang the others
    mesh.auto_barrier()
    if not os.path.isdir(dst):
        raise RuntimeError(
            'remote data staging left no local copy at %s on this host; refusing to continue '
            '(the other processes read %s)' % (dst, remote_url))
    _RESOLVED[remote_url] = dst
    return dst
