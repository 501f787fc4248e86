"""The host's shard pipeline at ImageNet scale (counterpart of
experiments/streaming_bench.py).

It writes a synthetic shard set (224x224x3 uint8 rows in ``.npy`` shards of
8,192, ``--gb`` GiB in all, labels beside them) and iterates it through the
production path, ``Ilsvrc12Dataset -> ShardedView -> NativeSampler`` (the
native pread sampler, which it requires), reporting host images/s, MB/s and
the process's peak resident memory, beside the host's RAM and the free disk
where the shards live.  A set that does not fit the free disk is cut to
what fits, and the cut is reported.  Without ``--root`` the shards go to a
temporary directory that is removed at the end.

    python -m pocketflow_tpu_torch.experiments.streaming_bench [--gb 32] [--batches 400]

It touches no device: it measures the host's pipeline.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import tempfile
import time

import numpy as np

ROW = 224 * 224 * 3  # bytes a sample
PER_SHARD = 8192
DISK_MARGIN = 0.9  # the share of the free disk a set may take


def make_shards(root: str, total_gb: float, per_shard: int = PER_SHARD) -> int:
    """Write the shard set (kept where it exists); returns its samples."""
    os.makedirs(root, exist_ok=True)
    n_total = int(total_gb * 2 ** 30 // ROW)
    rng = np.random.default_rng(0)
    # one template, written with a per-shard offset: fast to make, and
    # incompressible enough that the page cache cannot cheat
    template = rng.integers(0, 255, size=(min(per_shard, n_total), 224, 224, 3), dtype=np.uint8)
    written = idx = 0
    while written < n_total:
        n = min(per_shard, n_total - written)
        path = os.path.join(root, 'train_images_%04d.npy' % idx)
        if not os.path.exists(path):
            np.save(path, template[:n] + np.uint8(idx % 7))
        lbl = os.path.join(root, 'train_labels_%04d.npy' % idx)
        if not os.path.exists(lbl):
            np.save(lbl, rng.integers(0, 1000, size=(n,), dtype=np.int64))
        written += n
        idx += 1
    return n_total


def rss_gb() -> float:
    """The process's peak resident memory (GiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def host_memory_gb() -> dict:
    """MemTotal and MemAvailable (GiB) from /proc/meminfo, where it exists."""
    out = {}
    try:
        with open('/proc/meminfo') as fin:
            for line in fin:
                key, value = line.split(':', 1)
                if key in ('MemTotal', 'MemAvailable'):
                    out[key] = int(value.split()[0]) / 2 ** 20
    except OSError:
        pass
    return out


def fitting_gb(root: str, gb: float) -> float:
    """`gb`, or the largest size that fits DISK_MARGIN of the free disk
    under `root` with the shards already there."""
    have = sum(os.path.getsize(os.path.join(root, f)) for f in os.listdir(root)
               if f.endswith('.npy'))
    room = (shutil.disk_usage(root).free + have) * DISK_MARGIN / 2 ** 30
    return min(gb, room)


def run(gb: float = 32.0, batches: int = 400, batch_size: int = 256, root=None,
        per_shard: int = PER_SHARD, nb_warmup: int = 8) -> dict:
    """Write (or reuse) the set and stream `batches` batches; returns the
    figures."""
    from pocketflow_tpu_torch.config import FLAGS
    from pocketflow_tpu_torch.datasets.ilsvrc12 import Ilsvrc12Dataset
    from pocketflow_tpu_torch.datasets.native_loader import NativeSampler
    temporary = root is None
    root = root or tempfile.mkdtemp(prefix='pf_stream_shards_')
    try:
        os.makedirs(root, exist_ok=True)
        size_gb = fitting_gb(root, gb)
        start = time.perf_counter()
        n = make_shards(root, size_gb, per_shard)
        out = {'asked_gb': gb, 'gb': n * ROW / 2 ** 30, 'images': n, 'cut': size_gb < gb,
               'write_s': time.perf_counter() - start, 'host_memory_gb': host_memory_gb(),
               'disk_free_gb': shutil.disk_usage(root).free / 2 ** 30}
        print('shard set: %d images (%.1f GB%s) ready in %.1f s; host RAM %s GiB, %.1f GiB '
              'free on its disk' % (n, out['gb'], ', cut from %.1f' % gb if out['cut'] else '',
                                    out['write_s'], {k: round(v, 1) for k, v in
                                                     out['host_memory_gb'].items()},
                                    out['disk_free_gb']), flush=True)
        with FLAGS.scope(data_dir_local=root, batch_size=batch_size,
                         synthetic_data=False, nb_smpls_train=n):
            it = Ilsvrc12Dataset(is_train=True).build()
            print('iterator: %s' % type(it).__name__, flush=True)
            if not isinstance(it, NativeSampler):
                raise RuntimeError('the native pread sampler is required, got %s'
                                   % type(it).__name__)
            try:
                for _ in range(nb_warmup):  # fill the prefetch queue
                    next(it)
                start = time.perf_counter()
                for _ in range(batches):
                    batch = next(it)
                elapsed = time.perf_counter() - start
            finally:
                it.close()
        if tuple(batch['image'].shape) != (batch_size, 224, 224, 3):
            raise RuntimeError('batch of shape %s' % (batch['image'].shape,))
        imgs = batches * batch_size
        out.update({'streamed': imgs, 'seconds': elapsed, 'img_s': imgs / elapsed,
                    'mb_s': imgs * ROW / elapsed / 2 ** 20, 'peak_rss_gb': rss_gb()})
        print('streamed %d images in %.1f s -> %.0f img/s host-side, %.0f MB/s; peak RSS '
              '%.2f GB' % (imgs, elapsed, out['img_s'], out['mb_s'], out['peak_rss_gb']),
              flush=True)
        return out
    finally:
        if temporary:
            shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--gb', type=float, default=32.0)
    parser.add_argument('--batches', type=int, default=400)
    parser.add_argument('--batch_size', type=int, default=256)
    parser.add_argument('--root', default=None,
                        help='the shard directory, kept (default: a temporary one, removed)')
    args = parser.parse_args(argv)
    out = run(args.gb, args.batches, args.batch_size, args.root)
    print(json.dumps(out), flush=True)
    return out


if __name__ == '__main__':
    main()
