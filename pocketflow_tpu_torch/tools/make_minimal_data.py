"""Write minimal datasets in their real on-disk formats, with no network
(a copy of pocketflow_tpu/tools/make_minimal_data.py), so the real-data
readers run on files of the right format:

* cifar10:  `data_batch_{1..5}.bin` + `test_batch.bin` fixed-length records
            (1 label byte + 3072 CHW uint8 bytes);
* ilsvrc12: `{train,val}_{images,labels}_00000.npy` shards.

    python -m pocketflow_tpu_torch.tools.make_minimal_data --dst_dir=/tmp/minimal \
        [--datasets=cifar10,ilsvrc12] [--nb_train=256 --nb_eval=64]

Then e.g.:

    python -m pocketflow_tpu_torch.main --model=resnet_at_cifar10 --learner=full-prec \
        --data_dir_local=/tmp/minimal/cifar10
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def make_cifar10(dst_dir: str, nb_train: int, nb_eval: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    os.makedirs(dst_dir, exist_ok=True)

    def write_bin(path, nb):
        records = []
        for _ in range(nb):
            label = rng.integers(0, 10, dtype=np.uint8)
            # class-conditioned mean so the set is learnable, CHW layout
            image = (rng.normal(80 + 10 * int(label), 40, (3, 32, 32))
                     .clip(0, 255).astype(np.uint8))
            records.append(bytes([label]) + image.tobytes())
        with open(path, 'wb') as fout:
            fout.write(b''.join(records))

    per_file = max(1, nb_train // 5)
    for idx in range(5):
        write_bin(os.path.join(dst_dir, 'data_batch_%d.bin' % (idx + 1)),
                  per_file)
    write_bin(os.path.join(dst_dir, 'test_batch.bin'), nb_eval)


def make_ilsvrc12(dst_dir: str, nb_train: int, nb_eval: int, seed: int = 0,
                  image_size: int = 256, nb_classes: int = 10):
    rng = np.random.default_rng(seed)
    os.makedirs(dst_dir, exist_ok=True)
    for subset, nb in (('train', nb_train), ('val', nb_eval)):
        labels = rng.integers(1, nb_classes + 1, nb).astype(np.int32)
        images = (rng.normal(
            70 + 12 * labels[:, None, None, None], 45,
            (nb, image_size, image_size, 3)).clip(0, 255).astype(np.uint8))
        np.save(os.path.join(dst_dir, '%s_images_00000.npy' % subset), images)
        np.save(os.path.join(dst_dir, '%s_labels_00000.npy' % subset), labels)


def make_pascalvoc(dst_dir: str, nb_train: int, nb_eval: int, seed: int = 0,
                   image_size: int = 300):
    """Pascal VOC `.npz` shards need the converter's writer (`write_npz_shard`)."""
    raise NotImplementedError(
        "the pascalvoc maker needs tools/convert_pascalvoc.py's write_npz_shard, not ported "
        "yet (ROADMAP 'Modules to port', item 25)")


MAKERS = {'cifar10': make_cifar10, 'ilsvrc12': make_ilsvrc12,
          'pascalvoc': make_pascalvoc}


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--dst_dir', required=True)
    parser.add_argument('--datasets', default='cifar10,ilsvrc12')
    parser.add_argument('--nb_train', type=int, default=256)
    parser.add_argument('--nb_eval', type=int, default=64)
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args(argv)
    for name in args.datasets.split(','):
        name = name.strip()
        if name not in MAKERS:
            raise ValueError('unknown dataset %r (choose from %s)'
                             % (name, sorted(MAKERS)))
        out = os.path.join(args.dst_dir, name)
        MAKERS[name](out, args.nb_train, args.nb_eval, args.seed)
        print('minimal %s written to %s' % (name, out))


if __name__ == '__main__':
    main()
