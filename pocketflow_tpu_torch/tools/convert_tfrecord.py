"""TFRecord migration: the reference's datasets, ingested as they are (a
copy of pocketflow_tpu/tools/convert_tfrecord.py).

Inception-style ImageNet records (image/encoded JPEG + image/class/label)
become the `.npy` shards of Ilsvrc12Dataset (full-frame by default), and
SSD-style Pascal-VOC records (normalized bbox xmin/ymin/xmax/ymax + label +
difficult) the `.npz` shards of PascalVocDataset.  TensorFlow is imported
only to iterate the records and parse their Example protos, PIL only to
decode the JPEGs.

    python -m pocketflow_tpu_torch.tools.convert_tfrecord --schema=ilsvrc12 \
        --src_glob='/data/imagenet/train-*' --dst_dir=/data/ilsvrc12 \
        --subset=train
    python -m pocketflow_tpu_torch.tools.convert_tfrecord --schema=pascalvoc \
        --src_glob='/data/voc/trainval-*' --dst_dir=/data/voc_npz \
        --subset=train --image_size=300
"""

from __future__ import annotations

import argparse
import glob
import io
import os
import sys
from typing import Iterator, Tuple

import numpy as np

from pocketflow_tpu_torch.tools.convert_ilsvrc12 import _flush, process_pil_image


def _iter_examples(src_glob: str) -> Iterator:
    """Yield parsed tf.train.Example protos from a TFRecord file glob."""
    try:
        import tensorflow as tf
    except ImportError as exc:  # pragma: no cover - env without TF
        raise RuntimeError('TFRecord conversion needs the optional '
                           'tensorflow dependency') from exc
    files = sorted(glob.glob(src_glob))
    if not files:
        raise FileNotFoundError('no TFRecord files match %r' % src_glob)
    for rec in tf.data.TFRecordDataset(files):
        yield tf.train.Example.FromString(rec.numpy())


def _decode_jpeg(buf: bytes):
    from PIL import Image
    return Image.open(io.BytesIO(buf))


def convert_ilsvrc12_tfrecords(src_glob: str, dst_dir: str, subset: str,
                               resize: int = 256,
                               shard_size: int = 8192,
                               full_frame: bool = True) -> int:
    """Inception-schema ImageNet TFRecords -> `<subset>_{images,labels}_N.npy`
    shards (labels stay 1-based with 0 = background, the reference's
    convention).  full_frame (default) keeps the
    whole frame in a fixed padded container + `<subset>_extents_N.npy`, so
    on-device crops reach the full frame like the reference's Inception
    preprocessing."""
    os.makedirs(dst_dir, exist_ok=True)
    shard_idx, buf_imgs, buf_lbls, buf_ext, total = 0, [], [], [], 0
    for example in _iter_examples(src_glob):
        feat = example.features.feature
        try:
            loaded = process_pil_image(
                _decode_jpeg(feat['image/encoded'].bytes_list.value[0]),
                resize, full_frame=full_frame)
            label = int(feat['image/class/label'].int64_list.value[0])
        except Exception as exc:  # corrupt record: skip, keep converting
            print('skip record: %s' % exc, file=sys.stderr)
            continue
        if full_frame:
            img, vh, vw = loaded
            buf_ext.append((vh, vw))
        else:
            img = loaded
        buf_imgs.append(img)
        buf_lbls.append(label)
        if len(buf_imgs) >= shard_size:
            _flush(dst_dir, subset, shard_idx, buf_imgs, buf_lbls,
                   buf_ext if full_frame else None)
            total += len(buf_imgs)
            shard_idx += 1
            buf_imgs, buf_lbls, buf_ext = [], [], []
    if buf_imgs:
        _flush(dst_dir, subset, shard_idx, buf_imgs, buf_lbls,
               buf_ext if full_frame else None)
        total += len(buf_imgs)
    return total


def _voc_example_to_arrays(example, image_size: int
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    feat = example.features.feature
    img = _decode_jpeg(feat['image/encoded'].bytes_list.value[0]) \
        .convert('RGB')
    from PIL import Image
    img = np.asarray(img.resize((image_size, image_size), Image.BILINEAR),
                     np.uint8)
    xmin = feat['image/object/bbox/xmin'].float_list.value
    ymin = feat['image/object/bbox/ymin'].float_list.value
    xmax = feat['image/object/bbox/xmax'].float_list.value
    ymax = feat['image/object/bbox/ymax'].float_list.value
    labels = feat['image/object/bbox/label'].int64_list.value
    difficult = feat['image/object/bbox/difficult'].int64_list.value
    nb = len(labels)
    boxes = np.zeros((nb, 5), np.float32)
    for i in range(nb):
        boxes[i] = (float(labels[i]), ymin[i], xmin[i], ymax[i], xmax[i])
    diff = np.asarray(list(difficult) if len(difficult) == nb
                      else [0] * nb, np.uint8)
    return img, boxes, diff


def convert_pascalvoc_tfrecords(src_glob: str, dst_dir: str, subset: str,
                                image_size: int = 300,
                                shard_size: int = 2048) -> int:
    """SSD-schema VOC TFRecords -> `<subset>_NNNN.npz` shards (boxes stored
    [label, ymin, xmin, ymax, xmax] normalized + difficult flags, identical
    to tools/convert_pascalvoc.py's XML path)."""
    from pocketflow_tpu_torch.tools.convert_pascalvoc import write_npz_shard
    os.makedirs(dst_dir, exist_ok=True)
    nb_written, shard_idx = 0, 0
    images, boxes_list, diff_list = [], [], []

    def flush():
        nonlocal shard_idx, images, boxes_list, diff_list
        if not images:
            return
        write_npz_shard(dst_dir, subset, shard_idx, images, boxes_list,
                        diff_list)
        shard_idx += 1
        images, boxes_list, diff_list = [], [], []

    for example in _iter_examples(src_glob):
        try:
            img, boxes, diff = _voc_example_to_arrays(example, image_size)
        except Exception as exc:
            print('skip record: %s' % exc, file=sys.stderr)
            continue
        images.append(img)
        boxes_list.append(boxes)
        diff_list.append(diff)
        nb_written += 1
        if len(images) >= shard_size:
            flush()
    flush()
    return nb_written


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--schema', required=True,
                        choices=('ilsvrc12', 'pascalvoc'))
    parser.add_argument('--src_glob', required=True)
    parser.add_argument('--dst_dir', required=True)
    # the dataset readers find only 'train' and 'val' shards
    parser.add_argument('--subset', default='train',
                        choices=('train', 'val'))
    parser.add_argument('--resize', type=int, default=256,
                        help='ilsvrc12: short-side resize + center crop')
    parser.add_argument('--image_size', type=int, default=300,
                        help='pascalvoc: square resize')
    parser.add_argument('--shard_size', type=int, default=0,
                        help='0 = schema default (8192 / 2048)')
    args = parser.parse_args(argv)
    if args.schema == 'ilsvrc12':
        total = convert_ilsvrc12_tfrecords(
            args.src_glob, args.dst_dir, args.subset, args.resize,
            args.shard_size or 8192)
    else:
        total = convert_pascalvoc_tfrecords(
            args.src_glob, args.dst_dir, args.subset, args.image_size,
            args.shard_size or 2048)
    print('converted %d examples to %s' % (total, args.dst_dir))


if __name__ == '__main__':
    main()
