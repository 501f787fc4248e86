"""Convert a Pascal-VOC tree (JPEG + XML) into the `.npz` shards of
``datasets/pascalvoc.py`` (a copy of pocketflow_tpu/tools/convert_pascalvoc.py).

It walks a ``VOCdevkit/VOC2007``-style tree, parses the XML annotations with
the stdlib ElementTree, decodes and resizes the JPEGs with PIL (imported
lazily), and writes shards of

    images: uint8 [N, S, S, 3]
    boxes:  object array of per-image float32 [n_i, 5] =
            [class_id (1..20), ymin, xmin, ymax, xmax]   (normalized)
    difficult: object array of per-image uint8 [n_i] flags (the VOC eval
            protocol ignores difficult ground truth)

    python -m pocketflow_tpu_torch.tools.convert_pascalvoc \
        --voc_root=/data/VOCdevkit/VOC2007 --voc_image_set=trainval \
        --voc_subset=train --voc_out_dir=/data/voc_npz [--voc_image_size=300]

Boxes marked ``difficult`` are kept with their flag: the eval excludes them
from mAP scoring, train sampling may still see them.
"""

from __future__ import annotations

import os
import sys
import xml.etree.ElementTree as ET
from typing import List, Optional, Tuple

import numpy as np

from pocketflow_tpu_torch.datasets.pascalvoc import VOC_CLASSES

CLASS_TO_ID = {name: idx + 1 for idx, name in enumerate(VOC_CLASSES)}


def parse_annotation(xml_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Parse one VOC XML file -> (boxes [n, 5] normalized, difficult [n])."""
    root = ET.parse(xml_path).getroot()
    size = root.find('size')
    height = float(size.find('height').text)
    width = float(size.find('width').text)
    boxes: List[List[float]] = []
    difficult: List[int] = []
    for obj in root.findall('object'):
        name = obj.find('name').text.strip().lower()
        if name not in CLASS_TO_ID:
            continue
        bnd = obj.find('bndbox')
        # VOC pixel coords are 1-based inclusive
        xmin = (float(bnd.find('xmin').text) - 1.0) / width
        ymin = (float(bnd.find('ymin').text) - 1.0) / height
        xmax = (float(bnd.find('xmax').text) - 1.0) / width
        ymax = (float(bnd.find('ymax').text) - 1.0) / height
        boxes.append([CLASS_TO_ID[name],
                      max(ymin, 0.0), max(xmin, 0.0),
                      min(ymax, 1.0), min(xmax, 1.0)])
        diff = obj.find('difficult')
        difficult.append(int(diff.text) if diff is not None else 0)
    if not boxes:
        return (np.zeros((0, 5), np.float32), np.zeros((0,), np.uint8))
    return (np.asarray(boxes, np.float32),
            np.asarray(difficult, np.uint8))


def load_image(jpeg_path: str, image_size: int) -> np.ndarray:
    from PIL import Image
    with Image.open(jpeg_path) as img:
        img = img.convert('RGB').resize((image_size, image_size),
                                        Image.BILINEAR)
        return np.asarray(img, np.uint8)


def write_npz_shard(out_dir: str, subset: str, shard_idx: int, images,
                    boxes_list, diff_list) -> str:
    """One `<subset>_NNNN.npz` shard — the single definition of the VOC
    shard format (shared with tools/convert_tfrecord.py)."""
    path = os.path.join(out_dir, '%s_%04d.npz' % (subset, shard_idx))
    np.savez_compressed(path, images=np.stack(images),
                        boxes=np.asarray(boxes_list, object),
                        difficult=np.asarray(diff_list, object))
    return path


def convert(voc_root: str, image_set: str, subset: str, out_dir: str,
            image_size: int = 300, shard_size: int = 2048,
            limit: Optional[int] = None) -> int:
    """Convert `image_set` (e.g. 'trainval'/'test') to `<subset>_NNNN.npz`."""
    set_file = os.path.join(voc_root, 'ImageSets', 'Main', image_set + '.txt')
    with open(set_file) as fin:
        ids = [line.split()[0] for line in fin if line.strip()]
    if limit:
        ids = ids[:limit]
    os.makedirs(out_dir, exist_ok=True)
    nb_written, shard_idx = 0, 0
    images, boxes_list, diff_list = [], [], []

    def flush():
        nonlocal shard_idx, images, boxes_list, diff_list
        if not images:
            return
        write_npz_shard(out_dir, subset, shard_idx, images, boxes_list,
                        diff_list)
        shard_idx += 1
        images, boxes_list, diff_list = [], [], []

    for image_id in ids:
        xml_path = os.path.join(voc_root, 'Annotations', image_id + '.xml')
        jpg_path = os.path.join(voc_root, 'JPEGImages', image_id + '.jpg')
        if not (os.path.exists(xml_path) and os.path.exists(jpg_path)):
            continue
        boxes, difficult = parse_annotation(xml_path)
        images.append(load_image(jpg_path, image_size))
        boxes_list.append(boxes)
        diff_list.append(difficult)
        nb_written += 1
        if len(images) >= shard_size:
            flush()
    flush()
    return nb_written


def main(argv=None):
    from pocketflow_tpu_torch.config import FLAGS
    from pocketflow_tpu_torch.core.metrics import get_logger
    FLAGS.DEFINE_string('voc_root', None, 'VOCdevkit/VOC20xx directory')
    FLAGS.DEFINE_string('voc_image_set', 'trainval',
                        'ImageSets/Main file (trainval | test | ...)')
    FLAGS.DEFINE_string('voc_subset', 'train',
                        "output shard prefix: 'train' | 'val'")
    FLAGS.DEFINE_string('voc_out_dir', './voc_npz', 'output directory')
    FLAGS.DEFINE_integer('voc_shard_size', 2048, 'images per shard')
    FLAGS.DEFINE_integer('voc_limit', None, 'convert at most N images')
    FLAGS.parse_args(argv)
    size = int(FLAGS.get('voc_image_size') or 300)
    nb = convert(FLAGS.voc_root, FLAGS.voc_image_set, FLAGS.voc_subset,
                 FLAGS.voc_out_dir, image_size=size,
                 shard_size=FLAGS.voc_shard_size, limit=FLAGS.get('voc_limit'))
    get_logger().info('converted %d images to %s', nb, FLAGS.voc_out_dir)
    return nb


if __name__ == '__main__':
    main(sys.argv[1:])
