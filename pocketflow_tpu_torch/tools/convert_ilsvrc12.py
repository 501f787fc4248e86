"""ILSVRC-12 converter: ImageFolder -> .npy shards for Ilsvrc12Dataset
(a copy of pocketflow_tpu/tools/convert_ilsvrc12.py; the shards it writes are
the JAX package's, byte for byte).

    python -m pocketflow_tpu_torch.tools.convert_ilsvrc12 \
        --src_dir=/data/imagenet/train --dst_dir=/data/ilsvrc12 \
        --subset=train --resize=256 --shard_size=8192

Default storage is full-frame: each image is scaled to fit a fixed
[resize, resize*4/3] container (the whole frame kept, zero-padded, with a
per-sample valid-extent table in `<subset>_extents_N.npy`), so the on-device
distorted crop can reach the entire original frame, as Inception's
`sample_distorted_bounding_box` preprocessing does.  `--square` stores the
center square instead (smaller shards, no extents).  PIL is imported only
to decode images.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import List, Optional, Tuple

import numpy as np

# container aspect for full-frame storage: width = resize * 4/3 covers the
# whole frame of any image (wider/taller frames are scaled down to fit, not
# cropped), matching Inception preprocessing's reachable crop space
FULL_FRAME_ASPECT = 4.0 / 3.0


def container_width(resize: int) -> int:
    return int(round(resize * FULL_FRAME_ASPECT))


def _load_image(path: str, resize: int, full_frame: bool):
    from PIL import Image
    return process_pil_image(Image.open(path), resize, full_frame=full_frame)


def process_pil_image(img, resize: int, full_frame: bool = False):
    """Decode a PIL image into shard storage (shared with the TFRecord
    migration converter, tools/convert_tfrecord.py).

    full_frame=False: short-side resize + square center crop -> uint8 HWC.
    full_frame=True : scale the WHOLE frame to fit [resize, resize*4/3],
    paste at the top-left of a zero canvas, and return
    (canvas, valid_h, valid_w).
    """
    from PIL import Image
    img = img.convert('RGB')
    w, h = img.size
    if full_frame:
        cw = container_width(resize)
        scale = min(resize / h, cw / w)
        vw = max(1, min(cw, int(round(w * scale))))
        vh = max(1, min(resize, int(round(h * scale))))
        img = img.resize((vw, vh), Image.BILINEAR)
        canvas = np.zeros((resize, cw, 3), np.uint8)
        canvas[:vh, :vw] = np.asarray(img, np.uint8)
        return canvas, vh, vw
    scale = resize / min(w, h)
    img = img.resize((max(resize, int(round(w * scale))),
                      max(resize, int(round(h * scale)))), Image.BILINEAR)
    # center-crop to a square `resize` so shards are uniform
    w, h = img.size
    left, top = (w - resize) // 2, (h - resize) // 2
    img = img.crop((left, top, left + resize, top + resize))
    return np.asarray(img, np.uint8)


def convert_imagefolder(src_dir: str, dst_dir: str, subset: str,
                        resize: int = 256, shard_size: int = 8192,
                        full_frame: bool = True) -> int:
    classes = sorted(d for d in os.listdir(src_dir)
                     if os.path.isdir(os.path.join(src_dir, d)))
    class_to_idx = {c: i + 1 for i, c in enumerate(classes)}  # 0 = background
    samples: List[Tuple[str, int]] = []
    for cls in classes:
        for path in sorted(glob.glob(os.path.join(src_dir, cls, '*'))):
            samples.append((path, class_to_idx[cls]))
    os.makedirs(dst_dir, exist_ok=True)

    shard_idx, buf_imgs, buf_lbls, buf_ext, total = 0, [], [], [], 0
    for path, label in samples:
        try:
            loaded = _load_image(path, resize, full_frame)
        except Exception as exc:  # unreadable image: skip, keep converting
            print('skip %s: %s' % (path, exc), file=sys.stderr)
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


def _flush(dst_dir, subset, shard_idx, images, labels,
           extents: Optional[list] = None):
    np.save(os.path.join(dst_dir, '%s_images_%05d.npy' % (subset, shard_idx)),
            np.stack(images))
    np.save(os.path.join(dst_dir, '%s_labels_%05d.npy' % (subset, shard_idx)),
            np.asarray(labels, np.int32))
    if extents is not None:
        np.save(os.path.join(dst_dir, '%s_extents_%05d.npy' % (subset, shard_idx)),
                np.asarray(extents, np.int32))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--src_dir', required=True)
    parser.add_argument('--dst_dir', required=True)
    parser.add_argument('--subset', default='train', choices=('train', 'val'))
    parser.add_argument('--resize', type=int, default=256)
    parser.add_argument('--shard_size', type=int, default=8192)
    parser.add_argument('--square', action='store_true',
                        help='legacy center-square storage (no extents)')
    args = parser.parse_args(argv)
    total = convert_imagefolder(args.src_dir, args.dst_dir, args.subset,
                                args.resize, args.shard_size,
                                full_frame=not args.square)
    print('converted %d images to %s' % (total, args.dst_dir))


if __name__ == '__main__':
    main()
