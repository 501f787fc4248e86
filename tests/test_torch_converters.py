"""The port's data converters against the JAX package's, on the CPU: every
array they write byte-equal.

* convert_ilsvrc12 on a seeded ImageFolder of 12 PIL-written JPEGs of mixed
  aspect, full-frame (the default) and --square;
* convert_pascalvoc on a 3-image VOC tree (XML + JPEG);
* convert_tfrecord, both schemas (TensorFlow imported lazily; skipped
  without it, as tests/test_tfrecord_converter.py is);
* convert_data_format; the pascalvoc maker of make_minimal_data.
"""

import io
import os
import sys
import xml.etree.ElementTree as ET

import numpy as np
import pytest

from pocketflow_tpu.config import FLAGS as JFLAGS
from pocketflow_tpu_torch.config import FLAGS as TFLAGS


@pytest.fixture(autouse=True)
def _port_flags():
    with TFLAGS.scope(**TFLAGS.as_dict()):
        yield


def _load(path):
    if path.endswith('.npy'):
        return {'': np.load(path)}
    with np.load(path, allow_pickle=True) as data:
        return {key: data[key] for key in data.files}


def _assert_same_outputs(jax_dir, port_dir):
    """The same files, each array byte-equal (object arrays element by element)."""
    names = sorted(os.listdir(jax_dir))
    assert names and names == sorted(os.listdir(port_dir))
    for name in names:
        want, got = _load(os.path.join(jax_dir, name)), _load(os.path.join(port_dir, name))
        assert sorted(want) == sorted(got), name
        for key in want:
            w, g = want[key], got[key]
            assert (g.dtype, g.shape) == (w.dtype, w.shape), (name, key)
            assert _same(g, w), (name, key)
    return names


def _same(a, b) -> bool:
    """Equal dtype, shape and bytes; object arrays element by element."""
    a, b = np.asarray(a), np.asarray(b)
    if (a.dtype, a.shape) != (b.dtype, b.shape):
        return False
    if a.dtype == object:
        return all(_same(x, y) for x, y in zip(a.ravel(), b.ravel()))
    return a.tobytes() == b.tobytes()


@pytest.fixture(scope='module')
def image_folder(tmp_path_factory):
    """12 JPEGs in 3 classes, of aspect 3:4 to 16:9 and a panorama."""
    from PIL import Image
    root = tmp_path_factory.mktemp('imagefolder')
    rng = np.random.default_rng(0)
    sizes = [(40, 30), (30, 40), (64, 36), (36, 64), (50, 50), (90, 20),
             (33, 47), (48, 27), (20, 26), (61, 45), (24, 24), (70, 31)]
    for i, (w, h) in enumerate(sizes):
        cls = root / ('n%02d' % (i % 3))
        cls.mkdir(exist_ok=True)
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(arr).save(cls / ('img%02d.jpg' % i), quality=90)
    return root


@pytest.mark.parametrize('square', [False, True])
def test_convert_ilsvrc12_matches_jax(image_folder, tmp_path, square):
    from pocketflow_tpu.tools import convert_ilsvrc12 as jcv
    from pocketflow_tpu_torch.tools import convert_ilsvrc12 as tcv
    argv = ['--src_dir=%s' % image_folder, '--subset=val', '--resize=24', '--shard_size=5'] \
        + (['--square'] if square else [])
    jcv.main(argv + ['--dst_dir=%s' % (tmp_path / 'jax')])
    tcv.main(argv + ['--dst_dir=%s' % (tmp_path / 'port')])
    names = _assert_same_outputs(tmp_path / 'jax', tmp_path / 'port')
    assert len(names) == (6 if square else 9)  # 3 shards of images, labels (, extents)
    assert tcv.container_width(24) == jcv.container_width(24) == 32
    images = np.load(tmp_path / 'port' / 'val_images_00000.npy')
    assert images.shape == ((5, 24, 24, 3) if square else (5, 24, 32, 3))
    if not square:  # the port's reader takes the full frames with their extents
        from pocketflow_tpu_torch.datasets.ilsvrc12 import Ilsvrc12Dataset
        with TFLAGS.scope(data_dir_local=str(tmp_path / 'port'), synthetic_data=False):
            _, labels = Ilsvrc12Dataset(is_train=False)._load_arrays()
        extents = np.concatenate([np.load(tmp_path / 'port' / ('val_extents_%05d.npy' % i))
                                  for i in range(3)])
        assert labels.shape == (12, 3) and (labels[:, 1:] == extents).all()


def _write_voc(root, ids=('000001', '000002', '000003')):
    from PIL import Image
    for sub in ('Annotations', 'JPEGImages', os.path.join('ImageSets', 'Main')):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    rng = np.random.default_rng(1)
    for k, image_id in enumerate(ids):
        w, h = (120, 90) if k % 2 == 0 else (80, 110)
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(root, 'JPEGImages', image_id + '.jpg'), quality=90)
        ann = ET.Element('annotation')
        size = ET.SubElement(ann, 'size')
        ET.SubElement(size, 'width').text = str(w)
        ET.SubElement(size, 'height').text = str(h)
        for cls_name, box, diff in (('dog', (11, 10, 61, 50), k == 1),
                                    ('car', (31, 21, 71, 81), False),
                                    ('unicorn', (1, 1, 5, 5), False)):
            obj = ET.SubElement(ann, 'object')
            ET.SubElement(obj, 'name').text = cls_name
            ET.SubElement(obj, 'difficult').text = '1' if diff else '0'
            bnd = ET.SubElement(obj, 'bndbox')
            for tag, value in zip(('xmin', 'ymin', 'xmax', 'ymax'), box):
                ET.SubElement(bnd, tag).text = str(value)
        ET.ElementTree(ann).write(os.path.join(root, 'Annotations', image_id + '.xml'))
    with open(os.path.join(root, 'ImageSets', 'Main', 'trainval.txt'), 'w') as fout:
        fout.write('\n'.join(ids) + '\n')


def test_convert_pascalvoc_matches_jax(tmp_path):
    from pocketflow_tpu.tools import convert_pascalvoc as jcv
    from pocketflow_tpu_torch.datasets.pascalvoc import VOC_CLASSES
    from pocketflow_tpu_torch.tools import convert_pascalvoc as tcv
    voc = str(tmp_path / 'VOC2007')
    _write_voc(voc)
    argv = ['--voc_root=%s' % voc, '--voc_image_set=trainval', '--voc_subset=train',
            '--voc_image_size=48', '--voc_shard_size=2']
    with JFLAGS.scope(**JFLAGS.as_dict()):
        assert jcv.main(argv + ['--voc_out_dir=%s' % (tmp_path / 'jax')]) == 3
    assert tcv.main(argv + ['--voc_out_dir=%s' % (tmp_path / 'port')]) == 3
    assert _assert_same_outputs(tmp_path / 'jax', tmp_path / 'port') == \
        ['train_0000.npz', 'train_0001.npz']
    assert tcv.CLASS_TO_ID == jcv.CLASS_TO_ID and tcv.CLASS_TO_ID['dog'] == \
        VOC_CLASSES.index('dog') + 1


def test_convert_data_format_matches_jax():
    from pocketflow_tpu.tools import convert_data_format as jcv
    from pocketflow_tpu_torch.tools import convert_data_format as tcv
    rng = np.random.default_rng(3)
    tree = {'conv': {'kernel': rng.normal(size=(8, 3, 5, 5)).astype(np.float32),
                     'bias': rng.normal(size=(8,)).astype(np.float32)},
            'fc': {'kernel': rng.normal(size=(12, 7)).astype(np.float32)}}
    for to_nhwc in (True, False):
        want, got = jcv.convert_tree(tree, to_nhwc), tcv.convert_tree(tree, to_nhwc)
        for layer in tree:
            for key in tree[layer]:
                assert got[layer][key].tobytes() == want[layer][key].tobytes()
                assert got[layer][key].shape == want[layer][key].shape
    dense = tree['fc']['kernel']
    assert tcv.flatten_dense_nchw_to_nhwc(dense, (2, 2, 3)).tobytes() == \
        jcv.flatten_dense_nchw_to_nhwc(dense, (2, 2, 3)).tobytes()
    kernel = tcv.nchw_kernel_to_nhwc(tree['conv']['kernel'])
    assert np.array_equal(tcv.nhwc_kernel_to_nchw(kernel), tree['conv']['kernel'])


def test_pascalvoc_maker_matches_jax(tmp_path):
    """make_minimal_data's pascalvoc maker on the ported write_npz_shard;
    the port's reader and the native sampler take its shards."""
    from pocketflow_tpu.tools import make_minimal_data as jmake
    from pocketflow_tpu_torch.datasets.pascalvoc import PascalVocDataset
    from pocketflow_tpu_torch.tools import make_minimal_data as tmake
    argv = ['--datasets=pascalvoc', '--nb_train=5', '--nb_eval=3', '--seed=2']
    jmake.main(['--dst_dir=%s' % (tmp_path / 'jax')] + argv)
    tmake.main(['--dst_dir=%s' % (tmp_path / 'port')] + argv)
    assert _assert_same_outputs(tmp_path / 'jax' / 'pascalvoc', tmp_path / 'port' / 'pascalvoc') \
        == ['train_0000.npz', 'val_0000.npz']
    with TFLAGS.scope(data_dir_local=str(tmp_path / 'port' / 'pascalvoc'), synthetic_data=False,
                      batch_size=2):
        dataset = PascalVocDataset(is_train=True)
        batch = next(dataset.build())
    assert batch['image'].shape == (2, 300, 300, 3) and batch['label'].shape[2] == 6


def _tf():
    return pytest.importorskip('tensorflow')


def _jpeg(rng, h, w):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(
        buf, format='JPEG', quality=95)
    return buf.getvalue()


@pytest.mark.parametrize('schema', ['ilsvrc12', 'pascalvoc'])
def test_convert_tfrecord_matches_jax(tmp_path, schema):
    tf = _tf()
    from pocketflow_tpu.tools import convert_tfrecord as jcv
    from pocketflow_tpu_torch.tools import convert_tfrecord as tcv

    def feature(kind, values):
        if kind == 'bytes':
            return tf.train.Feature(bytes_list=tf.train.BytesList(value=values))
        if kind == 'int':
            return tf.train.Feature(int64_list=tf.train.Int64List(value=values))
        return tf.train.Feature(float_list=tf.train.FloatList(value=values))

    rng = np.random.default_rng(4)
    path = str(tmp_path / 'records-00000')
    with tf.io.TFRecordWriter(path) as writer:
        for k in range(5):
            h, w = (30, 40) if k % 2 else (44, 25)
            feats = {'image/encoded': feature('bytes', [_jpeg(rng, h, w)])}
            if schema == 'ilsvrc12':
                feats['image/class/label'] = feature('int', [k + 1])
            else:
                feats.update({
                    'image/object/bbox/xmin': feature('float', [0.1, 0.5]),
                    'image/object/bbox/ymin': feature('float', [0.2, 0.3]),
                    'image/object/bbox/xmax': feature('float', [0.4, 0.9]),
                    'image/object/bbox/ymax': feature('float', [0.6, 0.8]),
                    'image/object/bbox/label': feature('int', [k + 1, 12]),
                    'image/object/bbox/difficult': feature('int', [0, k % 2])})
            writer.write(tf.train.Example(features=tf.train.Features(
                feature=feats)).SerializeToString())
    argv = ['--schema=%s' % schema, '--src_glob=%s' % path, '--subset=train', '--resize=24',
            '--image_size=32', '--shard_size=3']
    jcv.main(argv + ['--dst_dir=%s' % (tmp_path / 'jax')])
    tcv.main(argv + ['--dst_dir=%s' % (tmp_path / 'port')])
    names = _assert_same_outputs(tmp_path / 'jax', tmp_path / 'port')
    assert len(names) == (6 if schema == 'ilsvrc12' else 2)
    assert 'tensorflow' in sys.modules
