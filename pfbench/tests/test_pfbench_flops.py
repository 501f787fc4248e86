"""The operation and bound counts against counts made by hand."""

import json
import os

import pytest

from pfbench import flops, peaks


def config(root, name):
    with open(os.path.join(root, 'pfbench', 'configs', name + '.json')) as fin:
        return json.load(fin)


def resnet50_macs_by_hand():
    """ResNet-50 v1.5 at 224: the 7x7 stem, each stage's bottlenecks
    (stride on the 3x3, a projection on the first block), the classifier."""
    total = 7 * 7 * 3 * 64 * 112 * 112
    h, cin = 56, 64
    for stage, blocks in enumerate((3, 4, 6, 3)):
        w = 64 * 2 ** stage
        for b in range(blocks):
            s = 2 if (stage and not b) else 1
            ho = h // s
            total += h * h * cin * w                  # 1x1 reduce
            total += ho * ho * 9 * w * w              # 3x3
            total += ho * ho * w * 4 * w              # 1x1 expand
            if b == 0:
                total += ho * ho * cin * 4 * w        # projection
            h, cin = ho, 4 * w
    return total + 2048 * 1000


def mobilenet_v1_macs_by_hand():
    total = 3 * 3 * 3 * 32 * 112 * 112
    h, c = 112, 32
    for f, s in ((64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2)) + ((512, 1),) * 5 \
            + ((1024, 2), (1024, 1)):
        h //= s
        total += h * h * 9 * c + h * h * c * f
        c = f
    return total + 1024 * 1000


def test_resnet50(root):
    cfg = config(root, 'resnet50')
    assert flops.forward_flops(cfg) == 2 * resnet50_macs_by_hand()
    assert flops.train_flops(cfg) == 6 * resnet50_macs_by_hand()
    assert 4.05e9 < resnet50_macs_by_hand() < 4.15e9  # v1.5's 4.1 GMACs


def test_mobilenet_v1(root):
    cfg = config(root, 'mobilenet_v1')
    assert flops.forward_flops(cfg) == 2 * mobilenet_v1_macs_by_hand()
    assert round(mobilenet_v1_macs_by_hand() / 1e6) == 569  # the paper's 569M mult-adds


@pytest.mark.parametrize('name, sites', [('resnet50', 54), ('mobilenet_v1', 15)])
def test_int8_sites(root, name, sites):
    assert len(flops.int8_sites(config(root, name), 256)) == sites


def test_int8_bound_of_one_site(root):
    cfg = config(root, 'resnet50')
    site = dict((s[0], s) for s in flops.int8_sites(cfg, 256))['stage1_block0/conv1']
    m = 256 * 56 * 56
    nbytes = 2 * m * 64 + 64 * 64 + 2 * m * 64
    assert site[1:] == (2 * m * 64, 64 * 64, 2 * m * 64, m, 64, 64)
    want = max(nbytes / 3.35e12, 2 * m * 64 * 64 / 1979e12) * 1e3
    assert peaks.int8_conv_bound_ms(*site[1:])[0] == pytest.approx(want, rel=1e-12)
    strided = dict((s[0], s) for s in flops.int8_sites(cfg, 256))['stage2_block0/conv_sc']
    assert strided[1] == 2 * 256 * 28 * 28 * 256  # a stride-2 1x1 reads one pixel in four
