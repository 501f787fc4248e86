"""Model operations counted from a configuration's own layer list, so that
they are the same work whatever implements it, and the int8 kernel's bound
summed over the sites a forward runs.

A layer entry: ``p`` path, ``k`` kernel size, ``s`` stride, ``in`` [height,
channels] of its input, ``out`` channels, ``depthwise`` (one input channel
a filter), ``dense`` (a matmul on the pooled features).  'SAME' padding:
the output is ceil(height / stride) high and wide."""

from typing import Dict, List, Tuple

from pfbench import peaks


def out_size(layer: Dict) -> int:
    return 1 if layer.get('dense') else -(-layer['in'][0] // layer['s'])


def reduction(layer: Dict) -> int:
    """K of the layer's contraction: kh kw c_in (one channel a depthwise filter)."""
    if layer.get('dense'):
        return layer['in'][1]
    return layer['k'] * layer['k'] * (1 if layer.get('depthwise') else layer['in'][1])


def macs(layer: Dict) -> int:
    """Multiply-adds of one image through the layer."""
    return out_size(layer) ** 2 * layer['out'] * reduction(layer)


def flop_layers(cfg: Dict) -> List[Dict]:
    """The layers whose operations count: the published stem in place of
    the stem as it runs, where the configuration names one."""
    layers = list(cfg['layers'])
    stem = cfg.get('published_stem')
    if stem is not None:
        layers = [stem if layer['p'] == stem['p'] else layer for layer in layers]
    return layers


def forward_flops(cfg: Dict) -> int:
    """Operations (2 per multiply-add) of one image's forward: the convs and
    the dense layer."""
    return 2 * sum(macs(layer) for layer in flop_layers(cfg))


def train_flops(cfg: Dict) -> int:
    """Operations of one image's train step: the forward and the backward's
    two products a layer, 3x the forward's."""
    return 3 * forward_flops(cfg)


def int8_sites(cfg: Dict, batch: int) -> List[Tuple[str, int, int, int, int, int, int]]:
    """(path, x bytes, codes bytes, y bytes, m, n, k) of each int8 serving
    site of a bf16 forward at `batch`, as it runs (the depthwise convs stay
    in bf16).  x counts the input pixels the site reads: a strided 1x1 conv
    reads one in s*s."""
    out = []
    for layer in cfg['layers']:
        if layer.get('depthwise'):
            continue
        ho = out_size(layer)
        k, n = reduction(layer), layer['out']
        h, c = layer['in']
        read = ho if (not layer.get('dense') and layer['k'] == 1) else h
        x_bytes = 2 * batch * read * read * c
        m = batch * ho * ho
        out.append((layer['p'], x_bytes, k * n, 2 * m * n, m, n, k))
    return out


def int8_bound_ms(cfg: Dict, batch: int) -> float:
    """The least time of one forward's int8 sites, summed site by site."""
    return sum(peaks.int8_conv_bound_ms(*site[1:])[0] for site in int8_sites(cfg, batch))
