"""Smoke run of the PyTorch port on one NVIDIA GPU: python3 chip_smoke.py
(``--phase31``, ``--phase32``: phase 31 or 32 alone, with no result line)

Builds the port's CUDA kernels from pocketflow_tpu_torch/csrc (one nvcc per
source, all started together), holds each against its plain PyTorch version
on the card, and drives the port's paths:

  * the main path: the QAT ResNet-50 train step of UniformQuantLearner at
    bench.py's settings (224x224, bf16, batch 256, exact BN, space-to-depth
    stem, synthetic ILSVRC-12, 4-bit weights), and its other quantization
    routes (8-bit activations, channel and split buckets), each timed over
    5 steps after 2;
  * the three matmul experiments (pocketflow_tpu_torch/experiments:
    fused_mm_proto, conv1x1_ab, mm_shape_sweep), short, at full shapes;
  * the composed pruned+QAT step of bench.py (channel masks, masked
    gradients, a re-zero after each update) at the main path's settings;
  * the model zoo through main.main at full width: ResNet-20 @ CIFAR-10 at
    batch 128 on CIFAR-10 .bin files written by make_minimal_data, full-prec
    (run A, the teacher) then QAT with distillation (B: 4-bit weights; C: and
    8-bit activations; D: channel buckets), ConvNet @ FMNIST and LeNet @
    CIFAR-10 under QAT, each with its launches counted per quantized forward
    (a global forward hook), its loss and eval metrics; runs A and B timed;
  * the RL searches: a DDPG update on the card against the same update on
    the CPU; weight sparsification through main.main (ResNet-20 @ CIFAR-10
    from run A's baseline under the uniform protocol, run G, and the optimal
    one, run H, a 2-roll-out DDPG search; ConvNet @ FMNIST uniform, run J),
    each ending at its pruning ratio with every masked weight 0 and no kernel
    launched; the uniform learner's RL bit search through main.main (run I:
    2 roll-outs, each a copy of the baseline at the agent's per-layer bits,
    layerwise-tuned and finetuned, then the finetune at the chosen bits),
    with mixed bit widths in one grouped K1' launch pair a quantized forward;
    a WS step with and without a mask refresh, a WS roll-out's steps,
    masking.prune_update on ResNet-50's kernels and a bit-search roll-out
    timed;
  * MobileNet @ ILSVRC-12 through main.main at full width (224x224, bf16,
    batch 256): run K, the uniform-tf learner on v1 (8/8 bits, no launch
    before its quant delay, then one grouped K2' launch pair a forward for
    all 28 weights; every activation range the EMA of its batch's min and
    max; BN frozen from step 10, its statistics bit-unchanged after), run L
    (uniform-tf on v2), run M (the non-uniform learner on v1: 27 K1'
    launches with the select a forward, at most 16 values in each quantized
    kernel, codebooks that move), each regime's step time and every run's
    peak memory; run N, the non-uniform RL bit search on ResNet-20 (each
    roll-out's codebooks at its mixed bits, no launch); then K2' at v1's 28
    weight shapes and K1' at its largest activations against their plain
    versions, a small step of each new learner card vs CPU, and the two
    plain ops (fake_quant_with_range, nonuniform_quant) card vs CPU and
    timed;
  * the channel-pruning family through main.main (no fake-quant kernel):
    ResNet-20 @ CIFAR-10 at batch 128 from run A's baseline, run O (the LASSO
    pruner, uniform 0.5, with distillation: each of the 20 prunable convs at
    ceil(0.5 c_in) channels within the LASSO's tolerance), P (chn-pruned-rmt:
    exactly round(0.5 c_in)), Q (chn-pruned-gpu: >= 40% of each middle
    layer's channels zeroed, head and tail kept), R (dis-chn-pruned: exactly
    half, the auxiliary heads trained), every masked input channel 0 after
    the finetune; MobileNet-v1 at 224, batch 256, run S: the AMC search
    (2 roll-outs, each timed by part) under a 0.5 FLOPs budget over the 13
    pointwise convs, its top-k in ddpg_search.npz, then the finetune; then
    the pruner's solvers card vs CPU at MobileNet's 1024->1024 and
    ResNet-20's 64->64 layers (the same channels, kernels within
    CP_KERNEL_TOL), a LASSO solve and a whole layer timed, and a CPG PGD step
    and a DCP grad-norm step card vs CPU;
  * the deployment path through tools/export_cli.main and tools/serving.main
    (no fake-quant kernel): run T exports the main path's ResNet-50 state
    ('plain' and 'quant'), serves it in bf16 and in int8 (PTQ calibrated on
    2 batches, every site int8, the int32 accumulators of every distinct
    contraction shape equal to the CPU's from the same codes), with both
    latencies at batch 256 and the top-1 agreement; run U shrinks run S's
    channel-pruned MobileNet-v1 across its depthwise chains
    ('chn-pruned-residual': scattered back, the dense logits exactly; the
    width-mapped net within SHRUNK_FP32_TOL / SHRUNK_BF16_TOL of them, with
    fewer parameters), its FLOPs audit and the dense and shrunk nets'
    latencies in bf16 and int8; run V shrinks run O's ResNet-20 and serves
    it through serving.main;
  * data parallelism on torch.distributed (phase 23): K1''s global-range
    route (pass 1 alone, the (-min, max) pair all-reduced, pass 2 from it)
    against the fused K1' and the plain version at the main path's
    activations, timed; run W, the main path at world size 1 in an NCCL
    group with --enbl_multi_gpu, bit-equal to the same steps without a
    group and with no collective; run X, two ranks sharing the card over
    gloo (NCCL refuses two ranks on one device) at batch 256 each on the
    main and the 8-bit-activation routes, bit-identical, their collectives
    counted, within a bound of one rank at batch 512 set by that rank's
    reruns from parameters one ulp away; run Y, main.main on two ranks
    (ResNet-20 weight sparsification, the optimal search): equal ratios on
    both, one checkpoint, written by rank 0;
  * detection (phase 24) at 300x300, bf16, batch 32, synthetic VOC, through
    main.main: SSD-VGG16 full-prec (run D1), uniform 4-bit (D2: one grouped
    K1' launch a forward for its 33 weights) and with 8-bit activations
    (D3: and K1' with the select at each of its 23 relu sites), each timed,
    profiled (device busy time, idle share, layers; the program's spans
    pf.det.loss, pf.det.propose and pf.det.roi_align: the matching and loss,
    Faster R-CNN's proposal layer and ROI-align) and D1, D2
    evaluated with mAP (forward, decode, host NMS, VOC eval timed); the
    grouped K1' at SSD's weights and K1' at its largest activation against
    their plain versions; Faster R-CNN with a ResNet-50 trunk (D4) trained
    and evaluated; BASELINE config #5 (D5): the channel learner on D4's
    baseline on two ranks sharing the card over gloo (equal masks, pruned
    mid-trunk channels zero, one checkpoint from rank 0, the gathered eval
    equal to one rank's, detection by detection); an SSD QAT step and a
    Faster R-CNN eval forward at 64x64, card against CPU;
  * the real-data path (phase 25): full-frame ILSVRC-12 shards (4 x 1,024
    train and 512 val samples of 256x341x3 uint8, each frame's valid extent
    beside it) written with the converter's writer into a temporary
    directory; the native sampler and the NumPy iterator alone over them,
    and put_batch's pin and copy; run R1, the main path's QAT step through
    main.main fed from the shards (the native pread sampler, crops within
    each extent, the profiler hook over steps 3-7, steps 8-11 timed, the eval
    over the val shard, the checkpoint) beside run R0, the same command on
    in-memory synthetic data; run R2, the eval of R1's checkpoint from a
    --data_disk=hdfs copy (file://) staged once; run R3, SSD-300 on the VOC
    shards of make_minimal_data; run R4, the AutoML CLI (2 GP trials);
  * the deployment export (phase 26): run K's MobileNet-v1 rebuilt in fp32
    through tools/export_tflite.build_qat_deploy_forward, its 28 kernels
    folded onto the QAT grid in one grouped K2' launch pair (the run
    'deploy-fold'), bit-equal to the plain version on the CPU and to the
    per-site op; the deploy forward against the QAT reference forward at
    batch 256; tools/tf_lowering's stage 1 on the deploy forward and on
    ResNet-50 with the s2d stem at 224, every node lowered; the TFLite
    conversion only where TensorFlow is installed;
  * --remat_blocks (phase 27): the main path's QAT ResNet-50 step under
    'none', 'save_convs' and 'full' from one seeded state on one batch,
    with cudnn.deterministic: the same parameters, momentum and BN
    statistics bit for bit, one grouped K1' launch pair a step in every
    mode (27a); the same at 8-bit activations, K1' with the select at the
    49 sites and again at the 48 inside the blocks under 'save_convs' and
    'full' (27b); each mode's peak memory, step time in turns and device
    busy time, and 'none' against 'full' at batch 1024 (27c,
    experiments/step_remat.py); MobileNet-v1 uniform-tf through main.main
    under 'none' and 'save_convs', the same checkpoint (27d); Faster R-CNN
    ResNet-50 at 300x300, batch 32, one step under 'none' and 'full', the
    peak memory lower under 'full' (27e);
  * the accuracy-parity harness (phase 28,
    pocketflow_tpu_torch/experiments/): ResNet-20's full-prec and
    uniform@4bit points on the hard synthetic task at the --quick budget
    through synthetic_parity.run_sweep, both accuracies printed, the
    baseline well above chance (1/64), one grouped K2' launch pair a
    quantized forward and no plain call (28a); composed_cp_qat.run at its
    --quick budget: the LASSO prune of a fresh baseline, then QAT 8/8 from
    the pruned checkpoint with the channel masks held, K1' with the select
    at each activation site and one grouped K1' pair a quantized forward,
    the pruned fraction the same after QAT (28b); the width-mapped Faster
    R-CNN ResNet-50 (stages 1 and 2's inner widths halved) eval forward,
    card vs CPU at 64x64: the trunk's two feature maps and the RPN's
    outputs (28c);
  * the detection parity strips at their --quick budget (phase 29);
  * the root experiments at a short budget (phase 30): uqtf_phases.run on
    the main path's QAT ResNet-50 under the uniform-tf learner, 3 steps a
    phase, no launch in the warm-up and one grouped K2' launch a QAT forward
    in the two QAT phases, no plain call (30a); int8_serving_speed.run and
    shrunk_serving_latency.run at batch 64 and 5 timed forwards, the int8
    band's verdict printed, the shrunk logits within SHRUNK_BF16_TOL of the
    dense net with zeros (30b); amc_mobilenet_onchip.run, 2 roll-outs after
    20 warm steps, within its FLOPs budget (30c);
  * tensor parallelism (phase 31): the split grouped K1' (pass 1 into a [T,
    2] buffer of ranges, their MAX over the model group, pass 2) at the 52
    weights, bit-equal to the fused grouped K1' at model size 1 and to its
    plain version on the card, timed (31a); QAT ResNet-50 @224, bf16, 4-bit
    weights, global batch 32 through uniform's train step on data:1,model:2
    (run Z1, two gloo ranks on cuda:0) and data:2,model:2 (run Z2, four):
    which collectives gloo runs with CUDA tensors, every rank's full state
    identical, the replicated tensors bit-identical across the model ranks,
    within 2x the 1-ulp reruns of one rank at batch 32, one split grouped
    K1' launch a step and no plain call, the collectives a step by kind,
    parameters + momentum a rank against world 1 (31b); on Z2's ranks
    main.main trains QAT ResNet-50 (64x64 images) and saves under
    --ckpt_backend=msgpack, its learner
    saves the same state under 'orbax' (sharded, asynchronous), and both
    resume at world 1 and on data:2 bit for bit (31c);

and checks that each went through its kernels and never through a plain
version.  Any failed phase raises and the script exits non-zero without its
last line.  The last line is

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": <n>}}

and the line before it lists each kernel with its launches, its largest
difference from the plain version, its time, the plain version's, the
library call's where one computes the same function (else null), and its
bound: the least time the card could take for the same work, the larger of
the bytes moved (each input read once, each output written once) over the
memory's rate and the operations over the peak rate of their type.
`launches` counts one run, which `run` names: for fake_quant_per_tensor_group
(the grouped route of K1', which quantizes the step's 52 weights in one
launch pair) the main path's 13 train steps (the counters are reset just
before them and read just after, before the eval step), for
fake_quant_per_tensor (K1' with the select folded in) the 7 steps with 8-bit
activations, for fake_quant_per_column_group (K2', all weights in one launch
pair; the per-site bucket ops are groups of one) the 7 steps under channel
buckets, for fake_quant_per_tensor_global (K1''s global-range route) rank
0's 3 steps of run X at 8-bit activations, for
fake_quant_per_tensor_group_global (the grouped K1' split around the model
axis's range) rank 0's 3 steps of run Z2, for matmul_bf16 the
mm_shape_sweep experiment and for bn_relu_matmul_stats the fused_mm_proto
experiment.  `launches_by_run` gives
every kernel's count in each run, each counted from its own reset, the
zoo's, the searches' and MobileNet's runs included.
"""

import copy
import json
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

from pocketflow_tpu_torch.core.cuda_timing import (
    BF16_TENSOR_OPS_S, FP32_OPS_S, bound_ms as bound, card_line, matmul_bound_ms, time_ms)

CSRC = 'pocketflow_tpu_torch/csrc/'
# kernel -> (source file, the TPU kernel it replaces)
KERNELS = {
    'fake_quant_per_tensor': ('fake_quant.cu',
                              'pocketflow_tpu/ops/fake_quant.py:84 (_fq_pallas_2d)'),
    'fake_quant_per_tensor_group': ('fake_quant.cu', 'pocketflow_tpu/ops/fake_quant.py:84 '
                                    '(_fq_pallas_2d; grouped route, all weights at once)'),
    'fake_quant_per_tensor_global': ('fake_quant.cu', 'pocketflow_tpu/ops/fake_quant.py:84 '
                                     '(_fq_pallas_2d; global-range route under data '
                                     'parallelism: pass 1, the range all-reduced, pass 2)'),
    'fake_quant_per_tensor_group_global': ('fake_quant.cu', 'pocketflow_tpu/ops/fake_quant.py:84 '
                                           '(_fq_pallas_2d; grouped route with each range '
                                           'over the model axis under tensor parallelism: '
                                           'pass 1, the [T, 2] ranges all-reduced, pass 2)'),
    'fake_quant_per_column_group': ('fake_quant.cu', 'pocketflow_tpu/ops/fake_quant.py:108 '
                                    '(_fq_pallas_cols_grid; all weights at once, or one)'),
    'matmul_bf16': ('matmul.cu', 'experiments/conv1x1_ab.py:123 (make_pallas); '
                                 'experiments/mm_shape_sweep.py:58 (make_pallas)'),
    'bn_relu_matmul_stats': ('matmul.cu', 'experiments/fused_mm_proto.py:56 (pallas_fused)'),
    'int8_conv': ('int8_conv.cu', 'no Pallas kernel: XLA\'s native int8 convolution behind '
                                  'pocketflow_tpu/ops/int8_ops.py:37 (int8_contract)'),
}
BATCH = 256
N_WARMUP, N_TIMED = 3, 10
MAIN_RUN = 'main path: %d QAT train steps, per-tensor 4-bit weights' % (N_WARMUP + N_TIMED)
ROUTE_WARMUP, ROUTE_TIMED = 2, 5
ROUTE_STEPS = ROUTE_WARMUP + ROUTE_TIMED
ACT8_RUN = '8-bit activations (--uql_activation_bits=8): %d QAT train steps' % ROUTE_STEPS
CHANNEL_RUN = ('channel buckets (--uql_use_buckets --uql_bucket_type=channel): %d QAT train '
               'steps' % ROUTE_STEPS)
SPLIT_RUN = ('split buckets (--uql_use_buckets --uql_bucket_type=split): %d QAT train steps'
             % ROUTE_STEPS)
NB_WEIGHT_SITES, NB_ACT_SITES = 52, 49
# the activations K1' is timed on: the largest of the 8-bit route (411 MB of
# bf16) and one of 51 MB, which L2 nearly holds
ACT_SHAPES = [(256, 256, 56, 56), (256, 2048, 7, 7)]
# K1' is also held against the plain version on an fp32 activation and on
# ragged sizes (bf16, fp32), whole and as views that start off 16 bytes
FP32_ACT_SHAPE, RAGGED_N = (32, 256, 56, 56), (1_000_003, 12_345_679)
COMPOSED_WARMUP, COMPOSED_TIMED = 3, 5
COMPOSED_RUN = 'composed pruned+QAT: %d train steps, 4-bit weights, channel masks' % (
    COMPOSED_WARMUP + COMPOSED_TIMED)
# the fused kernel's shape (experiments/fused_mm_proto.py) and its prologue
K3_SHAPE, K3_SCALE, K3_SHIFT = (256 * 56 * 56, 256, 64), 1.1, 0.1
K3_RAGGED_M = 256 * 56 * 56 - 1000
# exact-sum shapes of bn_relu_matmul_stats (M, K, N): ss stays below 2^24;
# the last one has a K that no shared-memory copy of scale and shift would hold
K3_EXACT = [(2048, 64, 64), (1000, 72, 136), (300, 200, 264), (16, 8200, 16)]
# bn_relu_matmul_stats' column sums against the plain version's: s within
# K3_S_TOL of the column's sum of |y32|, ss within K3_SS_TOL relative.  About
# ten times the kernel's readings at K3's shape (3.8e-7 and 4.6e-7 on an
# H100), and below what either fault a kernel could hide gives at the ragged
# M: rows past M counted, or sums taken from bf16 y (phase_matmul plants both
# and requires them to fail).
K3_S_TOL, K3_SS_TOL = 3e-6, 5e-6
# and against float64 sums of the bf16 z and w (every product exact), s within
# K3_S_TOL64 of the column's sum of |y|, ss within K3_SS_TOL64 relative: about
# five times the kernel's readings on an H100 (2.1e-7 and 3.9e-7; the fp32
# plain version's 2.6e-7 and 2.1e-7), and far below both planted faults
K3_S_TOL64, K3_SS_TOL64 = 1e-6, 2e-6
# the model zoo's path at full width (ResNet-20 @ CIFAR-10, widths 16/32/64,
# batch 128; ConvNet @ FMNIST, LeNet @ CIFAR-10), through main.main on the
# card: CIFAR-10 .bin files written by make_minimal_data, the samples a set
ZOO_BATCH, ZOO_TRAIN, ZOO_EVAL = 128, 1280, 512
# each model's (quantized weights, activation sites), and the nets' classes
ZOO_SITES = {'resnet_at_cifar10': (20, 19), 'convnet_at_fmnist': (2, 3), 'lenet_at_cifar10': (2, 3)}
ZOO_NETS = ('ResNetCifar', 'ConvNet', 'LeNet', 'MobileNetV1', 'MobileNetV2', 'SSDVGG',
            'FasterRCNN', 'ResNetImageNet')
# the policies of a quantized forward (each learner's)
QUANT_POLICIES = ('QuantPolicy', 'RangeQuantPolicy', 'NonUniformQuantPolicy')
ZOO_RUNS = [  # (label, model, flags, expected launches a quantized forward)
    ('zoo run A: resnet_at_cifar10 full-prec, 30 steps', 'resnet_at_cifar10',
     ['--learner=full-prec', '--nb_epochs_rat=0.012'], {}),
    ('zoo run B: resnet_at_cifar10 uniform 4-bit + distillation, 30 steps', 'resnet_at_cifar10',
     ['--learner=uniform', '--enbl_dst', '--uql_weight_bits=4', '--nb_epochs_rat=0.05'],
     dict(fake_quant_per_tensor_group=1)),
    ('zoo run C: resnet_at_cifar10 uniform 4-bit, 8-bit activations + distillation, 30 steps',
     'resnet_at_cifar10', ['--learner=uniform', '--enbl_dst', '--uql_weight_bits=4',
                           '--uql_activation_bits=8', '--nb_epochs_rat=0.05'],
     dict(fake_quant_per_tensor_group=1, fake_quant_per_tensor=19,
          fake_quant_per_tensor_select=19)),
    ('zoo run D: resnet_at_cifar10 uniform, channel buckets, 6 steps', 'resnet_at_cifar10',
     ['--learner=uniform', '--uql_use_buckets', '--uql_bucket_type=channel',
      '--nb_epochs_rat=0.01'], dict(fake_quant_per_column_group=1)),
    ('zoo run E: convnet_at_fmnist uniform 4-bit, synthetic FMNIST, 30 steps',
     'convnet_at_fmnist', ['--learner=uniform', '--synthetic_data', '--nb_epochs_rat=0.05'],
     dict(fake_quant_per_tensor_group=1)),
    ('zoo run F: lenet_at_cifar10 uniform 4-bit, 30 steps', 'lenet_at_cifar10',
     ['--learner=uniform', '--nb_epochs_rat=0.05'], dict(fake_quant_per_tensor_group=1))]
# ResNet-20's activations at batch 128 (bf16 channels-last) and the dense
# ones after fc3's relu (ConvNet 1024, LeNet 256 features)
ZOO_ACT_SHAPES = [(128, 16, 32, 32), (128, 32, 16, 16), (128, 64, 8, 8), (128, 1024), (128, 256)]
ZOO_TIMED_WARMUP, ZOO_TIMED = 5, 20
# phase 14: the DDPG agent at the size of ResNet-20's weight-sparsification
# search (22 maskable kernels: a state of 22 + 7 features), its buffer 22
# transitions x --ws_nb_rlouts_min=50
DDPG_S_DIMS, DDPG_BUF_SIZE = 29, 1100
# phase 15: weight sparsification through main.main (ResNet-20 from run A's
# baseline; ConvNet from scratch), 30-32 steps, a mask refresh every 3 steps
WS_COMMON = ['--learner=weight-sparse', '--ws_prune_ratio=0.5', '--ws_mask_update_step=3']
WS_RUNS = [
    ('zoo run G: resnet_at_cifar10 weight-sparse, uniform 0.5, 30 steps', 'resnet_at_cifar10',
     WS_COMMON + ['--ws_prune_ratio_prtl=uniform', '--nb_epochs_rat=0.012']),
    ('zoo run H: resnet_at_cifar10 weight-sparse, optimal (2 roll-outs of 4 regression, 8 '
     'finetune and 2 eval steps), 30 steps', 'resnet_at_cifar10',
     WS_COMMON + ['--ws_prune_ratio_prtl=optimal', '--ws_nb_rlouts=2', '--ws_nb_rlouts_min=1',
                  '--ws_nb_iters_rg=4', '--ws_nb_iters_ft=8', '--ws_nb_iters_feval=2',
                  '--nb_epochs_rat=0.012']),
    ('zoo run J: convnet_at_fmnist weight-sparse, uniform 0.5, synthetic FMNIST, 32 steps',
     'convnet_at_fmnist', WS_COMMON + ['--ws_prune_ratio_prtl=uniform', '--synthetic_data',
                                       '--nb_epochs_rat=0.02'])]
WS_ROLLOUT_STEPS = 10  # steps of each part of the timed WS roll-out
# phase 16: the RL bit search through main.main, then its finetune
BIT_SEARCH_RUN = ('zoo run I: resnet_at_cifar10 uniform, RL bit search (2 roll-outs of 3 '
                  'layerwise and 5 finetune steps), then 30 steps')
BIT_SEARCH_ARGV = ['--learner=uniform', '--uql_enbl_rl_agent', '--uql_nb_rlouts=2',
                   '--uql_tune_global_steps=5', '--uql_enbl_rl_layerwise_tune',
                   '--uql_tune_layerwise_steps=3', '--nb_epochs_rat=0.05']
BIT_ROLLOUT_STEPS = 20  # finetune steps of the timed bit-search roll-out
# phase 17: MobileNet @ ILSVRC-12 through main.main at full width (depth
# multiplier 1.0, 224x224, bf16, synthetic data): runs K (v1 uniform-tf, the
# slice's main path: quantization from step UQTF_DELAY + 1, BN frozen from
# step UQTF_FREEZE + 1), L (v2 uniform-tf) and M (v1 non-uniform)
MB_BATCH, MB_EVAL = 256, 512
UQTF_DELAY, UQTF_FREEZE, UQTF_STEPS, UQTF_V2_STEPS, NUQ_STEPS = 3, 9, 13, 6, 10
MB_SITES = {1: (28, 27), 2: (53, 35)}  # (weights, relu6 sites), all layers
MB_NUQ_WEIGHTS = 26  # non-uniform leaves the first and the last layer unquantized
MB_RUNS = [  # (label, version, flags, steps)
    ('mobilenet run K: v1 uniform-tf 8/8, quant delay %d, BN frozen from step %d, %d steps'
     % (UQTF_DELAY, UQTF_FREEZE + 1, UQTF_STEPS), 1,
     ['--learner=uniform-tf', '--uqtf_quant_delay=%d' % UQTF_DELAY,
      '--uqtf_freeze_bn_delay=%d' % UQTF_FREEZE], UQTF_STEPS),
    ('mobilenet run L: v2 uniform-tf 8/8, %d steps' % UQTF_V2_STEPS, 2,
     ['--learner=uniform-tf'], UQTF_V2_STEPS),
    ('mobilenet run M: v1 non-uniform, 4-bit kmeans codebooks, 8-bit activations, both trained, '
     '%d steps' % NUQ_STEPS, 1,
     ['--learner=non-uniform', '--nuql_weight_bits=4', '--nuql_init_style=kmeans',
      '--nuql_activation_bits=8', '--nuql_opt_mode=both'], NUQ_STEPS)]
# run N: the non-uniform learner's RL bit search on ResNet-20 from run A's
# baseline (roll-outs at full-precision activations launch no kernel)
NUQ_SEARCH_RUN = ('zoo run N: resnet_at_cifar10 non-uniform, RL bit search (2 roll-outs of 3 '
                  'layerwise and 5 finetune steps), then 30 steps')
NUQ_SEARCH_ARGV = ['--learner=non-uniform', '--nuql_enbl_rl_agent', '--nuql_nb_rlouts=2',
                   '--nuql_tune_global_steps=5', '--nuql_enbl_rl_layerwise_tune',
                   '--nuql_tune_layerwise_steps=3', '--nb_epochs_rat=0.05']
# phase 19: the channel-pruning family through main.main on ResNet-20 from
# run A's baseline; iteration counts cut from their defaults (logged):
# cp_nb_batches 30 -> 10, cpr_nb_smpls 5000 -> 1280 (10 batches),
# cpg_nb_iters_layer 1000 -> 50, dcp_nb_iters_block 10000 -> 2,
# dcp_nb_iters_layer 500 -> 1
CP_RUNS = [  # (label, learner, save-path flag, argv)
    ('zoo run O: resnet_at_cifar10 channel (LASSO), uniform 0.5 + distillation, 25 finetune '
     'steps', 'channel', 'cp_channel_pruned_path',
     ['--cp_prune_option=uniform', '--cp_uniform_preserve_ratio=0.5', '--enbl_dst',
      '--cp_nb_batches=10', '--nb_epochs_rat=0.05']),
    ('zoo run P: resnet_at_cifar10 chn-pruned-rmt, ratio 0.5, 30 steps', 'chn-pruned-rmt',
     'cpr_save_path', ['--cpr_prune_ratio=0.5', '--cpr_nb_smpls=1280', '--nb_epochs_rat=0.012']),
    ('zoo run Q: resnet_at_cifar10 chn-pruned-gpu, ratio 0.5 (50 PGD + 50 reconstruction '
     'steps), 30 steps', 'chn-pruned-gpu', 'cpg_save_path',
     ['--cpg_prune_ratio=0.5', '--cpg_nb_iters_layer=50', '--nb_epochs_rat=0.012']),
    ('zoo run R: resnet_at_cifar10 dis-chn-pruned, ratio 0.5 (2 block-FT and 1 layer-FT step), '
     '30 steps', 'dis-chn-pruned', 'dcp_save_path',
     ['--dcp_prune_ratio=0.5', '--dcp_nb_iters_block=2', '--dcp_nb_iters_layer=1',
      '--nb_epochs_rat=0.012'])]
# phase 20: MobileNet-v1 at 224, depth 1.0, bf16, batch 256: the AMC search
# (2 roll-outs, 2 batches sampled a layer: cp_nb_rlouts 200 -> 2,
# cp_nb_batches 30 -> 2), then the prune at the best ratios and 5 finetune steps
AMC_RUN = ('mobilenet run S: v1 channel, AMC search (2 roll-outs) under a 0.5 FLOPs budget, '
           'then 5 finetune steps')
AMC_TRAIN, AMC_STEPS = 1280, 5
# phase 21: the LASSO pruner's solvers card vs CPU from the same X and Y
# (rows: MobileNet's layer at one batch of 256 x 10 points, ResNet-20's at
# 10 batches of 128 x 10), then timed on the card at the default 30 batches
CP_LAYERS = [('MobileNet-v1 1x1 1024->1024', (1, 1, 1024, 1024), 2560, 256 * 10 * 30),
             ('ResNet-20 3x3 64->64', (3, 3, 64, 64), 12800, 128 * 10 * 30)]
# the reconstructed kernels card vs CPU: float64 solves on P and X products
# that differ only in the fp32 sums' order
CP_KERNEL_TOL = 1e-5
# phase 18: MobileNet-v1's two largest activations at batch 256 (bf16)
MB_ACT_SHAPES = [(256, 64, 112, 112), (256, 32, 112, 112)]
# fp32 operations a fake-quant element costs: min, max; x - beta, / alpha,
# * k, round, / k, * alpha, + beta
FQ_OPS_PER_ELEMENT = 9
# ragged edges of matmul_bf16 (M past a 128-row tile, K past a 64-deep stage,
# N past a column tile), beside the experiments' shapes
MATMUL_RAGGED = [(1, 8, 8), (129, 8, 8), (1000, 8, 8), (129, 40, 24), (1000, 72, 136),
                 (1000, 200, 264), (777, 520, 72), (30000, 72, 264)]

# phase 22: the deployment path through the CLIs' main(argv) on the card.
# Run T serves phase 6's ResNet-50 state (224, bf16, batch 256) in bf16 and
# in int8 (PTQ calibrated on SERVE_CALIB batches); run U shrinks run S's
# channel-pruned MobileNet-v1 (224, depth 1.0, bf16, batch 256) across its
# depthwise chains; run V shrinks run O's ResNet-20 across residual merges.
# Latency: the reference's protocol (distinct staged inputs, a warm-up, the
# timed calls between two CUDA events), cut from 100 + 100 calls
SERVE_BATCH, SERVE_CALIB, SERVE_WARMUP, SERVE_TIMED = 256, 2, 5, 20
# the width-mapped net against the dense one (its logits, and each block's
# kept output channels), largest |delta| over the largest |value|: in fp32
# (cuDNN without TF32) the sums differ only in their order; in bf16 an
# activation may round to the neighbouring bf16 value, one of 2^8 of it
SHRUNK_FP32_TOL, SHRUNK_BF16_TOL = 1e-4, 5e-2
# int8_matmul card vs CPU at (M, K, N) off what cuBLASLt's int8 GEMM takes
INT8_GRID = ((1, 17, 40, 200704), (8, 14, 16, 27, 32, 96), (8, 20, 40, 62, 1001))
SERVE_RUNS = {'T': 'serving run T: resnet_at_ilsvrc12 ResNet-50 from phase 6, plain and quant '
                   'export, bf16 and int8 serving',
              'U': 'serving run U: mobilenet_at_ilsvrc12 v1 from run S, chn-pruned-residual '
                   'export, dense and shrunk serving in bf16 and int8',
              'V': 'serving run V: resnet_at_cifar10 from run O, chn-pruned-residual export and '
                   'serving.main'}


# phase 23: data parallelism on torch.distributed.  Run W: DP_STEPS main-path
# steps at world size 1 in a one-rank NCCL group; run X: DP_WORLD ranks that
# share the card over gloo (NCCL refuses two ranks on one device), each at
# the main path's batch, the main route and the 8-bit-activation route, held
# to one rank at the global batch: the parameters (one vector), the BN
# statistics (one vector) and the losses each within DP_NOISE_FACTOR x the
# largest distance of the one rank's reruns from parameters one fp32 ulp
# away (DP_PERTURBATIONS); run Y: main.main on DP_WORLD ranks (run H's
# search at the zoo's batch a rank)
DP_STEPS, DP_WORLD = 3, 2
DP_NOISE_FACTOR = 2.0
DP_PERTURBATIONS = ('up', 'down', 'mixed')
DP_RANK_TIMEOUT = 600
DP_FLAGS = dict(batch_size=BATCH, batch_size_eval=BATCH, nb_smpls_train=4096, nb_smpls_eval=512,
                compute_dtype='bfloat16', bn_stats_subsample=1, uql_weight_bits=4,
                uql_activation_bits=32)
DP_ROUTES = [('main', {}), ('act8', dict(uql_activation_bits=8))]
DP_RUN_W = ('data-parallel run W: %d main-path steps, world 1 in an NCCL group, '
            '--enbl_multi_gpu' % DP_STEPS)
DP_RUN_X = {'main': 'data-parallel run X: %d main-path steps, %d ranks on one card over gloo, '
                    'batch %d a rank' % (DP_STEPS, DP_WORLD, BATCH),
            'act8': 'data-parallel run X: %d steps at --uql_activation_bits=8, %d ranks on one '
                    'card over gloo, batch %d a rank' % (DP_STEPS, DP_WORLD, BATCH)}
# phase 31: tensor parallelism (a "model" mesh axis), gloo ranks sharing cuda:0
TP_STEPS = 3
TP_GLOBAL_BATCH = 32
TP_MESHES = ((1, 2), (2, 2))  # (data, model)
TP_RANK_TIMEOUT = 600
TP_RUN = {mesh: 'tensor-parallel run Z%d: %d QAT main-path steps on data:%d,model:%d over '
                'gloo, global batch %d' % (i + 1, TP_STEPS, mesh[0], mesh[1], TP_GLOBAL_BATCH)
          for i, mesh in enumerate(TP_MESHES)}
TP_CKPT_RUN = ('tensor-parallel 31c: main.main QAT ResNet-50 (64x64 images) on data:2,model:2, '
               'saved under each --ckpt_backend, resumed at world 1 and on data:2')
# 31c at 64x64 images and eval batches of 64: the checkpoint is the
# full-width ResNet-50's whatever the image size, and the train loop's eval
# covers the 2,048 synthetic images, each batch 41 gathers over gloo (38 s
# at 224 in batches of 8, 30 s at 64)
TP_CKPT_ARGV = ['--model=resnet_at_ilsvrc12', '--resnet_size=50', '--learner=uniform',
                '--synthetic_data', '--resnet_stem_s2d', '--compute_dtype=bfloat16',
                '--ilsvrc_image_size=64',
                '--uql_weight_bits=4', '--batch_size=8', '--batch_size_eval=64',
                '--nb_smpls_train=64', '--nb_smpls_eval=32', '--uql_quant_epochs=1',
                '--nb_epochs_rat=0.5', '--summ_step=1', '--save_step=1000000']
# the gloo collectives probed with CUDA tensors on two ranks
GLOO_PROBES = ('all_reduce', 'broadcast', 'barrier', 'all_gather', 'all_gather_into_tensor',
               'reduce_scatter_tensor', 'all_to_all_single')
DP_RUN_Y = ('data-parallel run Y: main.main on %d ranks over gloo, resnet_at_cifar10 '
            'weight-sparse optimal (2 roll-outs), batch %d a rank' % (DP_WORLD, ZOO_BATCH))


# phase 24: detection at 300x300, bf16, the Pascal VOC spec's batch of 32 (a
# rank), synthetic VOC (DET_TRAIN train and DET_EVAL eval images), through
# main.main: SSD-VGG16 full-prec (run D1, the baseline of D2/D3), uniform
# 4-bit (D2: one grouped K1' launch a forward for its 33 weights) and with
# 8-bit activations (D3: and K1' with the select at each of its 23 relu
# sites); Faster R-CNN with a ResNet-50 trunk, full-prec (D4: 300 proposals
# from 1,024 pre-NMS, 128 ROIs an image); BASELINE config #5, the channel
# learner on D4's baseline on DET_WORLD ranks sharing the card over gloo
# (D5).  Each train run takes DET_STEPS steps: DET_WARMUP, a window of
# DET_TIMED on the host clock, DET_PROFILED under the profiler (the device
# only), DET_PROFILED more with the host's ops recorded (the named ranges).
DET_WARMUP, DET_TIMED, DET_PROFILED = 2, 4, 2
DET_STEPS = DET_WARMUP + DET_TIMED + 2 * DET_PROFILED
DET_BATCH, DET_EVAL = 32, 64
DET_TRAIN = DET_BATCH * DET_STEPS  # one quantization epoch is DET_STEPS steps
DET_WORLD = 2
SSD_SITES = (33, 23)  # quantized weights (35 less the first and the last), relu sites
SSD_LAST = 'cls_head_5'  # the last quantized weight (box_head_5, the last kernel, is not)
# nb_epochs_rat giving DET_STEPS (+ 0.5) steps of a model's full-precision
# schedule (SSD 120 epochs, Faster R-CNN 25) over DET_TRAIN samples
DET_RAT = {model: (DET_STEPS + 0.5) * DET_BATCH / (DET_TRAIN * epochs)
           for model, epochs in (('vgg_at_pascalvoc', 120), ('faster_rcnn_at_pascalvoc', 25))}
DET_QUANT = ['--learner=uniform', '--uql_weight_bits=4', '--uql_quant_epochs=1',
             '--nb_epochs_rat=1']
# at the recipe's threshold (0.05) ~3,900 detections an image pass on the
# young net, 200 a class, and the host NMS takes ~36 s for the 64 images;
# D1's and D2's evals score at 0.1 to keep the phase short (phase 29 times
# the eval by part on trained detectors)
SSD_RUNS = [  # (label, argv, launches a quantized forward, argv of the eval after it)
    ('detection run D1: vgg_at_pascalvoc full-prec, %d steps' % DET_STEPS,
     ['--learner=full-prec', '--nb_epochs_rat=%r' % DET_RAT['vgg_at_pascalvoc']], {},
     ['--ssd_score_threshold=0.1']),
    ('detection run D2: vgg_at_pascalvoc uniform 4-bit, %d steps' % DET_STEPS, DET_QUANT,
     dict(fake_quant_per_tensor_group=1), ['--ssd_score_threshold=0.1']),
    ('detection run D3: vgg_at_pascalvoc uniform 4-bit, 8-bit activations, %d steps' % DET_STEPS,
     DET_QUANT + ['--uql_activation_bits=8'],
     dict(fake_quant_per_tensor_group=1, fake_quant_per_tensor=SSD_SITES[1],
          fake_quant_per_tensor_select=SSD_SITES[1]), None)]
FRCNN_RUN = ('detection run D4: faster_rcnn_at_pascalvoc ResNet-50 full-prec, %d steps'
             % DET_STEPS)
# at the recipe's rate (0.1 x 32 / 128) Faster R-CNN diverges from random
# weights within 4 steps (loss 79 -> 3e19: the RPN heads' fan-out init puts
# the first objectness logits at up to 322); the JAX package's own Faster
# R-CNN smoke test trains at 0.01, as these runs do
FRCNN_FLAGS = ['--frcnn_backbone=resnet50', '--lrn_rate_init=0.01',
               '--nb_epochs_rat=%r' % DET_RAT['faster_rcnn_at_pascalvoc']]
CONFIG5_RUN = ('detection run D5: BASELINE config #5, faster_rcnn_at_pascalvoc ResNet-50 '
               'channel 0.5 on %d ranks over gloo, batch %d a rank' % (DET_WORLD, DET_BATCH))
CONFIG5_FLAGS = ['--learner=channel', '--cp_prune_option=uniform',
                 '--cp_uniform_preserve_ratio=0.5', '--cp_nb_batches=1',
                 '--cp_nb_points_per_layer=10', '--cp_lasso_nb_iters=50',
                 '--cp_nb_iters_ft_ratio=0.5', '--enbl_multi_gpu']
# card vs CPU at 64x64, batch 4, fp32 without TF32 (24e): the losses within
# 1e-3 relative, outputs within 1e-3 + 1e-3 of the largest
DET_SMALL = dict(voc_image_size=64, batch_size=4, batch_size_eval=4, nb_smpls_train=64,
                 nb_smpls_eval=8, compute_dtype='float32', nb_bboxs_max=8)
# phase 25: the real-data path.  25a writes full-frame ILSVRC-12 shards
# (the converter's default storage: 256 x 341 containers, zero-padded, with
# each sample's valid extent) with the converter's own writer; 25b reads them
# alone; run R1 (25c) is the main path's QAT step fed from them through
# main.main, beside run R0, the same command on in-memory synthetic data;
# R2 (25d) evaluates R1's checkpoint from a --data_disk=hdfs copy (file://);
# R3 (25e) trains SSD-300 on make_minimal_data's VOC shards; R4 (25f) is the
# AutoML CLI
RD_RESIZE, RD_SHARDS, RD_SHARD, RD_VAL = 256, 4, 1024, 512
RD_TRAIN = RD_SHARDS * RD_SHARD
RD_STEPS, RD_PROF_START, RD_PROF_NB = 13, 3, 5
RD_TIMED_FROM = RD_PROF_START + RD_PROF_NB  # steps 8-11 timed by the host clock
RD_TIMED = RD_STEPS - 1 - RD_TIMED_FROM
RD_LOADER_BATCHES = 16
CROP_SPAN = 'pf.data.crop_resize'  # the program's span around the train crop-resize
RD_EVAL_RTOL = 1e-3  # R2's eval loss against R1's last eval, the same checkpoint and data
RD_RUNS = {
    'R0': 'real-data run R0: resnet_at_ilsvrc12 ResNet-50 uniform 4-bit, in-memory synthetic '
          '224x224 data, %d steps' % RD_STEPS,
    'R1': 'real-data run R1: resnet_at_ilsvrc12 ResNet-50 uniform 4-bit from on-disk full-frame '
          'shards (native pread sampler, inception crops), %d steps' % RD_STEPS,
    'R1b': 'real-data run R1 again', 'R0b': 'real-data run R0 again',
    'R2': 'real-data run R2: eval of R1\'s checkpoint from --data_disk=hdfs (file://)',
    'R3': 'real-data run R3: vgg_at_pascalvoc SSD-300 full-prec, 4 steps on make_minimal_data\'s '
          'VOC shards',
    'R4': 'real-data run R4: AutoML CLI, resnet_at_cifar10 weight-sparse, GP, 2 trials'}
RD_SSD_STEPS, RD_SSD_TRAIN, RD_SSD_EVAL, RD_SSD_SIZE = 4, 128, 32, 300
RD_AUTOML_TRAIN, RD_AUTOML_STEPS = 1280, 10
# phase 26: the deployment export.  26a folds run K's MobileNet-v1 (rebuilt
# under compute_dtype=float32) onto its QAT grid through
# tools/export_tflite.build_qat_deploy_forward and holds the deploy forward
# against the QAT reference forward at batch MB_BATCH; 26b lowers the
# deploy forward and ResNet-50 with the s2d stem at 224 to TF op plans
# (tools/tf_lowering.lower, batch 1); 26c converts where TensorFlow exists
DEPLOY_FOLD_RUN = ('deploy-fold: build_qat_deploy_forward on run K\'s MobileNet-v1, its %d '
                   'weights folded in one grouped K2\' call' % MB_SITES[1][0])
EXPORT_PLANS = {  # the op kinds each plan must hold, and how many of each
    'MobileNet-v1 deploy forward': {'add_const': 1, 'affine': 27, 'clamp': 27, 'conv2d': 14,
                                    'depthwise_conv2d': 13, 'matmul': 1, 'mean': 1,
                                    'minimum_const': 27, 'relu': 27},
    'ResNet-50 (s2d stem)': {'add': 16, 'add_const': 1, 'affine': 53, 'conv2d': 53, 'matmul': 1,
                             'max_pool': 1, 'mean': 1, 'relu': 49, 'reshape': 2, 'transpose': 1}}

# phase 27: --remat_blocks (nn/layers.py: maybe_remat) on the main path.
# 27a: one QAT ResNet-50 step of each mode from one seeded state on one
# batch with cuDNN deterministic ('none' twice), then without the setting;
# 27b: the same at 8-bit activations; 27c: each mode's peak memory and step
# time, the modes in turns (experiments/step_remat.py), then 'none' and
# 'full' at REMAT_BIG_BATCH; 27d: MobileNet-v1 uniform-tf through main.main
# under 'none' and 'save_convs' (the same checkpoint); 27e: Faster R-CNN
# ResNet-50 at DET_BATCH, one step under 'none' and 'full'
REMAT_MODES = ('none', 'save_convs', 'full')
REMAT_WINDOWS, REMAT_STEPS, REMAT_PROFILED, REMAT_BIG_BATCH, REMAT_BIG_STEPS = 3, 4, 2, 1024, 2
REMAT_BLOCK_SITES = NB_ACT_SITES - 1  # the relu sites inside the 16 blocks: the stem's is outside
REMAT_RUN = 'remat 27a: one QAT ResNet-50 step, --remat_blocks=%s'
REMAT_ACT8_RUN = 'remat 27b: one QAT ResNet-50 step, 8-bit activations, --remat_blocks=%s'
REMAT_MB_STEPS = 3
REMAT_MB_RUNS = [('remat 27d run KR%d: v1 uniform-tf 8/8, %d steps, --remat_blocks=%s'
                  % (i, REMAT_MB_STEPS, mode), mode) for i, mode in enumerate(('none', 'save_convs'))]


# phase 28: the accuracy-parity harness on the card.  28a: run_sweep's
# full-prec and uniform@4bit points at the --quick budget (800 + 96 steps at
# batch 128); 28b: composed_cp_qat.run --quick (512 samples: 20 full-prec
# steps, the LASSO prune and 20 finetune steps, 2 QAT 8/8 steps, the
# shrink); 28c: Faster R-CNN ResNet-50 with PARITY_FRCNN_MAP card vs CPU at
# DET_SMALL's settings, its BN statistics those of the batch: the trunk's
# features and the RPN's outputs within 24e's bound
# phase 29: the detection parity strips at their --quick budget (64x64,
# batch 16, 512 train and 64 eval samples): SSD's baseline (bf16, 192 steps)
# and uniform@8bit point (48 steps, channel buckets: one grouped K2' launch
# a quantized forward), Faster R-CNN ResNet-18's baseline (fp32, 16 steps)
DET_PARITY_RUN_SSD = 'parity 29a: SSD-VGG16 full-prec + uniform@8bit, synthetic VOC, --quick'
DET_PARITY_RUN_FRCNN = 'parity 29b: Faster R-CNN ResNet-18 full-prec, hard regime, --quick'
# phase 30: the root experiments at a short budget: uqtf_phases on the main
# path's QAT ResNet-50 (224x224, bf16, batch 256, s2d stem) at 1 warm-up and
# 2 timed steps a phase; int8_serving_speed's and shrunk_serving_latency's
# measurements (batch 64, 224x224) at 2 warm-up and 5 timed forwards;
# amc_mobilenet_onchip at 2 roll-outs after 20 warm steps
ROOT_WARM, ROOT_TIMED = 1, 2
ROOT_SERVE_WARMUP, ROOT_SERVE_TIMED = 2, 5
ROOT_DRILL_RLOUTS, ROOT_DRILL_WARM = 2, 20
ROOT_RUN_UQTF = ('root 30a: uqtf_phases, QAT ResNet-50 uniform-tf, %d steps a phase (warm-up, '
                 'QAT exact BN, QAT frozen BN)' % (ROOT_WARM + ROOT_TIMED))
ROOT_RUN_SERVE = 'root 30b: int8_serving_speed and shrunk_serving_latency, batch 64'
ROOT_RUN_DRILL = ('root 30c: amc_mobilenet_onchip, MobileNet-v1 @224 b32, %d roll-outs after %d '
                  'warm steps' % (ROOT_DRILL_RLOUTS, ROOT_DRILL_WARM))
# phase 32: the int8 serving kernel (ops/int8_ops.int8_conv) at every distinct
# int8 site of ResNet-50 and MobileNet-v1 (224x224, bf16, batch 64, random
# weights from seed 0, scales calibrated on 2 batches, the depthwise sites
# skipped) and of MobileNet-v1 at odd widths (INT8_ODD_WIDTHS, as a shrink
# leaves them): each site bit-equal to its plain version on the card and
# timed (INT8_REPS calls) beside its bound and cuDNN's bf16 conv at the same
# shape; INT8_FORWARDS forwards of each net counted (one launch a site, no
# plain contraction on the card); one ResNet-50 int8 forward profiled (no
# host-to-device copy, no stream sync); then the bring-your-own-model
# example through its main() on the card
INT8_BATCH, INT8_CALIB, INT8_REPS, INT8_FORWARDS = 64, 2, 10, 3
INT8_SITES = {'resnet50': 54, 'mobilenet_v1': 15, 'mobilenet_v1 odd widths': 15}
INT8_ODD_WIDTHS = dict({'conv_init': 19}, **{
    'block%02d/pw' % (i + 1): w for i, w in enumerate(
        (35, 71, 69, 141, 139, 283, 281, 279, 277, 275, 273, 563, 561))})
INT8_RUN = ('int8 32a: int8 serving forwards, batch %d, of ResNet-50, MobileNet-v1 and '
            'MobileNet-v1 at odd widths, %d each' % (INT8_BATCH, INT8_FORWARDS))
EXAMPLE_RUN = ('example 32c: examples/self_defined_convnet.py --learner=weight-sparse, uniform '
               '0.5, synthetic data')
PARITY_RUN_UQ = 'parity 28a: ResNet-20 full-prec + uniform@4bit, hard task, --quick'
PARITY_RUN_CP = 'parity 28b: composed CP -> QAT 8/8, ResNet-20, --quick'
PARITY_MIN_BASELINE = 10 / 64  # ten times chance
PARITY_FRCNN_MAP = {'backbone/stage%d_block%d/conv%d' % (stage, block, conv): 32 * stage
                    for stage, nb_blocks in ((1, 3), (2, 4)) for block in range(nb_blocks)
                    for conv in (1, 2)}


def log(msg, *args):
    print(msg % args if args else msg, flush=True)


def check(cond, msg, *args):
    if not cond:
        raise RuntimeError('check failed: ' + (msg % args if args else msg))


def reset_counters():
    from pocketflow_tpu_torch.ops import fake_quant as fq
    from pocketflow_tpu_torch.ops import int8_ops
    from pocketflow_tpu_torch.ops import matmul as mm
    fq.reset_counters()
    mm.reset_counters()
    int8_ops.reset_counters()


def counters() -> dict:
    """Every kernel's launches and all plain calls since the last reset
    (int8_plain_cuda: the plain int8 contractions on the card;
    int8_depthwise: the depthwise int8 route's calls)."""
    from pocketflow_tpu_torch.ops import fake_quant as fq
    from pocketflow_tpu_torch.ops import int8_ops
    from pocketflow_tpu_torch.ops import matmul as mm
    a, b, c = fq.counters(), mm.counters(), int8_ops.counters()
    return {**a, **b, **c, 'plain': a['plain'] + b['plain'] + c['plain']}


def no_launches(**launches) -> dict:
    """The counters with `launches` and no other kernel launch or plain call."""
    out = {name: 0 for name in counters()}
    out.update(launches)
    return out


def compare(got, want, alpha_over_k):
    """Max |got - want| and the number of differing elements.  Equal is the
    rule; a difference is allowed only as one quantization step at a
    rounding tie, in at most 1e-5 of the elements."""
    diff = (got.to(torch.float32) - want.to(torch.float32)).abs()
    n_diff = int((diff > 0).sum())
    max_err = float(diff.max())
    step = float(alpha_over_k.max()) if torch.is_tensor(alpha_over_k) else alpha_over_k
    check(n_diff <= max(1, got.numel() // 100000) and max_err <= step * 1.001 + 1e-6,
          'kernel differs from plain: %d elements, max %.3g', n_diff, max_err)
    return max_err, n_diff


def fq_bound(nb_elements: int, element_bytes: int = 4):
    """(bound_ms, bound_by) of a fake-quant pass over nb_elements: each read
    once and written once, FQ_OPS_PER_ELEMENT fp32 operations each."""
    return bound(2 * element_bytes * nb_elements, {FP32_OPS_S: FQ_OPS_PER_ELEMENT * nb_elements})


def phase_group(fq, weight_shapes, device):
    """The grouped route of K1' at the 52 weight shapes, mixed bits (2, 4, 8,
    32 in turn; 32 copies): bit-equal to the plain version and, tensor by
    tensor, to the per-tensor kernel."""
    gen = torch.Generator(device=device).manual_seed(1)
    weights = [torch.randn(s, generator=gen, device=device) * 0.05 for s in weight_shapes]
    bits = torch.tensor([(2.0, 4.0, 8.0, 32.0)[i % 4] for i in range(len(weights))],
                        device=device)
    got = fq.fake_quant_per_tensor_group(weights, bits)
    for i, (w, b, g) in enumerate(zip(weights, bits, got)):
        want = torch.where(b < 32, fq._quantize_math_torch(w, fq._levels(b), None), w)
        check(torch.equal(g, want), 'grouped K1\' differs from plain at weight %d %s, bits %g',
              i, tuple(w.shape), float(b))
        if b < 32:
            check(torch.equal(g, fq.fake_quant_per_tensor(w, b)),
                  'grouped K1\' differs from the per-tensor kernel at weight %d', i)
    log('  fake_quant_per_tensor_group: %d weights, bits 2/4/8/32 in turn: equal to plain and '
        'to the per-tensor kernel, tensor by tensor', len(weights))
    bits4 = torch.full((len(weights),), 4.0, device=device)
    k = fq._levels(torch.tensor(4.0, device=device))
    ms = time_ms(lambda: fq.fake_quant_per_tensor_group(weights, bits4))
    plain_ms = time_ms(lambda: [torch.where(b < 32, fq._quantize_math_torch(w, k, None), w)
                                for w, b in zip(weights, bits4)])
    per_site_ms = time_ms(lambda: [torch.where(b < 32, fq.fake_quant_per_tensor(w, b), w)
                                   for w, b in zip(weights, bits4)])
    bound_ms, bound_by = fq_bound(sum(w.numel() for w in weights))
    log('  fake_quant_per_tensor_group over the 52 weights of one step (4 bits): kernel %.4f ms, '
        'plain %.4f ms, the per-site route (52 x per-tensor kernel + select) %.4f ms, bound '
        '%.4f ms (%s)', ms, plain_ms, per_site_ms, bound_ms, bound_by)
    return {'fake_quant_per_tensor_group': dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                                bound_ms=bound_ms, bound_by=bound_by,
                                                library_ms=None)}


def phase_tensor_kernel(fq, device):
    """K1' with and without the select against the plain version (and the
    plain version's select): bf16 channels-last activations of the 8-bit
    route, fp32, a ragged n, an unaligned view; bits 2/4/8/16/32 (16 and 32
    are past the table of levels; 32 with the select copies).  Then its time
    on both activations of ACT_SHAPES, with and without the select, beside
    the plain version's and the bound."""
    gen = torch.Generator(device=device).manual_seed(2)

    def act(shape, dtype=torch.bfloat16):
        return torch.relu(torch.randn(shape, generator=gen, device=device)).to(dtype).contiguous(
            memory_format=torch.channels_last)

    base16 = torch.randn(3 + RAGGED_N[0], generator=gen, device=device).to(torch.bfloat16)
    base32 = torch.randn(1 + RAGGED_N[1], generator=gen, device=device)
    cases = [('bf16 act %s channels-last' % (shape,), act(shape)) for shape in ACT_SHAPES]
    cases += [('fp32 act %s channels-last' % (FP32_ACT_SHAPE,), act(FP32_ACT_SHAPE, torch.float32)),
              ('fp32 (3, 3, 512, 512)', torch.randn((3, 3, 512, 512), generator=gen,
                                                     device=device)),
              ('bf16 ragged n=%d' % RAGGED_N[0], base16[3:].clone()),
              ('fp32 ragged n=%d' % RAGGED_N[1], base32[1:].clone()),
              ('bf16 unaligned view (+6 bytes)', base16[3:]),
              ('fp32 unaligned view (+4 bytes)', base32[1:])]
    max_err = 0.0
    for label, x in cases:
        lo, hi = x.min().float(), x.max().float()
        for bits_value in (2, 4, 8, 16, 32):
            bits = torch.tensor(float(bits_value), device=device)
            k = fq._levels(bits)
            want = fq._quantize_math_torch(x, k, None).to(x.dtype)
            got = fq.fake_quant_per_tensor(x, bits)
            check(got.dtype == x.dtype and got.stride() == x.stride(),
                  'K1\' lost the layout of %s', label)
            err, nd = compare(got, want, float((hi - lo) / k))
            selected = fq.fake_quant_per_tensor(x, bits, select=True)
            if bits_value < 32:
                check(torch.equal(selected, got), 'K1\' with the select differs from K1\' '
                      'at %s, %d bits', label, bits_value)
            else:
                check(torch.equal(selected, x), 'K1\' with the select does not copy %s at 32 '
                      'bits', label)
            max_err = max(max_err, err)
            log('  %s bits=%d: max|d|=%.3g n_diff=%d vs plain; with the select %s', label,
                bits_value, err, nd, 'equal' if bits_value < 32 else 'a copy')
            del want, got, selected
    del cases, base16, base32
    bits = torch.tensor(8.0, device=device)
    k = fq._levels(bits)
    result = None
    for shape in ACT_SHAPES:
        x = act(shape)
        ms = time_ms(lambda: fq.fake_quant_per_tensor(x, bits, select=True))
        no_select_ms = time_ms(lambda: fq.fake_quant_per_tensor(x, bits))
        plain_ms = time_ms(lambda: torch.where(
            bits < 32, fq._quantize_math_torch(x, k, None).to(x.dtype), x), 5)
        bound_ms, bound_by = fq_bound(x.numel(), 2)
        log('  fake_quant_per_tensor with the select, bf16 act %s, 8 bits: kernel %.4f ms '
            '(%.0f%% of the bound; without the select %.4f ms), plain + select %.4f ms, '
            'bound %.4f ms (%s)', shape, ms, 100 * bound_ms / ms, no_select_ms, plain_ms,
            bound_ms, bound_by)
        if result is None:  # the line reports the largest activation
            result = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=None)
        del x
    return {'fake_quant_per_tensor': result}


def phase_column_group(fq, weight_shapes, device):
    """K2' with the select at the 52 weight shapes, channel and split
    buckets, mixed bits (2, 4, 8, 32 in turn; 32 copies): bit-equal to the
    plain version and, tensor by tensor below 32 bits, to the per-site ops
    (a group of one each, without the select)."""
    gen = torch.Generator(device=device).manual_seed(3)
    weights = [torch.randn(s, generator=gen, device=device) * 0.05 for s in weight_shapes]
    bits = torch.tensor([(2.0, 4.0, 8.0, 32.0)[i % 4] for i in range(len(weights))],
                        device=device)
    for bucket_type, bucket_size in (('channel', None), ('split', 256)):
        got = fq.fake_quant_per_column_group(weights, bits, bucket_size)
        for i, (w, b, g) in enumerate(zip(weights, bits, got)):
            want = torch.where(b < 32, fq._column_plain(w, fq._levels(b), bucket_size), w)
            check(torch.equal(g, want), 'grouped K2\' differs from plain at weight %d %s, %s, '
                  'bits %g', i, tuple(w.shape), bucket_type, float(b))
            if b < 32:
                per_site = (fq.fake_quant_channel_bucket(w, b) if bucket_size is None
                            else fq.fake_quant_split_bucket(w, b, bucket_size))
                check(torch.equal(g, per_site), 'grouped K2\' differs from the per-site op '
                      'at weight %d, %s', i, bucket_type)
        log('  fake_quant_per_column_group, %s buckets: %d weights, bits 2/4/8/32 in turn: equal '
            'to plain and to the per-site ops, tensor by tensor', bucket_type, len(weights))
    bits4 = torch.full((len(weights),), 4.0, device=device)
    b4 = bits4[0]
    bound_ms, bound_by = fq_bound(sum(w.numel() for w in weights))
    result = None
    for bucket_type, bucket_size, per_site in (
            ('channel', None, lambda w: fq.fake_quant_channel_bucket(w, b4)),
            ('split', 256, lambda w: fq.fake_quant_split_bucket(w, b4, 256))):
        ms = time_ms(lambda: fq.fake_quant_per_column_group(weights, bits4, bucket_size))
        plain_ms = time_ms(lambda: [torch.where(b < 32, fq._column_plain(
            w, fq._levels(b), bucket_size), w) for w, b in zip(weights, bits4)])
        per_site_ms = time_ms(lambda: [torch.where(b4 < 32, per_site(w), w) for w in weights])
        log('  fake_quant_per_column_group over the 52 weights of one step (4 bits, %s buckets): '
            'kernel %.4f ms (%.0f%% of the bound), plain %.4f ms, the per-site route (52 x '
            'per-site op + select) %.4f ms, bound %.4f ms (%s)', bucket_type, ms,
            100 * bound_ms / ms, plain_ms, per_site_ms, bound_ms, bound_by)
        if result is None:  # the line reports channel buckets
            result = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=None)
    return {'fake_quant_per_column_group': result}


def phase_kernels(fq, weight_shapes, device):
    """Phase 4: each fake-quant kernel against the plain version, at
    main-path shapes: K1' and the per-site bucket ops (K2', a group of one
    without the select) at bits 2, 4, 8 and 32 (quantized, not copied),
    then K1' on activations and both grouped routes."""
    per_tensor_err = 0.0
    gen = torch.Generator(device=device).manual_seed(0)
    distinct = sorted(set(weight_shapes))
    for bits_value in (2, 4, 8, 32):
        bits = torch.tensor(float(bits_value), device=device)
        k = fq._levels(bits)
        for shape in distinct:
            w = torch.randn(shape, generator=gen, device=device) * 0.05
            # per tensor (K1')
            want = fq._quantize_math_torch(w, k, None)
            err, nd = compare(fq.fake_quant_per_tensor(w, bits), want,
                              (w.max() - w.min()) / k)
            per_tensor_err = max(per_tensor_err, err)
            # the per-site bucket ops: channel ([-1, c_out]) and split (256)
            for label, got, size in (('channel', fq.fake_quant_channel_bucket(w, bits), None),
                                     ('split', fq.fake_quant_split_bucket(w, bits, 256), 256)):
                check(torch.equal(got, fq._column_plain(w, k, size)),
                      'per-site %s bucket op differs from plain at %s, %d bits', label, shape,
                      bits_value)
                check(not torch.equal(got, w), 'per-site %s bucket op copies %s at %d bits',
                      label, shape, bits_value)
            log('  bits=%d %-18s per-tensor max|d|=%.3g n_diff=%d | per-site channel and split '
                'bucket ops equal to plain', bits_value, str(shape), err, nd)

    # times: one pass over the main path's 52 quantized weights at 4 bits
    bits = torch.tensor(4.0, device=device)
    k = fq._levels(bits)
    weights = [torch.randn(s, generator=gen, device=device) for s in weight_shapes]
    bound_ms, bound_by = fq_bound(sum(w.numel() for w in weights))
    per_tensor_ms = time_ms(lambda: [fq.fake_quant_per_tensor(w, bits) for w in weights])
    per_tensor_plain_ms = time_ms(lambda: [fq._quantize_math_torch(w, k, None) for w in weights])
    per_site_ms = time_ms(lambda: [fq.fake_quant_channel_bucket(w, bits) for w in weights])
    log('  over the 52 weights of one step: fake_quant_per_tensor %.4f ms (plain %.4f ms), '
        'fake_quant_channel_bucket (52 groups of one) %.4f ms, bound %.4f ms (%s)', per_tensor_ms,
        per_tensor_plain_ms, per_site_ms, bound_ms, bound_by)
    results = phase_tensor_kernel(fq, device)
    results['fake_quant_per_tensor']['max_abs_err'] = max(
        results['fake_quant_per_tensor']['max_abs_err'], per_tensor_err)
    results.update(phase_group(fq, weight_shapes, device))
    results.update(phase_column_group(fq, weight_shapes, device))
    return results


def bf16_ulp(v):
    """The spacing of bf16 values at |v| (fp32 tensor)."""
    _, exponent = torch.frexp(v)
    return torch.ldexp(torch.ones_like(v), exponent - 8)


def compare_bf16(got, want, abs_terms):
    """Max |got - want| and the number of differing elements of a bf16
    product.  The tensor cores sum the fp32 products in another order and
    rounding than the plain version's fp32 matmul, so an element may differ
    by one bf16 ulp, or, where the sum cancels, by up to 2^-20 of the sum of
    the products' magnitudes (abs_terms = |a| @ |b|), in at most 2e-3 of the
    elements (1.15e-3 measured at K=2048, as many as cuBLAS's own bf16 GEMM
    shows against the plain version)."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    bound = torch.maximum(bf16_ulp(got), bf16_ulp(want)) + abs_terms * 2.0 ** -20
    n_diff = int((diff > 0).sum())
    over = float((diff - bound).max())
    check(over <= 0 and n_diff <= max(1, got.numel() // 500),
          'kernel differs from plain: %d elements, %.3g past the bound', n_diff, over)
    return float(diff.max()), n_diff


def stats_errors(s, ss, want_s, want_ss, abs_sum):
    """The largest column error of s relative to the column's sum of |y32|,
    and of ss relative to want_ss."""
    return (float(((s - want_s).abs() / abs_sum).max()),
            float(((ss - want_ss).abs() / want_ss).max()))


def stats_within(errors) -> bool:
    return errors[0] <= K3_S_TOL and errors[1] <= K3_SS_TOL


def phase_matmul(mm, device):
    """The matmul kernels against their plain versions at the experiments'
    shapes: matmul_bf16 at the 8 ResNet-50 1x1 shapes of mm_shape_sweep, the
    3 square trunk shapes of conv1x1_ab and ragged edges (and bit-equal on
    exact sums); bn_relu_matmul_stats at fused_mm_proto's shape and
    prologue, and at a ragged M, where the statistics' bounds must also fail
    two planted faults, and bit-equal on exact sums; its time beside
    matmul_bf16's and cuBLAS's on the same x and w (the same bytes)."""
    from pocketflow_tpu_torch.experiments import conv1x1_ab, mm_shape_sweep
    results = {'matmul_bf16': {'max_abs_err': 0.0, 'ms': 0.0, 'plain_ms': 0.0, 'bound_ms': 0.0,
                               'library_ms': 0.0},
               'bn_relu_matmul_stats': {'max_abs_err': 0.0}}
    gen = torch.Generator(device=device).manual_seed(0)

    def inputs(m, k, n):
        x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
        w = (torch.randn((k, n), generator=gen, device=device) * 0.05).to(torch.bfloat16)
        return x, w

    k4 = [(n * h * wd, c, c) for (n, h, wd), c in conv1x1_ab.SHAPES]
    bound_by_ms = {'bytes': 0.0, 'operations': 0.0}
    for m, k, n in mm_shape_sweep.SHAPES + k4 + MATMUL_RAGGED:
        x, w = inputs(m, k, n)
        got = mm.matmul_bf16(x, w)
        err, nd = compare_bf16(got, mm._matmul_plain(x, w), x.float().abs() @ w.float().abs())
        vs_cublas = int((got != torch.matmul(x, w)).sum())
        ints = [torch.randint(-3, 4, shape, generator=gen, device=device).to(torch.bfloat16)
                for shape in ((m, k), (k, n))]
        check(torch.equal(mm.matmul_bf16(*ints), mm._matmul_plain(*ints)),
              'matmul_bf16 M=%d K=%d N=%d is not exact on exact sums', m, k, n)
        results['matmul_bf16']['max_abs_err'] = max(results['matmul_bf16']['max_abs_err'], err)
        if (m, k, n) in MATMUL_RAGGED:
            log('  matmul_bf16 M=%d K=%d N=%d: max|d|=%.3g n_diff=%d, vs cuBLAS bf16 %d; exact '
                'on exact sums', m, k, n, err, nd, vs_cublas)
            continue
        ms = time_ms(lambda: mm.matmul_bf16(x, w))
        plain_ms = time_ms(lambda: mm._matmul_plain(x, w))
        cublas_ms = time_ms(lambda: torch.matmul(x, w))
        bound_ms, bound_by = matmul_bound_ms(m, k, n)
        if (m, k, n) in mm_shape_sweep.SHAPES:  # one pass over the 8 shapes of the sweep
            for key, value in (('ms', ms), ('plain_ms', plain_ms), ('bound_ms', bound_ms),
                               ('library_ms', cublas_ms)):
                results['matmul_bf16'][key] += value
            bound_by_ms[bound_by] += bound_ms
        log('  matmul_bf16 M=%d K=%d N=%d: max|d|=%.3g n_diff=%d (%.2e), vs cuBLAS bf16 %d; exact '
            'on exact sums | kernel %.4f ms, plain %.4f ms, cuBLAS bf16 %.4f ms, bound %.4f ms '
            '(%s): %.0f%% of the bound, cuBLAS/kernel %.2f',
            m, k, n, err, nd, nd / got.numel(), vs_cublas, ms, plain_ms, cublas_ms, bound_ms,
            bound_by, 100 * bound_ms / ms, cublas_ms / ms)
        del x, w, got, ints
    # the pass's bound is the sum of the shapes'; it is bound by what bounds most of it
    results['matmul_bf16']['bound_by'] = max(bound_by_ms, key=bound_by_ms.get)

    m, k, n = K3_SHAPE
    x, w = inputs(m, k, n)
    scale = torch.full((k,), K3_SCALE, device=device)
    shift = torch.full((k,), K3_SHIFT, device=device)
    for rows in (m, K3_RAGGED_M):
        xr = x[:rows]
        y, s, ss = mm.bn_relu_matmul_stats(xr, w, scale, shift)
        again = mm.bn_relu_matmul_stats(xr, w, scale, shift)
        check(all(torch.equal(a, b) for a, b in zip((y, s, ss), again)),
              'bn_relu_matmul_stats: two runs differ')
        want_y, want_s, want_ss = mm._bn_relu_matmul_stats_plain(xr, w, scale, shift)
        z = torch.relu(xr.float() * scale + shift).to(torch.bfloat16).float()
        err, nd = compare_bf16(y, want_y, z @ w.float().abs())
        abs_sum = (z @ w.float()).abs().sum(0)
        s_err, ss_err = stats_errors(s, ss, want_s, want_ss, abs_sum)
        check(stats_within((s_err, ss_err)), 'bn_relu_matmul_stats sums: s %.3g (of the '
              'column sums of |y32|), ss %.3g relative', s_err, ss_err)
        results['bn_relu_matmul_stats']['max_abs_err'] = max(
            results['bn_relu_matmul_stats']['max_abs_err'], err)
        log('  bn_relu_matmul_stats M=%d K=%d N=%d scale %.1f shift %.1f: y max|d|=%.3g '
            'n_diff=%d (%.2e); s err %.3g of sum|y32|, ss err %.3g relative; two runs equal',
            rows, k, n, K3_SCALE, K3_SHIFT, err, nd, nd / y.numel(), s_err, ss_err)
        # the sums in float64 from the bf16 z and w: every product is exact
        y64 = z.double() @ w.double()
        sums64 = (y64.sum(0), y64.square().sum(0), y64.abs().sum(0))
        del y64
        kernel64 = stats_errors(s.double(), ss.double(), *sums64)
        plain64 = stats_errors(want_s.double(), want_ss.double(), *sums64)
        log('  against float64 sums of the bf16 z and w: kernel s %.3g, ss %.3g; fp32 plain '
            'version s %.3g, ss %.3g', *kernel64, *plain64)
        check(kernel64[0] <= K3_S_TOL64 and kernel64[1] <= K3_SS_TOL64,
              'bn_relu_matmul_stats sums against float64: s %.3g, ss %.3g', *kernel64)
        if rows % mm._TILE_ROWS:
            # the plain version with the last tile's rows past M counted (x
            # zero-padded: each such row adds relu(shift) @ w), and with the
            # sums taken from bf16 y: the bounds must fail both
            pad = -rows % mm._TILE_ROWS
            _, pad_s, pad_ss = mm._bn_relu_matmul_stats_plain(
                torch.cat([xr, xr.new_zeros((pad, k))]), w, scale, shift)
            y16 = want_y.float()
            for fault, sums in (('%d rows past M counted' % pad, (pad_s, pad_ss)),
                                ('sums from bf16 y', (y16.sum(0), y16.square().sum(0)))):
                errors = stats_errors(*sums, want_s, want_ss, abs_sum)
                errors64 = stats_errors(*(t.double() for t in sums), *sums64)
                log('  planted fault, %s: s err %.3g, ss err %.3g (bounds %g, %g); against '
                    'float64 s %.3g, ss %.3g (bounds %g, %g)', fault, *errors, K3_S_TOL,
                    K3_SS_TOL, *errors64, K3_S_TOL64, K3_SS_TOL64)
                check(not stats_within(errors), 'the statistics bounds pass a kernel with %s',
                      fault)
                check(errors64[0] > K3_S_TOL64 or errors64[1] > K3_SS_TOL64,
                      'the float64 bounds pass a kernel with %s', fault)
            del pad_s, pad_ss, y16
        del z, want_y, abs_sum
    for shape in K3_EXACT:  # integers, scale 2, shift 0: every sum exact in fp32
        ints = [torch.randint(-3, 4, size, generator=gen, device=device).to(torch.bfloat16)
                for size in (shape[:2], shape[1:])]
        bn = (torch.full((shape[1],), 2.0, device=device), torch.zeros(shape[1], device=device))
        check(all(torch.equal(a, b) for a, b in zip(mm.bn_relu_matmul_stats(*ints, *bn),
                                                    mm._bn_relu_matmul_stats_plain(*ints, *bn))),
              'bn_relu_matmul_stats M=%d K=%d N=%d is not exact on exact sums', *shape)
    log('  bn_relu_matmul_stats at %s: y, s and ss exact on exact sums', K3_EXACT)
    ms = time_ms(lambda: mm.bn_relu_matmul_stats(x, w, scale, shift))
    plain_ms = time_ms(lambda: mm._bn_relu_matmul_stats_plain(x, w, scale, shift))
    matmul_ms = time_ms(lambda: mm.matmul_bf16(x, w))
    cublas_ms = time_ms(lambda: torch.matmul(x, w))
    # x, w, scale, shift read once; y, s, ss written once; the product on the
    # tensor cores, the prologue (multiply, add, max) and the sums (add,
    # multiply, add) in fp32
    bound_ms, bound_by = bound(2 * (m * k + k * n + m * n) + 4 * (2 * k + 2 * n),
                               {BF16_TENSOR_OPS_S: 2 * m * k * n,
                                FP32_OPS_S: 3 * m * k + 3 * m * n})
    results['bn_relu_matmul_stats'].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                           bound_by=bound_by, library_ms=None)
    log('  bn_relu_matmul_stats M=%d K=%d N=%d: kernel %.4f ms (%.0f%% of the bound), plain '
        '%.4f ms, bound %.4f ms (%s) | the product alone on the same x and w: matmul_bf16 '
        '%.4f ms, cuBLAS bf16 %.4f ms', m, k, n, ms, 100 * bound_ms / ms, plain_ms, bound_ms,
        bound_by, matmul_ms, cublas_ms)
    return results


def phase_experiments():
    """The three matmul experiments, short, at full shapes; each must launch
    its kernel and call no plain version.  Returns {run label: counters}."""
    from pocketflow_tpu_torch.experiments import conv1x1_ab, fused_mm_proto, mm_shape_sweep
    out = os.path.join(tempfile.gettempdir(), 'pocketflow_tpu_torch', 'conv1x1_ab_smoke.json')
    runs = {}
    for label, module, argv, kernel in (
            ('experiment fused_mm_proto: 2 reps at M=%d K=%d N=%d' % (
                fused_mm_proto.M, fused_mm_proto.K, fused_mm_proto.N), fused_mm_proto,
             ['--reps', '2'], 'bn_relu_matmul_stats'),
            ('experiment conv1x1_ab: 2 reps at its 3 shapes', conv1x1_ab,
             ['--reps', '2', '--out', out], 'matmul_bf16'),
            ('experiment mm_shape_sweep: 1 round of 2 reps at its 8 shapes', mm_shape_sweep,
             ['--rounds', '1', '--reps', '2'], 'matmul_bf16')):
        reset_counters()  # this run's launches are counted from here ...
        module.main(argv)  # raises SystemExit if its results fail its check_results
        runs[label] = counters()  # ... to here
        log('  %s: launches %s', label, runs[label])
        check(runs[label][kernel] > 0 and runs[label]['plain'] == 0,
              '%s: launches %s', label, runs[label])
    return runs


def phase_composed(learner, card):
    """bench.py's composed pruned+QAT step at the main path's settings."""
    from pocketflow_tpu_torch.learners.weight_sparsification.pruned_qat import (
        build_pruned_qat_step, channel_masks)
    t0 = time.perf_counter()
    state, tx, _ = learner.init_state_quant()
    masks = channel_masks(state.model)
    state, train_step = build_pruned_qat_step(learner, tx, state, masks)
    params = dict(state.model.named_parameters())
    masked = [name for name, m in masks.items() if m.dim() == 4]
    kernels = [params[name] for name in masked]
    dead = [1.0 - masks[name] for name in masked]
    check(len(masked) == 52, 'masked kernels %d', len(masked))
    iterator = learner.dataset_train.build()
    batches = [learner.put_batch(next(iterator)) for _ in range(4)]
    torch.cuda.synchronize()
    log('  set-up %.1f s; %d conv kernels masked, %d of %d of their input channels',
        time.perf_counter() - t0, len(masked), sum(int(d.sum()) for d in dead),
        sum(d.numel() for d in dead))

    def leak():
        """max |w| over the masked channels, on the device (no wait)."""
        with torch.no_grad():
            return torch.stack(torch._foreach_norm(torch._foreach_mul(kernels, dead),
                                                   float('inf'))).max()

    torch.cuda.reset_peak_memory_stats()
    leaks = []
    reset_counters()  # the composed run's launches are counted from here ...
    for i in range(COMPOSED_WARMUP):
        state, metrics = train_step(state, batches[i % 4], learner.generator(200 + i))
        leaks.append(leak())
    torch.cuda.synchronize()
    start = time.perf_counter()
    for i in range(COMPOSED_WARMUP, COMPOSED_WARMUP + COMPOSED_TIMED):
        state, metrics = train_step(state, batches[i % 4], learner.generator(200 + i))
        leaks.append(leak())
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - start
    counts = counters()  # ... to here
    loss = float(metrics['loss'])
    nb_steps = COMPOSED_WARMUP + COMPOSED_TIMED
    check(math.isfinite(loss), 'composed loss %r', loss)
    check(counts == no_launches(fake_quant_per_tensor_group=nb_steps),
          'composed step launches %s', counts)
    check(all(float(v) == 0.0 for v in leaks), 'masked channels not zero after a step: %s',
          [float(v) for v in leaks])
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log('  step %d loss %.4f acc %.4f; masked channels exactly zero after each of the %d steps',
        state.step, loss, float(metrics['accuracy']), nb_steps)
    log('  %.2f img/s, %.2f ms/step over %d steps (the zero check included), peak memory '
        '%.2f GiB | %s', BATCH * COMPOSED_TIMED / elapsed, 1e3 * elapsed / COMPOSED_TIMED,
        COMPOSED_TIMED, peak_gib, card)
    return counts


def phase_routes(FLAGS, learner, state, train_step, batches, card):
    """Phase 7: the other quantization routes, timed, each launching only
    its kernels.  Returns {run label: counters}."""
    from pocketflow_tpu_torch.learners.uniform_quantization.bit_optimizer import BitOptimizer
    runs = {}
    # launches a step: each forward quantizes the 52 weights in one
    # grouped launch pair; on the 8-bit route each activation goes through
    # K1' with the select, and no select runs outside a kernel
    routes = [(ACT8_RUN, dict(uql_activation_bits=8),
               dict(fake_quant_per_tensor_group=1, fake_quant_per_tensor=NB_ACT_SITES,
                    fake_quant_per_tensor_select=NB_ACT_SITES)),
              (CHANNEL_RUN, dict(uql_use_buckets=True, uql_bucket_type='channel'),
               dict(fake_quant_per_column_group=1)),
              (SPLIT_RUN, dict(uql_use_buckets=True, uql_bucket_type='split'),
               dict(fake_quant_per_column_group=1))]
    for label, flags, per_step in routes:
        with FLAGS.scope(**flags):
            state = learner.set_bits(state, *BitOptimizer(learner, state).run())
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counters()  # this route's launches are counted from here ...
            for i in range(ROUTE_STEPS):
                if i == ROUTE_WARMUP:
                    torch.cuda.synchronize()
                    start = time.perf_counter()
                state, metrics = train_step(state, batches[i % 4], learner.generator(100 + i))
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - start
            runs[label] = counters()  # ... to here
            loss = float(metrics['loss'])
        log('  %s: loss %.4f, launches %s', label, loss, runs[label])
        log('  %.2f img/s, %.2f ms/step over %d steps, peak memory %.2f GiB | %s',
            BATCH * ROUTE_TIMED / elapsed, 1e3 * elapsed / ROUTE_TIMED, ROUTE_TIMED,
            torch.cuda.max_memory_allocated() / 2 ** 30, card)
        check(math.isfinite(loss), '%s loss %r', label, loss)
        want = no_launches(**{name: ROUTE_STEPS * n for name, n in per_step.items()})
        check(runs[label] == want, '%s: launches %s, expected %s', label, runs[label], want)
    return runs


def phase_reference(FLAGS, make_helper, UniformQuantLearner, **flags):
    """The QAT step on the card (kernels, fp32, no TF32) against the same
    step on the CPU (plain version) from the same seed, at a small size."""
    small = dict(batch_size=4, batch_size_eval=4, nb_smpls_train=64, nb_smpls_eval=8,
                 compute_dtype='float32', **flags)
    with FLAGS.scope(**small):
        out = {}
        for device in ('cuda', 'cpu'):
            learner = UniformQuantLearner(None, make_helper(), device=device)
            ds = learner.dataset_train
            ds.augment_xy = lambda batch, gen, is_train, ds=ds: type(ds).augment_xy(
                ds, batch, gen, False)
            state, tx, _ = learner.init_state_quant()
            images, labels = ds.synthesize_arrays(8)
            batch = learner.put_batch({'image': images[:4], 'label': labels[:4]})
            logits = learner.model_helper.forward_eval(
                state.model, ds.augment(batch['image'], None, False),
                policy=learner._policy_fn()(state))
            _, metrics = learner.build_quant_train_step(tx)(state, batch, None)
            out[device] = (logits.detach().cpu(), float(metrics['loss']))
    logit_err = float((out['cuda'][0] - out['cpu'][0]).abs().max())
    loss_gpu, loss_cpu = out['cuda'][1], out['cpu'][1]
    log('  eval logits card vs CPU: max|d| = %.3g (of %.3g); train loss card %.6f, CPU %.6f',
        logit_err, float(out['cpu'][0].abs().max()), loss_gpu, loss_cpu)
    check(logit_err <= 1e-3 + 1e-3 * float(out['cpu'][0].abs().max()), 'logits disagree')
    check(abs(loss_gpu - loss_cpu) <= 1e-3 * abs(loss_cpu), 'train loss disagrees')


def phase_zoo_kernels(fq, weight_shapes, device):
    """The fake-quant kernels at the model zoo's shapes, against their plain
    versions bit for bit: K1' per tensor and the per-site bucket ops at
    each quantized weight shape (bits 2/4/8/32), the grouped K1' and K2'
    (channel and split buckets) over each net's weights with mixed bits and
    over one weight alone; K1' with and without the select on ResNet-20's
    activations and the dense ones after fc3's relu, bf16, 8 bits."""
    gen = torch.Generator(device=device).manual_seed(4)
    mixed = (2.0, 4.0, 8.0, 32.0)
    for net, shapes in weight_shapes.items():
        weights = [torch.randn(s, generator=gen, device=device) * 0.05 for s in shapes]
        for bits_value in (2, 4, 8, 32):
            bits = torch.tensor(float(bits_value), device=device)
            k = fq._levels(bits)
            for w in weights:
                want = fq._quantize_math_torch(w, k, None)
                compare(fq.fake_quant_per_tensor(w, bits), want, (w.max() - w.min()) / k)
                for got, size in ((fq.fake_quant_channel_bucket(w, bits), None),
                                  (fq.fake_quant_split_bucket(w, bits, 256), 256)):
                    check(torch.equal(got, fq._column_plain(w, k, size)),
                          'per-site bucket op differs from plain at %s, %d bits', tuple(w.shape),
                          bits_value)
        for offset in range(4):  # mixed bits, each weight at each of 2/4/8/32 in turn
            bits = torch.tensor([mixed[(i + offset) % 4] for i in range(len(weights))],
                                device=device)
            groups = [('grouped K1\'', fq.fake_quant_per_tensor_group(weights, bits),
                       lambda w, k: fq._quantize_math_torch(w, k, None))]
            groups += [('grouped K2\' %s' % label,
                        fq.fake_quant_per_column_group(weights, bits, size),
                        lambda w, k, size=size: fq._column_plain(w, k, size))
                       for label, size in (('channel', None), ('split', 256))]
            for label, got, plain in groups:
                for i, (w, b, g) in enumerate(zip(weights, bits, got)):
                    want = torch.where(b < 32, plain(w, fq._levels(b)), w)
                    check(torch.equal(g, want), '%s differs from plain on %s weight %d %s, '
                          'bits %g', label, net, i, tuple(w.shape), float(b))
        for w in weights:  # a group of one
            b = torch.full((1,), 4.0, device=device)
            check(torch.equal(fq.fake_quant_per_tensor_group([w], b)[0],
                              fq._quantize_math_torch(w, fq._levels(b[0]), None)),
                  'grouped K1\' differs from plain on %s alone', tuple(w.shape))
        log('  %s: %d quantized weights %s: K1\', the per-site bucket ops, the grouped K1\' and '
            'K2\' (mixed bits) equal to plain', net, len(weights),
            sorted({tuple(s) for s in shapes}))
        bits4 = torch.full((len(weights),), 4.0, device=device)
        k4 = fq._levels(bits4[0])
        ms = time_ms(lambda: fq.fake_quant_per_tensor_group(weights, bits4))
        plain_ms = time_ms(lambda: [fq._quantize_math_torch(w, k4, None) for w in weights])
        log('  fake_quant_per_tensor_group over %s\'s %d weights (4 bits): kernel %.4f ms, plain '
            '%.4f ms, bound %.4f ms (%s)', net, len(weights), ms, plain_ms,
            *fq_bound(sum(w.numel() for w in weights)))
    bits = torch.tensor(8.0, device=device)
    k = fq._levels(bits)
    for shape in ZOO_ACT_SHAPES:
        x = torch.relu(torch.randn(shape, generator=gen, device=device)).to(torch.bfloat16)
        if x.dim() == 4:
            x = x.contiguous(memory_format=torch.channels_last)
        want = fq._quantize_math_torch(x, k, None).to(x.dtype)
        got = fq.fake_quant_per_tensor(x, bits)
        check(got.stride() == x.stride(), 'K1\' lost the layout of %s', shape)
        err, nd = compare(got, want, float((x.max().float() - x.min().float()) / k))
        check(torch.equal(fq.fake_quant_per_tensor(x, bits, select=True), got),
              'K1\' with the select differs from K1\' on %s', shape)
        ms = time_ms(lambda: fq.fake_quant_per_tensor(x, bits, select=True))
        plain_ms = time_ms(lambda: torch.where(
            bits < 32, fq._quantize_math_torch(x, k, None).to(x.dtype), x))
        log('  K1\' bf16 act %s, 8 bits: max|d|=%.3g n_diff=%d vs plain; with the select equal | '
            'with the select %.4f ms, plain + select %.4f ms, bound %.4f ms (%s)', shape, err, nd,
            ms, plain_ms, *fq_bound(x.numel(), 2))


class ForwardCounter:
    """Counts the forwards of the zoo's nets that run under a quantization
    policy (the student's and a roll-out's, alone or inside a layerwise
    tune's CapturePolicy; the teacher and the regression targets run under
    none), by a global forward pre-hook, and records each learner's
    train-step metrics and eval means.  `on_step(when, state)`, if given, is
    called just 'before' and just 'after' each train step."""

    def __init__(self, on_step=None):
        from pocketflow_tpu_torch.learners.abstract_learner import AbstractLearner
        self.forwards = self.steps = 0
        self.metrics, self.evals = None, []
        counter = self
        build_train_step, run_eval_loop = (AbstractLearner.build_train_step,
                                           AbstractLearner.run_eval_loop)

        def counted_build(learner, *args, **kwargs):
            step_fn = build_train_step(learner, *args, **kwargs)

            def counted(state, batch, generator):
                if on_step is not None:
                    on_step('before', state)
                state, metrics = step_fn(state, batch, generator)
                counter.steps += 1
                counter.metrics = metrics
                if on_step is not None:
                    on_step('after', state)
                return state, metrics
            return counted

        def recorded_eval(learner, *args, **kwargs):
            means = run_eval_loop(learner, *args, **kwargs)
            counter.evals.append(means)
            return means

        self._undo = [(AbstractLearner, 'build_train_step', build_train_step),
                      (AbstractLearner, 'run_eval_loop', run_eval_loop)]
        AbstractLearner.build_train_step = counted_build
        AbstractLearner.run_eval_loop = recorded_eval
        self._hook = torch.nn.modules.module.register_module_forward_pre_hook(self._pre_hook)

    def _pre_hook(self, module, inputs):
        from pocketflow_tpu_torch.nn.layers import current_policy
        policy = current_policy()
        # a layerwise tune's forward runs the quantization policy inside a
        # CapturePolicy
        if type(module).__name__ in ZOO_NETS and any(
                type(p).__name__ in QUANT_POLICIES for p in (policy, getattr(policy, 'inner', None))):
            self.forwards += 1

    def close(self):
        self._hook.remove()
        for owner, name, fn in self._undo:
            setattr(owner, name, fn)


def run_main(FLAGS, work_dir, model, argv, on_step=None, make_argv=None):
    """main.main(argv) for `model` on the card at the zoo's batch, on the
    CIFAR-10 files under work_dir (checkpoints and logs there too), or with
    the argv `make_argv(work_dir, model, argv)` gives; its launches counted
    from a reset just before it to just after it.  Returns (learner,
    ForwardCounter, counters, seconds)."""
    from pocketflow_tpu_torch import main as port_main
    argv = (make_argv or zoo_argv)(work_dir, model, argv)
    counter = ForwardCounter(on_step)
    start = time.perf_counter()
    try:
        with FLAGS.scope(**FLAGS.as_dict()):
            reset_counters()  # this run's launches are counted from here ...
            learner = port_main.main(argv, device='cuda')
            torch.cuda.synchronize()
            counts = counters()  # ... to here
    finally:
        counter.close()
    return learner, counter, counts, time.perf_counter() - start


def zoo_argv(work_dir, model, argv):
    """main.main's argv for `model` at the zoo's batch on the CIFAR-10 files
    under work_dir, with checkpoints and logs there too, then `argv`."""
    model_dir = os.path.join(work_dir, model)
    return ['--model=%s' % model, '--data_dir_local=%s' % os.path.join(work_dir, 'cifar10'),
            '--batch_size=%d' % ZOO_BATCH, '--nb_smpls_train=%d' % ZOO_TRAIN,
            '--nb_smpls_eval=%d' % ZOO_EVAL, '--compute_dtype=bfloat16',
            '--log_dir=%s' % os.path.join(work_dir, 'logs', model),
            '--save_path=%s' % os.path.join(model_dir, 'models', 'model.ckpt'),
            '--uql_save_quant_model_path=%s' % os.path.join(model_dir, 'uql', 'model.ckpt'),
            '--uql_tune_save_path=%s' % os.path.join(model_dir, 'rl', 'model.ckpt'),
            '--uqtf_save_path=%s' % os.path.join(model_dir, 'uqtf', 'model.ckpt'),
            '--nuql_save_quant_model_path=%s' % os.path.join(model_dir, 'nuql', 'model.ckpt'),
            '--nuql_tune_save_path=%s' % os.path.join(model_dir, 'nuql_rl', 'model.ckpt')] + argv


def phase_zoo_path(FLAGS, work_dir, card):
    """The zoo's path at full width through main.main on the card: each run
    with its launches counted from its own reset, a finite loss and finite
    eval metrics; one launch pair of the grouped kernel a quantized forward,
    19 of K1' with the select a forward on the 8-bit run, no kernel on the
    full-precision run (the teacher's), no plain call anywhere.  Returns
    {run label: counters}."""
    from pocketflow_tpu_torch.tools import make_minimal_data
    t0 = time.perf_counter()
    make_minimal_data.main(['--dst_dir=%s' % work_dir, '--datasets=cifar10',
                            '--nb_train=%d' % ZOO_TRAIN, '--nb_eval=%d' % ZOO_EVAL])
    log('  CIFAR-10 .bin files (%d train, %d eval records) written in %.1f s', ZOO_TRAIN,
        ZOO_EVAL, time.perf_counter() - t0)
    runs = {}
    for label, model, argv, per_forward in ZOO_RUNS:
        learner, counter, runs[label], elapsed = run_main(FLAGS, work_dir, model, argv)
        loss = float(counter.metrics['loss'])
        check(math.isfinite(loss), '%s: loss %r', label, loss)
        check(counter.evals and all(math.isfinite(v) for v in counter.evals[-1].values()),
              '%s: eval %s', label, counter.evals)
        want = no_launches(**{name: n * counter.forwards for name, n in per_forward.items()})
        check(runs[label] == want, '%s: launches %s over %d quantized forwards, expected %s',
              label, runs[label], counter.forwards, want)
        if per_forward:
            stats = learner.statistics
            check((stats['nb_matmuls'], stats['nb_activations']) == ZOO_SITES[model],
                  '%s: sites %d/%d', label, stats['nb_matmuls'], stats['nb_activations'])
            check(counter.forwards > counter.steps > 0, '%s: %d forwards, %d steps', label,
                  counter.forwards, counter.steps)
        else:
            check(counter.forwards == 0 and counter.steps > 0, '%s: %d quantized forwards',
                  label, counter.forwards)
        log('  %s: %d steps, %d quantized forwards, loss %.4f, eval %s | launches %s | %.1f s '
            '(the run, its evals and its checkpoint)', label, counter.steps, counter.forwards,
            loss, {k: round(v, 4) for k, v in counter.evals[-1].items()}, runs[label], elapsed)
    return runs


def phase_zoo_timing(FLAGS, work_dir, card):
    """Runs A and B's steps timed at batch 128: ZOO_TIMED steps on 4 staged
    batches after ZOO_TIMED_WARMUP, host clock ended by a synchronize."""
    from pocketflow_tpu_torch.learners.full_precision import FullPrecLearner
    from pocketflow_tpu_torch.learners.uniform_quantization.bit_optimizer import BitOptimizer
    from pocketflow_tpu_torch.learners.uniform_quantization.learner import UniformQuantLearner
    from pocketflow_tpu_torch.nets.resnet_at_cifar10 import ModelHelper
    model_dir = os.path.join(work_dir, 'resnet_at_cifar10')
    for label, enbl_dst in (('run A (full-prec)', False),
                            ('run B (uniform 4-bit + distillation)', True)):
        with FLAGS.scope(data_dir_local=os.path.join(work_dir, 'cifar10'), batch_size=ZOO_BATCH,
                         nb_smpls_train=ZOO_TRAIN, compute_dtype='bfloat16', enbl_dst=enbl_dst,
                         uql_weight_bits=4, uql_activation_bits=32, uql_use_buckets=False,
                         save_path=os.path.join(model_dir, 'models', 'model.ckpt')):
            if enbl_dst:
                learner = UniformQuantLearner(None, ModelHelper(), device='cuda')
                state, tx, _ = learner.init_state_quant()
                state, restored = learner.restore_baseline(state)
                check(restored, 'run B: no baseline under %s', model_dir)
                state = learner.set_bits(state, *BitOptimizer(learner, state).run())
                train_step = learner.build_quant_train_step(tx)
            else:
                learner = FullPrecLearner(None, ModelHelper(), device='cuda')
                state, tx, _ = learner.init_state()
                train_step = learner.build_train_step(tx)
            iterator = learner.dataset_train.build()
            batches = [learner.put_batch(next(iterator)) for _ in range(4)]
            for i in range(ZOO_TIMED_WARMUP):
                state, metrics = train_step(state, batches[i % 4], learner.generator(i))
            torch.cuda.synchronize()
            start = time.perf_counter()
            for i in range(ZOO_TIMED):
                state, metrics = train_step(state, batches[i % 4], learner.generator(i))
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - start
            check(math.isfinite(float(metrics['loss'])), '%s loss', label)
        log('  ResNet-20 @ CIFAR-10 %s, bf16, batch %d: %.2f img/s, %.3f ms/step over %d steps '
            '| %s', label, ZOO_BATCH, ZOO_BATCH * ZOO_TIMED / elapsed, 1e3 * elapsed / ZOO_TIMED,
            ZOO_TIMED, card)


def phase_ddpg(card):
    """Phase 14: the DDPG agent on the card.  Two agents from one seed (the
    same host-drawn networks), on the card and on the CPU; the CPU agent
    takes two updates, the card agent a copy of its nets and Adam states (a
    deep copy: the optimizer's load_state_dict keeps Adam's CPU step count as
    the very tensor it was given), and both take one more update on the same
    minibatch: every tensor of the state after it (nets, targets, Adam
    moments) and both losses within rtol 1e-5 of the CPU's, on the L2 norm of
    the difference.  Then a train update and an actions_noisy call timed on
    the card."""
    import numpy as np
    from pocketflow_tpu_torch.rl_agents.ddpg.agent import DdpgAgent
    rng = np.random.default_rng(0)
    agents = {name: DdpgAgent(s_dims=DDPG_S_DIMS, a_dims=1, nb_rlouts=200,
                              buf_size=DDPG_BUF_SIZE, seed=0, device=name)
              for name in ('cuda', 'cpu')}
    states = rng.uniform(size=(DDPG_BUF_SIZE + 1, DDPG_S_DIMS)).astype(np.float32)
    actions, rewards = rng.uniform(size=(DDPG_BUF_SIZE, 1)), rng.normal(size=DDPG_BUF_SIZE)
    for agent in agents.values():
        agent.init()
        agent.record(states[:-1], actions, rewards, np.zeros(DDPG_BUF_SIZE), states[1:])
    cpu, gpu = agents['cpu'], agents['cuda']
    for _ in range(2):
        cpu.train()
    for name in ('actor', 'critic', 'actor_tr', 'critic_tr', 'opt_actor', 'opt_critic'):
        getattr(gpu, name).load_state_dict(copy.deepcopy(getattr(cpu, name).state_dict()))
    batch = cpu.memory.sample(64)
    out = {}
    for name, agent in agents.items():
        losses = agent._train(batch)
        out[name] = {'actor_loss': losses[0].cpu().double(),
                     'critic_loss': losses[1].cpu().double()}
        for net in ('actor', 'critic', 'actor_tr', 'critic_tr'):
            out[name].update({'%s.%s' % (net, k): v.detach().cpu().double()
                              for k, v in getattr(agent, net).named_parameters()})
        for opt, net in (('opt_actor', 'actor'), ('opt_critic', 'critic')):
            for k, p in getattr(agent, net).named_parameters():
                st = getattr(agent, opt).state[p]
                out[name]['%s.%s.m' % (opt, k)] = st['exp_avg'].cpu().double()
                out[name]['%s.%s.v' % (opt, k)] = st['exp_avg_sq'].cpu().double()
    want, got = out['cpu'], out['cuda']
    rel = {k: float((got[k] - w).norm() / w.norm().clamp_min(1e-30)) for k, w in want.items()}
    worst = max(rel, key=rel.get)
    log('  one update, card vs CPU from the same state: %d tensors and both losses, worst '
        'relative L2 difference %.3g (%s), median %.3g; losses %.3g and %.3g relative (bound '
        '1e-5)', len(want), rel[worst], worst, sorted(rel.values())[len(rel) // 2],
        rel['actor_loss'], rel['critic_loss'])
    check(rel[worst] <= 1e-5, 'DDPG update on the card differs from the CPU at %s', worst)
    state_vec = states[:1]
    train_ms = time_ms(gpu.train)
    act_ms = time_ms(lambda: gpu.actions_noisy(state_vec))
    log('  DDPG on the card (s_dims %d, batch 64, widths 64): a train update %.3f ms, an '
        'actions_noisy call %.3f ms (CUDA events over 20 calls, the host side included) | %s',
        DDPG_S_DIMS, train_ms, act_ms, card)


def ws_masked_weights_zero(path):
    """Every masked weight of the newest checkpoint under `path` is 0."""
    from pocketflow_tpu_torch.core import checkpoint as ckpt_lib
    payload = ckpt_lib.restore_latest(path, map_location='cpu')
    masks, model = payload['extra']['masks'], payload['model']
    masked = [name for name, m in masks.items() if m.dim()]
    check(masked and all(not torch.any(model[n][masks[n] == 0]) for n in masked),
          'masked weights not zero in %s', path)
    return len(masked)


def phase_ws_path(FLAGS, work_dir, card):
    """Phase 15: weight sparsification through main.main at full width:
    runs G (uniform), H (optimal, 2 roll-outs) on ResNet-20 from run A's
    baseline, J (ConvNet @ FMNIST, uniform); each ends with pr_msk at its
    target, every masked weight exactly 0 and no kernel launched.  Returns
    {run label: counters}."""
    runs = {}
    for label, model, argv in WS_RUNS:
        ws_path = os.path.join(work_dir, model, label.split(':')[0].replace(' ', '_'), 'model.ckpt')
        learner, counter, runs[label], elapsed = run_main(
            FLAGS, work_dir, model, argv + ['--ws_save_path=%s' % ws_path])
        ev = counter.evals[-1]
        check(all(math.isfinite(v) for v in ev.values()), '%s: eval %s', label, ev)
        check(runs[label] == no_launches() and counter.steps > 0, '%s: launches %s', label,
              runs[label])
        pairs = learner.var_names_n_prune_ratios
        params = dict(learner.init_state()[0].model.named_parameters())
        sizes = [params[name].numel() for name, _ in pairs]
        target = sum(n * r for n, (_, r) in zip(sizes, pairs)) / sum(sizes)
        check(target >= 0.5 - 0.01, '%s: overall ratio %.4f under the budget', label, target)
        check(abs(ev['pr_msk'] - target) <= 0.02, '%s: pr_msk %.4f, target %.4f', label,
              ev['pr_msk'], target)
        nb_masked = ws_masked_weights_zero(ws_path)
        log('  %s: %d steps, pr_msk %.4f (target %.4f), pr_trn %.4f, %d masked kernels exactly '
            'zero where masked, loss %.4f, eval accuracy %.4f | launches %s | %.1f s', label,
            counter.steps, ev['pr_msk'], target, ev['pr_trn'], nb_masked,
            float(counter.metrics['loss']), ev['accuracy'], runs[label], elapsed)
        if 'optimal' in label:
            log('  %s: ratios %s', label, [round(r, 4) for _, r in pairs])
    return runs


def phase_ws_timing(FLAGS, work_dir, card):
    """Phase 15, timed: a WS step of ResNet-20 at batch 128 without and with
    a mask refresh (host clock over staged batches, ended by a synchronize);
    masking.prune_update alone on ResNet-50's maskable kernels at bench.py's
    shapes (CUDA events); one WS roll-out's regression, finetune and eval
    steps."""
    from pocketflow_tpu_torch.learners.weight_sparsification import masking
    from pocketflow_tpu_torch.learners.weight_sparsification import pr_optimizer as pr
    from pocketflow_tpu_torch.learners.weight_sparsification.learner import WeightSparseLearner
    from pocketflow_tpu_torch.nets import resnet_at_cifar10, resnet_at_ilsvrc12
    model_dir = os.path.join(work_dir, 'resnet_at_cifar10')
    with FLAGS.scope(data_dir_local=os.path.join(work_dir, 'cifar10'), batch_size=ZOO_BATCH,
                     nb_smpls_train=ZOO_TRAIN, compute_dtype='bfloat16', nb_epochs_rat=1.0,
                     save_path=os.path.join(model_dir, 'models', 'model.ckpt')):
        learner = WeightSparseLearner(None, resnet_at_cifar10.ModelHelper(), device='cuda')
        state, tx, _ = learner.init_state()
        state, restored = learner.restore_baseline(state)
        check(restored, 'no ResNet-20 baseline under %s', model_dir)
        params = dict(state.model.named_parameters())
        ratios = {name: 0.5 for name in masking.maskable_paths(params)}
        iterator = learner.dataset_train.build()
        batches = [learner.put_batch(next(iterator)) for _ in range(4)]
        times = {}
        for label, flags in (('without a refresh', dict(ws_mask_update_step=10 ** 9)),
                             ('with a refresh every step', dict(
                                 ws_mask_update_step=1, ws_iter_ratio_beg=0.0,
                                 ws_iter_ratio_end=1.0))):
            with FLAGS.scope(**flags):
                state, train_step = learner.build_sparse_train_step(tx, state, ratios)
            for i in range(ZOO_TIMED_WARMUP):
                state, metrics = train_step(state, batches[i % 4], learner.generator(i))
            torch.cuda.synchronize()
            start = time.perf_counter()
            for i in range(ZOO_TIMED):
                state, metrics = train_step(state, batches[i % 4], learner.generator(i))
            torch.cuda.synchronize()
            times[label] = 1e3 * (time.perf_counter() - start) / ZOO_TIMED
            check(math.isfinite(float(metrics['loss'])), 'WS step loss')
        log('  WS step, ResNet-20 @ CIFAR-10, bf16, batch %d: %.3f ms without a refresh, %.3f ms '
            'with a refresh every step (%d steps each) | %s', ZOO_BATCH,
            times['without a refresh'], times['with a refresh every step'], ZOO_TIMED, card)

        # one roll-out of the optimal protocol at the default ratios' kind
        full = state.model
        pruned = learner.create_model()
        rollout = {}
        torch.cuda.synchronize()
        start = time.perf_counter()
        masks = pr.rollout_init(full, pruned, ratios)
        torch.cuda.synchronize()
        rollout['init'] = 1e3 * (time.perf_counter() - start)
        for part, nb, step in (
                ('regression', WS_ROLLOUT_STEPS, lambda opt, b: pr.regression_step(
                    learner, full, pruned, masks, opt, b)),
                ('finetune', WS_ROLLOUT_STEPS, lambda opt, b: pr.finetune_step(
                    learner, pruned, masks, opt, b)),
                ('eval', WS_ROLLOUT_STEPS, lambda opt, b: pr.feval_step(learner, pruned, b))):
            opt = (pr.regression_optimizer(pruned) if part == 'regression'
                   else pr.finetune_optimizer(pruned))
            step(opt, batches[0])
            torch.cuda.synchronize()
            start = time.perf_counter()
            for i in range(nb):
                step(opt, batches[i % 4])
            torch.cuda.synchronize()
            rollout[part] = 1e3 * (time.perf_counter() - start) / nb
        default = (rollout['init'] + 20 * rollout['regression'] + 400 * rollout['finetune']
                   + 25 * rollout['eval'])
        log('  WS roll-out, ResNet-20 b%d: init (load, masks) %.3f ms; a regression step %.3f ms, '
            'a finetune step %.3f ms, an eval step %.3f ms (%d each); at the default 20/400/25 '
            'steps a roll-out takes %.1f ms | %s', ZOO_BATCH, rollout['init'],
            rollout['regression'], rollout['finetune'], rollout['eval'], WS_ROLLOUT_STEPS,
            default, card)
        del learner, state, pruned, batches

    with FLAGS.scope(compute_dtype='bfloat16', ilsvrc_image_size=224, resnet_size=50):
        model = resnet_at_ilsvrc12.ModelHelper(resnet_size=50).create_model()
        model.reset_parameters(torch.Generator().manual_seed(0))
        model = model.to('cuda')
        params = dict(model.named_parameters())
        extra = masking.build_mask_state(params)
        names = masking.maskable_paths(params)
        ratios = {name: 0.5 for name in names}
        ms = time_ms(lambda: masking.prune_update(params, extra, 1000, 1000, ratios), 5)
        nb = sum(params[n].numel() for n in names)
    log('  masking.prune_update on ResNet-50\'s %d maskable kernels (%.1f M weights, fp32; '
        'bisection above 65,536 elements): %.3f ms a refresh (CUDA events over 5) | %s',
        len(names), nb / 1e6, ms, card)
    del model, params, extra


def phase_bit_search(FLAGS, work_dir, card):
    """Phase 16: the RL bit search through main.main (run I, ResNet-20 from
    run A's baseline, 2 roll-outs, each layerwise-tuned and finetuned): one
    grouped K1' launch pair per quantized forward (a roll-out's, its
    layerwise tune's, the final finetune's and the evals'), no plain call,
    at least two bit widths within one launch, the chosen bits under the
    budget.  Then one roll-out timed and the grouped K1' timed at the chosen
    bits.  Returns {run label: counters}."""
    import numpy as np
    from pocketflow_tpu_torch.learners.uniform_quantization import bit_optimizer
    from pocketflow_tpu_torch.learners.uniform_quantization.learner import UniformQuantLearner
    from pocketflow_tpu_torch.nets.resnet_at_cifar10 import ModelHelper
    from pocketflow_tpu_torch.ops import fake_quant as fq
    launches_bits, group = [], fq.fake_quant_group

    def recording(xs, bits):
        launches_bits.append(bits.detach().clone())
        return group(xs, bits)

    fq.fake_quant_group = recording
    try:
        learner, counter, counts, elapsed = run_main(FLAGS, work_dir, 'resnet_at_cifar10',
                                                     BIT_SEARCH_ARGV)
    finally:
        fq.fake_quant_group = group
    label = BIT_SEARCH_RUN
    check(counts == no_launches(fake_quant_per_tensor_group=counter.forwards),
          '%s: launches %s over %d quantized forwards', label, counts, counter.forwards)
    check(len(launches_bits) == counter.forwards > counter.steps > 0, '%s: %d grouped calls, %d '
          'forwards, %d steps', label, len(launches_bits), counter.forwards, counter.steps)
    widths = [sorted({int(b) for b in bits.tolist()}) for bits in launches_bits]
    check(any(len(w) >= 2 for w in widths), '%s: one bit width a launch: %s', label, widths)
    bits = learner.optimal_w_bit_list
    num_weights = learner.statistics['num_weights']
    used = float(np.dot(bits, num_weights))
    check(used <= 4 * sum(num_weights) and all(2 <= b <= 8 for b in bits),
          '%s: bits %s over the budget', label, bits)
    ev = counter.evals[-1]
    check(all(math.isfinite(v) for v in ev.values()), '%s: eval %s', label, ev)
    log('  %s: %d quantized forwards, %d grouped K1\' launch pairs, bit widths a launch %s; '
        'chosen bits %s (%.3f bits a weight, budget 4) | eval %s | launches %s | %.1f s', label,
        counter.forwards, counts['fake_quant_per_tensor_group'],
        sorted({tuple(w) for w in widths}), bits, used / sum(num_weights),
        {k: round(v, 4) for k, v in ev.items()}, counts, elapsed)

    # one roll-out, timed, and the grouped K1' at the chosen bits
    with FLAGS.scope(data_dir_local=os.path.join(work_dir, 'cifar10'), batch_size=ZOO_BATCH,
                     nb_smpls_train=ZOO_TRAIN, compute_dtype='bfloat16', uql_weight_bits=4,
                     uql_activation_bits=32, uql_use_buckets=False, uql_enbl_rl_agent=True,
                     uql_enbl_rl_layerwise_tune=False, uql_tune_global_steps=BIT_ROLLOUT_STEPS,
                     save_path=os.path.join(work_dir, 'resnet_at_cifar10', 'models', 'model.ckpt')):
        learner = UniformQuantLearner(None, ModelHelper(), device='cuda')
        state, _, _ = learner.init_state_quant()
        state, restored = learner.restore_baseline(state)
        check(restored, 'no ResNet-20 baseline')
        optimizer = bit_optimizer.BitOptimizer(learner, state)
        programs = optimizer.rollout_programs()
        optimizer.rollout(bits, 0, programs)  # warm-up
        torch.cuda.synchronize()
        start = time.perf_counter()
        accuracy = optimizer.rollout(bits, 1, programs)
        rollout_ms = 1e3 * (time.perf_counter() - start)
        check(math.isfinite(accuracy), 'roll-out accuracy %r', accuracy)
        nb_feval = min(8, learner.dataset_train.spec.nb_smpls_val // ZOO_BATCH)
        weights = learner._policy_fn()(state).weights
        w_bits = torch.tensor(bits, dtype=torch.float32, device='cuda')
        ms = time_ms(lambda: fq.fake_quant_per_tensor_group(weights, w_bits))
        plain_ms = time_ms(lambda: [torch.where(b < 32, fq._quantize_math_torch(
            w, fq._levels(b), None), w) for w, b in zip(weights, w_bits)])
    log('  one bit-search roll-out, ResNet-20 b%d (copy, bits, %d finetune steps, %d eval '
        'batches): %.1f ms, accuracy %.4f | the grouped K1\' over the 20 weights at the chosen '
        'bits %s: kernel %.4f ms, plain %.4f ms, bound %.4f ms (%s) | %s', ZOO_BATCH,
        BIT_ROLLOUT_STEPS, nb_feval, rollout_ms, accuracy, bits, ms, plain_ms,
        *fq_bound(sum(w.numel() for w in weights)), card)
    return {label: counts}


class StepRecorder:
    """`on_step` for run_main: the host time of each train step (ended by a
    synchronize), the launch counts after it, and each step's BN running
    statistics and activation ranges before and after it."""

    def __init__(self):
        self.steps = []

    def __call__(self, when, state):
        torch.cuda.synchronize()
        snapshot = {'t': time.perf_counter(), 'counts': counters(),
                    'stats': [b.clone() for b in state.model.buffers()],
                    'ranges': {k: state.extra[k].clone() for k in ('act_min', 'act_max')
                               if k in (state.extra or {})}}
        if when == 'before':
            self.steps.append({'before': snapshot})
        else:
            self.steps[-1]['after'] = snapshot

    def ms(self, index):
        return 1e3 * (self.steps[index]['after']['t'] - self.steps[index]['before']['t'])

    def launches(self, index, name):
        return self.steps[index]['after']['counts'][name] - self.steps[index]['before']['counts'][name]


def median(values):
    values = sorted(values)
    return values[len(values) // 2] if values else float('nan')


def run_mobilenet(FLAGS, work_dir, label, version, argv, nb_steps, on_step=None):
    """One MobileNet run through main.main at full width on the card: its
    launches counted from a reset just before it to just after it, its peak
    memory.  Returns (learner, ForwardCounter, counters, seconds, peak GiB)."""
    run_dir = os.path.join(work_dir, 'mobilenet', label.split(':')[0].split()[-1])
    argv = argv + ['--save_path=%s' % os.path.join(run_dir, 'models', 'model.ckpt'),
                   '--uqtf_save_path=%s' % os.path.join(run_dir, 'uqtf', 'model.ckpt'),
                   '--nuql_save_quant_model_path=%s' % os.path.join(run_dir, 'nuql', 'model.ckpt'),
                   '--model=mobilenet_at_ilsvrc12', '--mobilenet_version=%d' % version,
                   '--mobilenet_depth_mult=1.0', '--data_dir_local=',
                   '--batch_size=%d' % MB_BATCH, '--batch_size_eval=%d' % MB_BATCH,
                   '--nb_smpls_train=%d' % (MB_BATCH * nb_steps), '--nb_smpls_eval=%d' % MB_EVAL,
                   '--uql_quant_epochs=1', '--nuql_quant_epochs=1', '--nb_epochs_rat=1']
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    learner, counter, counts, elapsed = run_main(FLAGS, work_dir, 'mobilenet_at_ilsvrc12', argv,
                                                 on_step)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(counter.steps == nb_steps, '%s: %d steps', label, counter.steps)
    loss = float(counter.metrics['loss'])
    check(math.isfinite(loss), '%s: loss %r', label, loss)
    check(counter.evals and all(math.isfinite(v) for v in counter.evals[-1].values()),
          '%s: eval %s', label, counter.evals)
    want_sites = MB_SITES[version] if 'uniform-tf' in label else (MB_NUQ_WEIGHTS,
                                                                  MB_SITES[version][1])
    stats = learner.statistics
    check((stats['nb_matmuls'], stats['nb_activations']) == want_sites, '%s: sites %d/%d',
          label, stats['nb_matmuls'], stats['nb_activations'])
    return learner, counter, counts, elapsed, peak


def phase_mobilenet_uqtf(FLAGS, work_dir, card):
    """Runs K and L: the uniform-tf learner through main.main.  Run K: no
    fake-quant launch in the steps before the quant delay, then one grouped
    K2' launch pair (channel buckets, without the select) a forward for
    all 28 weights; every site's range moved by exactly the EMA of its
    batch (min, max) in every step, the delay's steps included; BN running
    statistics that change in every step through UQTF_FREEZE and are
    bit-unchanged after; the step time in each regime.  Run L: MobileNet-v2,
    one grouped K2' pair a forward for its 53 weights.  Returns {label:
    counters}."""
    import numpy as np
    from pocketflow_tpu_torch.learners.uniform_quantization_tf import learner as uqtf
    runs = {}
    batches, update = [], uqtf.RangeQuantPolicy.update_ranges

    def recording_update(policy, ema):
        batches.append(torch.stack([r for _, r in policy.batch_ranges]).float().cpu())
        return update(policy, ema)

    for label, version, argv, nb_steps in MB_RUNS[:2]:
        recorder = StepRecorder()
        batches.clear()
        uqtf.RangeQuantPolicy.update_ranges = recording_update
        try:
            learner, counter, counts, elapsed, peak = run_mobilenet(
                FLAGS, work_dir, label, version, argv, nb_steps, recorder)
        finally:
            uqtf.RangeQuantPolicy.update_ranges = update
        runs[label] = counts
        nb_eval = counter.forwards - counter.steps
        check(nb_eval > 0, '%s: %d forwards for %d steps', label, counter.forwards, counter.steps)
        delay = UQTF_DELAY if 'run K' in label else 0
        freeze = UQTF_FREEZE if 'run K' in label else None
        per_step = [recorder.launches(i, 'fake_quant_per_column_group') for i in range(nb_steps)]
        check(per_step == [0] * delay + [1] * (nb_steps - delay), '%s: K2\' launches a step %s',
              label, per_step)
        check(counts == no_launches(fake_quant_per_column_group=nb_steps - delay + nb_eval),
              '%s: launches %s (%d steps, %d eval forwards)', label, counts, nb_steps, nb_eval)
        # the ranges: ema * old + (1 - ema) * this step's batch, in fp32
        ema = np.float32(FLAGS.uqtf_ema_decay)
        check(len(batches) == nb_steps, '%s: %d range updates', label, len(batches))
        worst = 0.0
        for i, batch in enumerate(batches):
            before, after = recorder.steps[i]['before']['ranges'], recorder.steps[i]['after']['ranges']
            for j, key in enumerate(('act_min', 'act_max')):
                old = before[key].cpu().numpy()
                want = ema * old + np.float32(1 - FLAGS.uqtf_ema_decay) * batch[:, j].numpy()
                worst = max(worst, float(np.abs(after[key].cpu().numpy() - want).max()))
        check(worst <= 1e-6, '%s: ranges off the EMA by %.3g', label, worst)
        final = recorder.steps[-1]['after']['ranges']
        moved = int(((final['act_min'] != 0) | (final['act_max'] != 6)).sum())
        if freeze is not None:  # the frozen steps' activations sit well inside (0, 6)
            check(moved == len(final['act_min']), '%s: %d of %d ranges moved off (0, 6)', label,
                  moved, len(final['act_min']))
        lo = [float(batches[-1][:, 0].min()), float(batches[-1][:, 0].max())]
        hi = [float(batches[-1][:, 1].min()), float(batches[-1][:, 1].max())]
        # BN running statistics: moved in every step before the freeze, not after
        changed = [any(not torch.equal(a, b) for a, b in zip(s['before']['stats'],
                                                            s['after']['stats']))
                   for s in recorder.steps]
        frozen_from = freeze if freeze is not None else nb_steps
        check(changed == [True] * frozen_from + [False] * (nb_steps - frozen_from),
              '%s: BN statistics changed in steps %s', label, changed)
        regimes = [('before the delay (no fake-quant)', range(0, delay)),
                   ('quantized, BN training', range(delay, frozen_from)),
                   ('quantized, BN frozen', range(frozen_from, nb_steps))]
        times = {name: [round(recorder.ms(i), 2) for i in idx] for name, idx in regimes if idx}
        ev = counter.evals[-1]
        log('  %s: %d steps, %d eval forwards, loss %.4f, eval %s | launches %s | peak memory '
            '%.2f GiB | %.1f s (the run, its evals and its checkpoint)', label, counter.steps,
            nb_eval, float(counter.metrics['loss']), {k: round(v, 4) for k, v in ev.items()},
            counts, peak, elapsed)
        log('  %s: K2\' launches a step %s; the ranges follow the EMA of the batch (min, max) in '
            'every step (worst %.3g); after the run %d of %d sites off (0, 6), the last batch\'s '
            'min in [%.4g, %.4g] and max in [%.4g, %.4g]; BN statistics changed in steps %s',
            label, per_step, worst, moved, len(final['act_min']), *lo, *hi,
            [i + 1 for i, c in enumerate(changed) if c])
        log('  %s: step ms (synchronized each step) %s; medians %s | %s', label, times,
            {name: median(v[1:] or v) for name, v in times.items()}, card)
    return runs


def phase_mobilenet_nuq(FLAGS, work_dir, card):
    """Run M: the non-uniform learner on MobileNet-v1 through main.main: 27
    K1' launches with the select a forward (8-bit activations), codebooks
    that moved, every quantized kernel at most 16 distinct values; the
    codebook init (kmeans) and a step timed.  Returns {label: counters}."""
    from pocketflow_tpu_torch.learners.nonuniform_quantization import learner as nuq_learner
    label, version, argv, nb_steps = MB_RUNS[2]
    first = {}
    recorder = StepRecorder()

    def on_step(when, state):
        if when == 'before' and not first:
            first.update({p: c.detach().clone() for p, c in state.extra['codebooks'].items()})
        if when == 'after':
            first.setdefault('state', state)
        recorder(when, state)

    init_ms, build = [], nuq_learner.NonUniformQuantLearner._build_extra

    def timed_build(learner, *args):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = build(learner, *args)
        torch.cuda.synchronize()
        init_ms.append(1e3 * (time.perf_counter() - start))
        return out

    nuq_learner.NonUniformQuantLearner._build_extra = timed_build
    try:
        learner, counter, counts, elapsed, peak = run_mobilenet(
            FLAGS, work_dir, label, version, argv, nb_steps, on_step)
    finally:
        nuq_learner.NonUniformQuantLearner._build_extra = build
    sites = MB_SITES[version][1]
    check(counts == no_launches(fake_quant_per_tensor=sites * counter.forwards,
                                fake_quant_per_tensor_select=sites * counter.forwards),
          '%s: launches %s over %d quantized forwards', label, counts, counter.forwards)
    per_step = [recorder.launches(i, 'fake_quant_per_tensor_select') for i in range(nb_steps)]
    check(per_step == [sites] * nb_steps, '%s: K1\' launches a step %s', label, per_step)
    state = first.pop('state')
    books = state.extra['codebooks']
    check(len(books) == MB_NUQ_WEIGHTS and all(c.shape[0] == 16 for c in books.values()),
          '%s: codebooks %s', label, {p: tuple(c.shape) for p, c in books.items()})
    moved = sum(not torch.equal(books[p].detach(), c) for p, c in first.items())
    check(moved == len(books), '%s: %d of %d codebooks moved', label, moved, len(books))
    policy = learner._policy_fn()(state)
    weights = {m.path: m.kernel for m in state.model.modules() if hasattr(m, 'kernel')}
    distinct = []
    with torch.no_grad():
        for path in books:
            q = policy.process_weight(path, weights[path])
            distinct.append(int(torch.unique(q).numel()))
    check(max(distinct) <= 16, '%s: distinct values a kernel %s', label, distinct)
    ev = counter.evals[-1]
    log('  %s: %d steps, %d quantized forwards, loss %.4f, eval %s | launches %s | peak memory '
        '%.2f GiB | %.1f s', label, counter.steps, counter.forwards,
        float(counter.metrics['loss']), {k: round(v, 4) for k, v in ev.items()}, counts, peak,
        elapsed)
    log('  %s: %d of %d codebooks moved; distinct values a quantized kernel %d-%d; codebook '
        'builds (kmeans, %d weights) %s ms; step ms (synchronized each step) %s, median %.2f | %s',
        label, moved, len(books), min(distinct), max(distinct), len(books),
        [round(t, 1) for t in init_ms], [round(recorder.ms(i), 2) for i in range(nb_steps)],
        median([recorder.ms(i) for i in range(1, nb_steps)]), card)
    return {label: counts}


def phase_nuq_search(FLAGS, work_dir, card):
    """Run N: the non-uniform learner's RL bit search through main.main on
    ResNet-20 from run A's baseline: each roll-out's codebooks rebuilt at its
    mixed bits (2^bits entries a layer), the chosen bits under the budget,
    no kernel and no plain fake-quant (weights take their codebooks, the
    activations stay at full precision).  Returns {label: counters}."""
    import numpy as np
    from pocketflow_tpu_torch.learners.nonuniform_quantization import learner as nuq_learner
    cls = nuq_learner.NonUniformQuantLearner
    seen, set_bits = [], cls.set_bits

    def recording(learner, state, w_bits, a_bits):
        state = set_bits(learner, state, w_bits, a_bits)
        seen.append((list(w_bits), [c.shape[0] for c in state.extra['codebooks'].values()]))
        return state

    cls.set_bits = recording
    torch.cuda.reset_peak_memory_stats()
    try:
        learner, counter, counts, elapsed = run_main(FLAGS, work_dir, 'resnet_at_cifar10',
                                                     NUQ_SEARCH_ARGV)
    finally:
        cls.set_bits = set_bits
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    label = NUQ_SEARCH_RUN
    check(counts == no_launches(), '%s: launches %s', label, counts)
    check(all(sizes == [2 ** b for b in bits] for bits, sizes in seen),
          '%s: codebooks not at their bits: %s', label, seen)
    mixed = [bits for bits, _ in seen if len(set(bits)) >= 2]
    check(len(mixed) >= 2, '%s: %d mixed bit lists among %d', label, len(mixed), len(seen))
    bits = learner.optimal_w_bit_list
    num_weights = learner.statistics['num_weights']
    used = float(np.dot(bits, num_weights))
    check(used <= 4 * sum(num_weights) and all(2 <= b <= 8 for b in bits),
          '%s: bits %s over the budget', label, bits)
    check(counter.forwards > counter.steps > 0, '%s: %d forwards, %d steps', label,
          counter.forwards, counter.steps)
    ev = counter.evals[-1]
    check(all(math.isfinite(v) for v in ev.values()), '%s: eval %s', label, ev)
    log('  %s: %d set_bits calls (%d at mixed bits), codebooks at 2^bits entries each; chosen '
        'bits %s (%.3f bits a weight, budget 4) | %d steps, %d quantized forwards | eval %s | '
        'launches %s | peak memory %.2f GiB | %.1f s | %s', label, len(seen), len(mixed), bits,
        used / sum(num_weights), counter.steps, counter.forwards,
        {k: round(v, 4) for k, v in ev.items()}, counts, peak, elapsed, card)
    return {label: counts}


def mobilenet_act_shapes(FLAGS, version=1):
    """The relu6 sites' activation shapes of MobileNet at full width and
    MB_BATCH (one eval forward on the card, bf16)."""
    from pocketflow_tpu_torch.nets.mobilenet_at_ilsvrc12 import ModelHelper
    from pocketflow_tpu_torch.nn.layers import CompressionPolicy, compression
    shapes = []

    class Shapes(CompressionPolicy):
        def process_act(self, path, act):
            if path.startswith('act/'):
                shapes.append(tuple(act.shape))
            return act

    with FLAGS.scope(compute_dtype='bfloat16', mobilenet_depth_mult=1.0):
        model = ModelHelper(version=version).create_model().to('cuda').eval()
        with torch.no_grad(), compression(Shapes()):
            model(torch.zeros((MB_BATCH, 224, 224, 3), device='cuda'))
    del model
    return shapes


def phase_mobilenet_kernels(FLAGS, fq, device, card):
    """Phase 18, the kernels at MobileNet's shapes: K2' (channel buckets,
    without the select, uniform-tf's route) at the 28 weight shapes of v1 at
    8 bits, equal to the plain version tensor by tensor, and timed beside it;
    K1' with the select on the two largest activations (bf16, 8 bits) against
    the plain version and its select."""
    from pocketflow_tpu_torch.learners.uniform_quantization_tf.learner import (
        UniformQuantTFLearner)
    from pocketflow_tpu_torch.nets.mobilenet_at_ilsvrc12 import ModelHelper
    with FLAGS.scope(compute_dtype='float32', mobilenet_version=1, mobilenet_depth_mult=1.0,
                     batch_size=MB_BATCH):
        shapes = UniformQuantTFLearner(None, ModelHelper(), device=device).statistics[
            'weight_shapes']
    check(len(shapes) == MB_SITES[1][0], '%d weight shapes', len(shapes))
    gen = torch.Generator(device=device).manual_seed(5)
    weights = [torch.randn(s, generator=gen, device=device) * 0.05 for s in shapes]
    bits = torch.full((len(weights),), 8.0, device=device)
    k8 = fq._levels(bits[0])
    got = fq.fake_quant_per_column_group(weights, bits, None, select=False)
    for i, (w, g) in enumerate(zip(weights, got)):
        check(torch.equal(g, fq._column_plain(w, k8, None)),
              'K2\' differs from plain at MobileNet weight %d %s', i, tuple(w.shape))
    ms = time_ms(lambda: fq.fake_quant_per_column_group(weights, bits, None, select=False))
    plain_ms = time_ms(lambda: [fq._column_plain(w, k8, None) for w in weights])
    bound_ms, bound_by = fq_bound(sum(w.numel() for w in weights))
    views = sorted({(math.prod(s[:-1]), s[-1]) for s in shapes})
    log('  K2\' (channel buckets, no select) at MobileNet-v1\'s %d weights, 8 bits, column views '
        '%s: equal to plain, tensor by tensor | kernel %.4f ms (%.0f%% of the bound), plain %.4f '
        'ms, bound %.4f ms (%s) | %s', len(weights), views, ms, 100 * bound_ms / ms, plain_ms,
        bound_ms, bound_by, card)
    bits8 = torch.tensor(8.0, device=device)
    for shape in MB_ACT_SHAPES:
        x = torch.relu(torch.randn(shape, generator=gen, device=device)).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        want = torch.where(bits8 < 32, fq._quantize_math_torch(x, k8, None).to(x.dtype), x)
        got = fq.fake_quant_per_tensor(x, bits8, select=True)
        check(got.stride() == x.stride(), 'K1\' lost the layout of %s', shape)
        err, nd = compare(got, want, float((x.max().float() - x.min().float()) / k8))
        del want, got
        ms = time_ms(lambda: fq.fake_quant_per_tensor(x, bits8, select=True))
        plain_ms = time_ms(lambda: torch.where(
            bits8 < 32, fq._quantize_math_torch(x, k8, None).to(x.dtype), x), 5)
        bound_ms, bound_by = fq_bound(x.numel(), 2)
        log('  K1\' with the select, bf16 act %s, 8 bits: max|d|=%.3g n_diff=%d vs plain + select '
            '| kernel %.4f ms (%.0f%% of the bound), plain + select %.4f ms, bound %.4f ms (%s)',
            shape, err, nd, ms, 100 * bound_ms / ms, plain_ms, bound_ms, bound_by)
        del x
    torch.cuda.empty_cache()


def phase_mobilenet_reference(FLAGS):
    """Phase 18, the steps: a small MobileNet-v1 step of each new learner on
    the card (kernels, fp32, no TF32) against the same step on the CPU (plain
    versions) from the same seed, batch 8: uniform-tf with quantization on
    (8-bit weights through K2'), and non-uniform (4-bit kmeans codebooks,
    both trained).  The activations stay at 32 bits: below that a level a
    rounding away from its edge flips between the two devices' sum orders
    (~1e-6 apart) and the flips cascade through the layers and the small
    batch's BN (16 bits moved the logits by 0.4%); the quantizers themselves
    are held to the CPU bit for bit elsewhere in this phase.  Each device
    builds its own kmeans codebooks (within 1e-3 of the CPU's largest entry:
    an assignment flipped by a sum order in one of the 25 Lloyd steps moves
    its cluster's mean); the card's step then starts from the CPU's, since
    one assignment flipped by a sum order moves a weight by a whole level.
    Bounds, as phases 3 and 10: the logits of a train-mode forward (before
    the step) within 1e-3 (+1e-3 of the largest) and the train loss within
    1e-3 relative; and the BN statistics and activation ranges after the
    step within 1e-3 of their norm per tensor.  The step's update of the
    parameters and codebooks (at a rate of 0.1) is reported beside the
    CPU's own spread (two reruns: the batch reversed, its images perturbed
    by 1e-7), not bounded: fp32 gradients of this net carry the convolution
    libraries' error (mobilenet_grad_precision), which moves the update by
    percents between the two devices."""
    from pocketflow_tpu_torch.learners.nonuniform_quantization.learner import (
        NonUniformQuantLearner)
    from pocketflow_tpu_torch.learners.uniform_quantization_tf.learner import (
        UniformQuantTFLearner)
    from pocketflow_tpu_torch.nets.mobilenet_at_ilsvrc12 import ModelHelper
    # MobileNet's quant finetune rate is 1e-4 * lrn_rate_init * batch / 128: 0.1
    small = dict(batch_size=8, batch_size_eval=8, nb_smpls_train=64, nb_smpls_eval=8,
                 compute_dtype='float32', ilsvrc_image_size=64, mobilenet_version=1,
                 mobilenet_depth_mult=0.5, lrn_rate_init=16000.0)
    noise = torch.randn((8, 64, 64, 3), generator=torch.Generator().manual_seed(7)).numpy()
    runs = (('cpu', 'cpu'), ('reversed', 'cpu'), ('perturbed', 'cpu'), ('cuda', 'cuda'))
    for name, cls, flags in (
            ('uniform-tf', UniformQuantTFLearner, dict(uqtf_quant_delay=0,
                                                       uqtf_activation_bits=32)),
            ('non-uniform', NonUniformQuantLearner, dict(
                nuql_weight_bits=4, nuql_init_style='kmeans', nuql_activation_bits=32,
                nuql_opt_mode='both'))):
        out, books_err = {}, 0.0
        with FLAGS.scope(**small, **flags):
            for run, device in runs:
                learner = cls(None, ModelHelper(), device=device)
                ds = learner.dataset_train
                ds.augment_xy = lambda batch, gen, is_train, ds=ds: type(ds).augment_xy(
                    ds, batch, gen, False)
                state, tx, _ = learner.init_state_quant()
                if name == 'uniform-tf':
                    step = learner.build_qat_train_step(tx, freeze_bn=False)
                    policy = learner._policy_fn()(state, enabled=True, record=False)
                else:
                    step = learner.build_quant_train_step(tx)
                    policy = learner._policy_fn()(state)
                    books = state.extra['codebooks']
                    if run == 'cpu':
                        cpu_books = {p: c.detach().clone() for p, c in books.items()}
                    with torch.no_grad():
                        for path, c in books.items():
                            want = cpu_books[path]
                            if device == 'cuda':
                                books_err = max(books_err, float(
                                    (c.cpu() - want).abs().max() / want.abs().max()))
                            c.copy_(want)
                images, labels = ds.synthesize_arrays(8)  # 64, the least it makes
                images, labels = images[:8].astype('float32'), labels[:8]
                if run == 'reversed':
                    images, labels = images[::-1].copy(), labels[::-1].copy()
                elif run == 'perturbed':
                    images = images * (1 + 1e-7 * noise).astype('float32')
                batch = learner.put_batch({'image': images, 'label': labels})
                # a train-mode forward (eval BN's init statistics let a random
                # net's activations fade to 0), its running statistics put back
                saved = [b.clone() for b in state.model.buffers()]
                with torch.no_grad():
                    logits = learner.model_helper.forward_train(
                        state.model, ds.augment(batch['image'], None, False), policy=policy)
                    for b, value in zip(state.model.buffers(), saved):
                        b.copy_(value)
                trained = [p for p in state.model.parameters()] + list(
                    state.extra.get('codebooks', {}).values())
                before = [p.detach().cpu().clone() for p in trained]
                _, metrics = step(state, batch, None)
                update = torch.cat([(p.detach().cpu() - b).reshape(-1)
                                    for p, b in zip(trained, before)]).double()
                stats = {k: v.cpu() for k, v in state.model.named_buffers()}
                stats.update({k: v.cpu() for k, v in state.extra.items()
                              if k in ('act_min', 'act_max')})
                out[run] = (logits.cpu(), float(metrics['loss']), update, stats)
        want = out['cpu'][2]
        distance = {run: float((out[run][2] - want).norm() / want.norm())
                    for run in ('reversed', 'perturbed', 'cuda')}
        update_err, spread = distance['cuda'], max(distance['reversed'], distance['perturbed'])
        logit_err = float((out['cuda'][0] - out['cpu'][0]).abs().max())
        scale = float(out['cpu'][0].abs().max())
        rel = {k: float((out['cuda'][3][k] - v).norm() / v.norm().clamp_min(1e-12))
               for k, v in out['cpu'][3].items()}
        worst = max(rel, key=rel.get)
        log('  MobileNet-v1 @ 64, depth 0.5, batch 8, %s: logits card vs CPU max|d| = %.3g (of '
            '%.3g); train loss card %.6f, CPU %.6f; the update %.3g of its norm from the CPU\'s '
            '(the CPU\'s reruns %.3g); BN statistics and ranges after the step, worst relative '
            'L2 %.3g (%s)%s', name, logit_err, scale, out['cuda'][1], out['cpu'][1], update_err,
            spread, rel[worst], worst,
            '; kmeans codebooks card vs CPU %.3g of the largest' % books_err
            if name == 'non-uniform' else '')
        check(logit_err <= 1e-3 + 1e-3 * scale, '%s: logits disagree', name)
        check(abs(out['cuda'][1] - out['cpu'][1]) <= 1e-3 * abs(out['cpu'][1]),
              '%s: train loss disagrees', name)
        check(rel[worst] <= 1e-3, '%s: state after the step disagrees at %s', name, worst)
        check(books_err <= 1e-3, '%s: kmeans codebooks card vs CPU %.3g', name, books_err)


def mobilenet_grad_precision():
    """The gradients of a small MobileNet-v1 train step (depth 0.5, 64x64,
    batch 8, random weights from seed 1) in fp32 on the card, with cuDNN and
    with PyTorch's own convolutions, and in fp32 on the CPU, each against the
    card's float64 gradients: relative L2 over all parameters at once, and
    the worst tensor.  PyTorch's own CUDA convolutions must come within 1e-4
    of float64; the libraries' (cuDNN, the CPU's) are reported."""
    from pocketflow_tpu_torch.nets.mobilenet import MobileNetV1
    gen = torch.Generator().manual_seed(0)
    base = MobileNetV1(1001, 0.5, dtype=torch.float32)
    base.reset_parameters(torch.Generator().manual_seed(1))
    x = torch.randn((8, 64, 64, 3), generator=gen)
    y = torch.randint(0, 1001, (8,), generator=gen)

    def grads(device, dtype):
        model = copy.deepcopy(base).to(device, dtype).train()
        for module in model.modules():
            if hasattr(module, 'dtype'):
                module.dtype = dtype
        loss = torch.nn.functional.cross_entropy(model(x.to(device, dtype)).to(dtype),
                                                 y.to(device))
        loss.backward()
        return {n: p.grad.double().cpu() for n, p in model.named_parameters()}

    ref = grads('cuda', torch.float64)
    flat_ref = torch.cat([g.reshape(-1) for g in ref.values()])
    errors = {}
    for label, device, cudnn in (('cuDNN', 'cuda', True), ('PyTorch\'s CUDA convs', 'cuda', False),
                                 ('CPU', 'cpu', True)):
        with torch.backends.cudnn.flags(enabled=cudnn, benchmark=False, deterministic=False,
                                        allow_tf32=False):
            got = grads(device, torch.float32)
        rel = {n: float((got[n] - g).norm() / g.norm()) for n, g in ref.items()}
        worst = max(rel, key=rel.get)
        errors[label] = float((torch.cat([got[n].reshape(-1) for n in ref]) - flat_ref).norm()
                              / flat_ref.norm())
        log('  fp32 gradients of MobileNet-v1 @ 64 (depth 0.5, batch 8), %s: %.3g of the card\'s '
            'float64 gradients over all parameters, worst tensor %.3g (%s)', label,
            errors[label], rel[worst], worst)
    check(errors['PyTorch\'s CUDA convs'] <= 1e-4, 'fp32 gradients of PyTorch\'s CUDA convs '
          '%.3g from float64', errors['PyTorch\'s CUDA convs'])


def phase_plain_ops(FLAGS, card):
    """Phase 18, the two plain ops (the reference has no kernel for either):
    fake_quant_with_range on the card against the CPU (values and gradient
    mask equal, four ranges) and timed over MobileNet-v1's 27 relu6 sites
    at batch 256, forward and backward; nonuniform_quant on the card against
    the CPU (values and the x gradient equal; each codebook entry's gradient
    within 1e-6 of the sum of its terms' magnitudes: its sums are atomic on
    the card, sequential on the CPU), and timed with the codebook init over
    the 26 weights of run M.  The gradients are returned, not accumulated."""
    from pocketflow_tpu_torch.learners.nonuniform_quantization import utils as nuq_utils
    from pocketflow_tpu_torch.nets.mobilenet_at_ilsvrc12 import ModelHelper
    from pocketflow_tpu_torch.ops import fake_quant as fq
    from pocketflow_tpu_torch.ops import nonuniform_quant as nuq
    gen = torch.Generator().manual_seed(6)
    bits8 = torch.tensor(8.0)
    x = (torch.randn((16, 32, 56, 56), generator=gen) * 2.5 + 1.0).to(torch.bfloat16)
    for lo, hi in ((0.0, 6.0), (0.02, 6.1), (-1.3, 2.2), (0.5, 4.0)):
        res = {}
        for device in ('cpu', 'cuda'):
            xd = x.to(device).clone().requires_grad_(True)
            y = fq.fake_quant_with_range(xd, torch.tensor(lo, device=device),
                                         torch.tensor(hi, device=device), bits8.to(device))
            y.backward(torch.ones_like(y))
            res[device] = (y.detach().cpu(), xd.grad.cpu())
        check(torch.equal(res['cpu'][0], res['cuda'][0]) and torch.equal(res['cpu'][1],
                                                                          res['cuda'][1]),
              'fake_quant_with_range differs card vs CPU at [%g, %g]', lo, hi)
    shapes = mobilenet_act_shapes(FLAGS)
    check(len(shapes) == MB_SITES[1][1], '%d act sites', len(shapes))
    acts = [torch.relu(torch.randn(s, device='cuda')).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last).requires_grad_(True) for s in shapes]
    lo, hi, b8 = (torch.tensor(v, device='cuda') for v in (0.0, 6.0, 8.0))
    fwd_ms = time_ms(lambda: [fq.fake_quant_with_range(a, lo, hi, b8) for a in acts], 5)
    grads = [torch.ones_like(a) for a in acts]

    def fwd_bwd():
        return torch.autograd.grad([fq.fake_quant_with_range(a, lo, hi, b8) for a in acts],
                                   acts, grads)
    both_ms = time_ms(fwd_bwd, 5)
    largest = max(acts, key=lambda a: a.numel())
    site_ms = time_ms(lambda: fq.fake_quant_with_range(largest, lo, hi, b8), 5)
    nbytes = sum(a.numel() for a in acts) * 2
    log('  fake_quant_with_range (plain by design): card equal to the CPU at 4 ranges (values, '
        'gradient mask) | over the 27 relu6 sites of MobileNet-v1 at batch %d (%.2f GB of bf16 '
        'activations): forward %.3f ms, forward + backward %.3f ms a step; the largest site %s '
        'forward %.3f ms (bound %.4f ms, bytes: read and written once) | %s', MB_BATCH,
        nbytes / 1e9, fwd_ms, both_ms, tuple(largest.shape), site_ms,
        bound(4 * largest.numel(), {})[0], card)
    del acts, grads
    torch.cuda.empty_cache()

    w = torch.randn((1, 1, 512, 1024), generator=gen) * 0.05
    g = torch.randn(w.shape, generator=gen)
    for bucket_type, c_cols in ((None, 1), ('channel', 1024), ('split', -(-w.numel() // 256))):
        c0 = torch.sort(torch.rand((16, c_cols), generator=gen), dim=0).values
        res = {}
        for device, grad in (('cpu', g.abs()), ('cpu', g), ('cuda', g)):
            wd = w.to(device).clone().requires_grad_(True)
            c = c0.to(device).clone().requires_grad_(True)
            y = nuq.nonuniform_quant(wd, c, bucket_type, 256)
            y.backward(grad.to(device))
            res['abs' if grad is not g else device] = (y.detach().cpu(), wd.grad.cpu(),
                                                       c.grad.cpu())
        dc_err = float(((res['cuda'][2] - res['cpu'][2]).abs()
                        / res['abs'][2].clamp_min(1e-30)).max())
        dc_rel = float((res['cuda'][2] - res['cpu'][2]).norm() / res['cpu'][2].norm())
        check(torch.equal(res['cpu'][0], res['cuda'][0]) and torch.equal(res['cpu'][1],
                                                                          res['cuda'][1])
              and dc_err <= 1e-6, 'nonuniform_quant differs card vs CPU (%s buckets): dc %.3g',
              bucket_type, dc_err)
        log('  nonuniform_quant (plain by design), %s buckets, (1, 1, 512, 1024) at 16 entries: '
            'card equal to the CPU (values, x gradient); codebook gradient within %.3g of each '
            'entry\'s sum of |terms| (%.3g relative L2)', bucket_type, dc_err, dc_rel)
    with FLAGS.scope(compute_dtype='bfloat16', mobilenet_version=1, mobilenet_depth_mult=1.0,
                     nuql_use_buckets=False, nuql_init_style='kmeans'):
        model = ModelHelper().create_model()
        model.reset_parameters(torch.Generator().manual_seed(0))
        model = model.to('cuda')
        modules = [m for m in model.modules() if hasattr(m, 'kernel')][1:-1]
        paths = [m.path for m in modules]
        torch.cuda.synchronize()
        start = time.perf_counter()
        books = nuq_utils.init_codebooks(model, paths, [4] * len(paths))
        torch.cuda.synchronize()
        init_ms = 1e3 * (time.perf_counter() - start)
    kernels = [m.kernel for m in modules]
    grads = [torch.ones_like(k) for k in kernels]
    leaves = kernels + [books[p] for p in paths]

    def nuq_step():
        return torch.autograd.grad([nuq.nonuniform_quant(k, books[p], None, 256)
                                    for k, p in zip(kernels, paths)], leaves, grads)
    fwd_ms = time_ms(lambda: [nuq.nonuniform_quant(k, books[p], None, 256)
                              for k, p in zip(kernels, paths)], 5)
    both_ms = time_ms(nuq_step, 5)
    log('  MobileNet-v1\'s %d quantized weights (%.2f M), 4 bits, no buckets: codebook init '
        '(kmeans: 25 Lloyd steps each) %.1f ms; nonuniform_quant forward %.3f ms, forward + '
        'backward %.3f ms a step | %s', len(paths), sum(k.numel() for k in kernels) / 1e6,
        init_ms, fwd_ms, both_ms, card)
    del model, books, grads


def cp_checkpoint_masks(path):
    """{kernel name: [c_in] mask} of the newest checkpoint under `path`, after
    checking that every masked input channel of its kernel is exactly 0."""
    from pocketflow_tpu_torch.core import checkpoint as ckpt_lib
    payload = ckpt_lib.restore_latest(path, map_location='cpu')
    masks, model = payload['extra']['masks'], payload['model']
    out = {}
    for name, mask in masks.items():
        if mask.dim():
            chn = mask.reshape(-1)
            check(not torch.any(model[name][:, :, chn == 0, :]),
                  'masked input channels of %s not zero in %s', name, path)
            out[name] = chn
    return out


def phase_cp_path(FLAGS, work_dir, card):
    """Phase 19: runs O-R through main.main on ResNet-20 @ CIFAR-10 at batch
    128 from run A's baseline, each to its channel counts with every masked
    input channel exactly 0 after its finetune, a finite loss and eval, and
    no kernel launched; each run timed (its prune phase: from main.main's
    call to the first finetune step), its peak memory.  Returns {run label:
    counters}."""
    from pocketflow_tpu_torch.learners.discr_channel_pruning import learner as dcp
    inits, reset = [], dcp.AuxHead.reset_parameters

    def recording(head, generator=None):  # each auxiliary head's initial values
        reset(head, generator)
        inits.append((head, [p.detach().clone() for p in head.parameters()]))

    runs = {}
    for label, name, save_flag, argv in CP_RUNS:
        save = os.path.join(work_dir, 'resnet_at_cifar10', label.split(':')[0].split()[-1],
                            'model.ckpt')
        first_step = []
        dcp.AuxHead.reset_parameters = recording
        torch.cuda.reset_peak_memory_stats()
        try:
            start = time.perf_counter()
            learner, counter, runs[label], elapsed = run_main(
                FLAGS, work_dir, 'resnet_at_cifar10',
                ['--learner=%s' % name, '--%s=%s' % (save_flag, save),
                 '--cp_best_path=%s' % save] + argv,
                on_step=lambda when, state: first_step.append(time.perf_counter())
                if when == 'before' and not first_step else None)
        finally:
            dcp.AuxHead.reset_parameters = reset
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        loss = float(counter.metrics['loss'])
        ev = counter.evals[-1]
        check(math.isfinite(loss) and all(math.isfinite(v) for v in ev.values()),
              '%s: loss %r, eval %s', label, loss, ev)
        check(runs[label] == no_launches() and counter.steps > 0, '%s: launches %s, %d steps',
              label, runs[label], counter.steps)
        masks = cp_checkpoint_masks(save)
        kept = {n: (int(m.sum()), m.numel()) for n, m in masks.items()}
        if name == 'channel':
            paths = [s['path'].replace('/', '.') + '.kernel' for s in learner.specs]
            check(sorted(kept) == sorted(paths) and len(paths) == 20, '%s: masks %s', label,
                  sorted(kept))
            # the LASSO's band is +-1% of c_in, widened by a channel whenever the
            # alpha bracket collapses
            off = {n: k - math.ceil(0.5 * c) for n, (k, c) in kept.items()}
            check(all(abs(d) <= 2 for d in off.values()), '%s: kept %s', label, kept)
            timings = {k: round(v, 3) for k, v in learner.pruner.timings.items()}
        elif name == 'chn-pruned-rmt':
            check(len(kept) == 20 and all(k == round(0.5 * c) for k, c in kept.values()),
                  '%s: kept %s', label, kept)
            timings = {k: round(v, 3) for k, v in learner.pruner.timings.items()}
        elif name == 'chn-pruned-gpu':
            names = learner.prunable_paths(dict(learner.init_state()[0].model.named_parameters()))
            check(sorted(kept) == sorted(names) and len(names) == 21, '%s: masks %s', label,
                  sorted(kept))
            ends = (names[0], names[-1])
            check(all(kept[n][0] == kept[n][1] for n in ends), '%s: head/tail pruned %s', label,
                  {n: kept[n] for n in ends})
            check(all(1 - k / c >= 0.4 for n, (k, c) in kept.items() if n not in ends),
                  '%s: kept %s', label, kept)
            timings = {}
        else:
            pruned = {n: kc for n, kc in kept.items() if n != 'conv_init.kernel'}
            check(len(pruned) == 20 and all(c - k == c // 2 for k, c in pruned.values())
                  and kept['conv_init.kernel'][0] == 3, '%s: kept %s', label, kept)
            heads = [(h, i) for h, i in inits if any(h is x for x in learner.aux_heads.values())]
            check(len(heads) == len(learner.aux_heads) == 3 and all(
                any(not torch.equal(p.detach().cpu(), v.cpu()) for p, v in zip(h.parameters(), i))
                for h, i in heads), '%s: auxiliary heads untrained', label)
            timings = {}
        prune_s = (first_step[0] - start) if first_step else float('nan')
        log('  %s: kept/c_in %s | %d finetune steps, loss %.4f, eval %s | launches %s | %.1f s, '
            'of which the set-up and prune phase %.2f s %s, peak memory %.3f GiB | %s', label,
            {n[:-len('.kernel')]: '%d/%d' % kc for n, kc in kept.items()}, counter.steps, loss,
            {k: round(v, 4) for k, v in ev.items()}, runs[label], elapsed, prune_s, timings,
            peak, card)
    return runs


def phase_mobilenet_amc(FLAGS, work_dir, card):
    """Phase 20, run S: MobileNet-v1 at 224, depth 1.0, bf16, batch 256,
    random weights from seed 0, through main.main: the AMC search over the 13
    pointwise convs (2 roll-outs, rewards from the train split's held-out
    part) under a 0.5 FLOPs budget, its top-k in ddpg_search.npz, then the
    prune at the best ratios and 5 finetune steps with every masked input
    channel exactly 0 and no kernel launched.  Each roll-out timed by part
    (sampling, LASSO, ridge, fast eval), the finetune steps, the peak memory.
    Returns {run label: counters}."""
    import numpy as np
    run_dir = os.path.join(work_dir, 'mobilenet', 'S')
    save = os.path.join(run_dir, 'cp', 'model.ckpt')
    argv = ['--learner=channel', '--cp_prune_option=auto', '--cp_preserve_ratio=0.5',
            '--cp_nb_rlouts=2', '--cp_nb_rlouts_min=1', '--cp_nb_batches=2',
            '--cp_channel_pruned_path=%s' % save, '--cp_best_path=%s' % save,
            '--save_path=%s' % os.path.join(run_dir, 'models', 'model.ckpt'),
            '--model=mobilenet_at_ilsvrc12', '--mobilenet_version=1',
            '--mobilenet_depth_mult=1.0', '--data_dir_local=', '--batch_size=%d' % MB_BATCH,
            '--batch_size_eval=%d' % MB_BATCH, '--nb_smpls_train=%d' % AMC_TRAIN,
            '--nb_smpls_eval=%d' % MB_EVAL, '--nb_epochs_rat=0.05']
    recorder = StepRecorder()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    learner, counter, counts, elapsed = run_main(FLAGS, work_dir, 'mobilenet_at_ilsvrc12', argv,
                                                 recorder)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    label = AMC_RUN
    loss = float(counter.metrics['loss'])
    ev = counter.evals[-1]
    check(math.isfinite(loss) and all(math.isfinite(v) for v in ev.values()),
          '%s: loss %r, eval %s', label, loss, ev)
    check(counts == no_launches() and counter.steps == AMC_STEPS, '%s: launches %s, %d steps',
          label, counts, counter.steps)
    specs = learner.specs
    check(len(specs) == 13 and all(s['path'].endswith('/pw') and s['kernel_shape'][:2] == (1, 1)
                                   for s in specs), '%s: specs %s', label,
          [s['path'] for s in specs])
    search = np.load(os.path.join(run_dir, 'cp', 'ddpg_search.npz'))
    ratios = np.asarray(search['x_ratios_best'], np.float64)
    flops = np.asarray([s['flops'] for s in specs])
    preserved = float(np.sum(flops * ratios) / np.sum(flops))
    topk = search['x_ratios_topk']
    check(int(search['x_idx_rlout']) == 1 and 1 <= topk.shape[0] <= 2 and topk.shape[1] == 13
          and search['x_rewards_topk'].shape[0] == topk.shape[0],
          '%s: search checkpoint %s', label, {k: search[k].shape for k in search.files})
    check(preserved <= 0.5 + 1e-6, '%s: preserved FLOPs %.4f over the budget', label, preserved)
    masks = cp_checkpoint_masks(save)
    kept = np.asarray([float(masks[s['path'].replace('/', '.') + '.kernel'].sum())
                       / s['kernel_shape'][2] for s in specs])
    times = learner.rollout_times
    check(len(times) == 2, '%s: %d roll-outs timed', label, len(times))
    log('  %s: best ratios %s, preserved FLOPs %.4f of the 13 pointwise convs (budget 0.5; the '
        'kept channels %.4f), top-k rewards %s | %d finetune steps %s ms, loss %.4f, eval %s | '
        'launches %s | %.1f s, peak memory %.2f GiB | %s', label,
        [round(float(r), 3) for r in ratios], preserved, float(np.sum(flops * kept) / np.sum(flops)),
        [round(float(r), 4) for r in search['x_rewards_topk']], counter.steps,
        [round(recorder.ms(i), 2) for i in range(len(recorder.steps))], loss,
        {k: round(v, 4) for k, v in ev.items()}, counts, elapsed, peak, card)
    for i, t in enumerate(times):
        log('  %s roll-out %d: %.3f s = sampling %.3f + LASSO %.3f + ridge %.3f + fast eval %.3f '
            '(+ %.3f s of copies and bookkeeping) | %s', label, i, t['total'], t['sample'],
            t['lasso'], t['ridge'], t['feval'],
            t['total'] - t['sample'] - t['lasso'] - t['ridge'] - t['feval'], card)
    return {label: counts}


def _cp_layer_data(shape, nb_rows, device, seed=0):
    """(kernel HWIO, X [n, c_in, h, w], Y [n, c_out]) of one conv: ReLU
    inputs, channel weights spread over two decades (a clear LASSO order),
    Y = the conv's output plus 1% noise."""
    h, w, c_in, c_out = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    scale = torch.logspace(-2, 0, c_in, device=device)[torch.randperm(c_in, generator=gen,
                                                                       device=device)]
    kernel = torch.randn(shape, generator=gen, device=device) * scale[None, None, :, None]
    X = torch.relu(torch.randn((nb_rows, c_in, h, w), generator=gen, device=device))
    Y = torch.einsum('pchw,hwco->po', X, kernel)
    Y = Y + 0.01 * Y.std() * torch.randn(Y.shape, generator=gen, device=device)
    return kernel, X, Y


def phase_cp_solvers(FLAGS, card):
    """Phase 21, the solvers: select_channels + prune_layer at 0.5 from the
    same X and Y on the card and on the CPU, at MobileNet's 1x1 1024->1024
    and ResNet-20's 3x3 64->64 layers: the same channel set, the
    reconstructed kernels within CP_KERNEL_TOL of the CPU's norm.  Then, on
    the card at the default 30 batches' rows: one LASSO solve (CUDA events)
    and the whole layer (host clock ended by a synchronize)."""
    from pocketflow_tpu_torch.learners.channel_pruning import channel_pruner as cp
    for label, shape, nb_rows, nb_rows_full in CP_LAYERS:
        spec = {'path': label, 'kernel_shape': shape}
        with FLAGS.scope(cp_lasso_nb_iters=300, rand_seed=0, cp_lasso=True):
            kernel, X, Y = _cp_layer_data(shape, nb_rows, 'cpu')
            out = {}
            for device in ('cpu', 'cuda'):
                pruner = cp.ChannelPruner(None, [spec])
                start = time.perf_counter()
                out[device] = pruner.prune_layer(spec, kernel.to(device), X.to(device),
                                                 Y.to(device), 0.5)
                out[device + '_s'] = time.perf_counter() - start
            (k_cpu, i_cpu), (k_gpu, i_gpu) = out['cpu'], out['cuda']
            err = float((k_gpu.cpu() - k_cpu).norm() / k_cpu.norm())
            check(torch.equal(i_gpu.cpu(), i_cpu), '%s: channels card vs CPU differ', label)
            check(err <= CP_KERNEL_TOL, '%s: kernel card vs CPU %.3g', label, err)

            kernel, X, Y = _cp_layer_data(shape, nb_rows_full, 'cuda')
            pruner = cp.ChannelPruner(None, [spec])
            pruner.prune_layer(spec, kernel, X, Y, 0.5)  # warm-up
            torch.cuda.synchronize()
            start = time.perf_counter()
            _, idxs = pruner.prune_layer(spec, kernel, X, Y, 0.5)
            torch.cuda.synchronize()
            layer_s = time.perf_counter() - start
            P, y = cp.lasso_inputs(X, Y, kernel)
            problem = cp.lasso_problem(P, y)
            solve_ms = time_ms(lambda: pruner.solver(problem, 1e-3))
            gram_ms = time_ms(lambda: cp.lasso_problem(P, y))
            del P, y, problem, X, Y
        log('  %s: %d rows, %d of %d channels kept, the same on both, kernel card vs CPU %.3g '
            'of its norm (bound %g); prune_layer CPU %.2f s, card %.3f s | at %d rows on the '
            'card: a LASSO solve (300 iterations) %.3f ms, the Gram form (P %d x %d) %.3f ms, '
            'the whole layer %.3f s (%d channels kept) | %s', label, nb_rows, int(i_cpu.sum()),
            shape[2], err, CP_KERNEL_TOL, out['cpu_s'], out['cuda_s'], nb_rows_full, solve_ms,
            min(400, nb_rows_full // 20) * shape[3], shape[2], gram_ms, layer_s,
            int(idxs.sum()), card)
        torch.cuda.empty_cache()


def phase_cp_steps(FLAGS):
    """Phase 21, the steps: a CPG PGD step (ResNet-20 @ CIFAR-10, fp32,
    batch 8) and a DCP grad-norm step (ConvNet @ FMNIST, conv2 half masked,
    one auxiliary head) on the card against the CPU from the same seed, as
    phase 18 holds the other learners' steps: the forward quantities (the
    PGD step's 21 regression losses of a copy 10% off the full model, the
    DCP selection loss) within 1e-3 relative; the update and the gradient norms reported beside the CPU's
    own spread (the batch reversed), not bounded (fp32 convolution
    gradients differ between the devices' libraries)."""
    from pocketflow_tpu_torch.learners.channel_pruning.learner import kernel_masks
    from pocketflow_tpu_torch.learners.channel_pruning_gpu import learner as cpg
    from pocketflow_tpu_torch.learners.discr_channel_pruning import learner as dcp
    from pocketflow_tpu_torch.nets import convnet_at_fmnist, resnet_at_cifar10
    small = dict(batch_size=8, batch_size_eval=8, nb_smpls_train=64, nb_smpls_eval=8,
                 compute_dtype='float32', rand_seed=0)
    runs = (('cpu', 'cpu'), ('reversed', 'cpu'), ('cuda', 'cuda'))
    pgd, norms = {}, {}
    with FLAGS.scope(**small):
        for run, device in runs:
            learner = cpg.ChannelPrunedGpuLearner(None, resnet_at_cifar10.ModelHelper(),
                                                  device=device)
            full = learner.init_state()[0].model
            pruned = copy.deepcopy(full)
            names = learner.prunable_paths(dict(full.named_parameters()))
            # the pruned copy starts 10% off the full model (host-drawn), so
            # that the regression losses before the step are not 0
            gen = torch.Generator().manual_seed(5)
            with torch.no_grad():
                for p in pruned.parameters():
                    p.mul_(1 + 0.1 * torch.randn(p.shape, generator=gen).to(device))
            images, labels = learner.dataset_train.synthesize_arrays(64)
            images, labels = images[:8].astype('float32'), labels[:8]
            if run == 'reversed':
                images, labels = images[::-1].copy(), labels[::-1].copy()
            batch = learner.put_batch({'image': images, 'label': labels})
            lrn = torch.full((len(names),), 0.05, device=device)
            pct = torch.linspace(10.0, 60.0, len(names), device=device)
            losses = cpg.pgd_step(learner, full, pruned, names, lrn, pct, batch)
            params, start = dict(pruned.named_parameters()), dict(full.named_parameters())
            update = torch.cat([(params[n] - start[n]).detach().reshape(-1) for n in names])
            pgd[run] = (losses.cpu().double(), update.cpu().double())

            learner = dcp.DisChnPrunedLearner(None, convnet_at_fmnist.ModelHelper(),
                                              device=device)
            full = learner.init_state()[0].model
            model = copy.deepcopy(full)
            chn = torch.ones(32)
            chn[16:] = 0.0
            masks = kernel_masks(model, {'conv2': chn})
            with torch.no_grad():
                dict(model.named_parameters())['conv2.kernel'].mul_(masks['conv2.kernel'])
            head = dcp.AuxHead(64, 10)
            head.reset_parameters(torch.Generator().manual_seed(3))
            heads = {'conv2': head.to(device)}
            images, labels = learner.dataset_train.synthesize_arrays(64)
            images, labels = images[:8].astype('float32'), labels[:8]
            if run == 'reversed':
                images, labels = images[::-1].copy(), labels[::-1].copy()
            batch = learner.put_batch({'image': images, 'label': labels})
            x, y = learner.dataset_train.augment_xy(batch, None, False)
            with torch.no_grad():
                loss, _ = dcp.selection_loss(learner, full, model, heads, ['conv2'], x, y,
                                             [1.0, 0.0], 'conv2')
            g = dcp.grad_norm_step(learner, full, model, heads, ['conv2'], batch, 'conv2',
                                   [1.0, 0.0])
            norms[run] = (float(loss), g.cpu().double())
    rel = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
    loss_err = rel(pgd['cuda'][0], pgd['cpu'][0])
    sel_err = abs(norms['cuda'][0] - norms['cpu'][0]) / abs(norms['cpu'][0])
    log('  CPG PGD step, ResNet-20 @ 32, fp32, batch 8: the 21 regression losses card vs CPU '
        '%.3g relative (bound 1e-3); the update %.3g of its norm from the CPU\'s (the CPU\'s '
        'reversed batch %.3g) | DCP grad-norm step, ConvNet: selection loss card vs CPU %.3g '
        'relative (bound 1e-3); the gradient norms %.3g (the CPU\'s reversed batch %.3g), '
        'argmax card %d, CPU %d', loss_err, rel(pgd['cuda'][1], pgd['cpu'][1]),
        rel(pgd['reversed'][1], pgd['cpu'][1]), sel_err, rel(norms['cuda'][1], norms['cpu'][1]),
        rel(norms['reversed'][1], norms['cpu'][1]), int(norms['cuda'][1].argmax()),
        int(norms['cpu'][1].argmax()))
    check(loss_err <= 1e-3, 'CPG regression losses card vs CPU %.3g', loss_err)
    check(sel_err <= 1e-3, 'DCP selection loss card vs CPU %.3g', sel_err)


def int8_distinct_sites(model, policy, images) -> dict:
    """One eval forward of `images` under a copy of the int8 `policy`,
    recording each distinct site (kernel shape, input shape and dtype,
    strides, padding) that ran in int8: {key: {'path', 'x', 'y', 'site',
    'layer', 'kernel', 'count'}}, count its calls in the forward."""
    from pocketflow_tpu_torch.nn.layers import compression
    from pocketflow_tpu_torch.ops import int8_ops
    seen = {}

    class Recorder(int8_ops.Int8ServingPolicy):
        def run_contraction(self, path, x, kernel, contract_fn, layer=None):
            y = super().run_contraction(path, x, kernel, contract_fn, layer)
            if y is not None:
                key = (tuple(kernel.shape), tuple(x.shape), x.dtype,
                       getattr(layer, 'strides', None), getattr(layer, 'padding', None))
                entry = seen.setdefault(key, dict(path=path, x=x, y=y, layer=layer, kernel=kernel,
                                                  site=self.sites[path, x.device], count=0))
                entry['count'] += 1
            return y

    with torch.no_grad(), compression(Recorder(policy.weight_q, policy.act_scales,
                                               policy.skip_depthwise)):
        model.eval()(images)
    return seen


def int8_sites_card_vs_cpu(sites: dict, policy) -> int:
    """Each recorded site's kernel output on the card against the plain
    version on the CPU from the same input and the same codes and scales:
    equal bit for bit.  Returns the number of sites."""
    from pocketflow_tpu_torch.ops import int8_ops
    for key, e in sites.items():
        site = e['site']
        check(e['y'].is_cuda and site.packed is not None, 'int8 site %s not on the card', key)
        codes, w_scale = policy.weight_q[e['path']]
        cpu_site = int8_ops.make_site(codes.cpu(), w_scale.cpu(), policy.act_scales[e['path']],
                                      'cpu', site.strides, site.padding, site.out_dtype,
                                      e['layer'].bias)
        want = int8_ops.int8_conv_plain(e['x'].cpu(), cpu_site)
        check(torch.equal(e['y'].cpu(), want), 'int8 kernel on the card != plain version on the '
              'CPU at %s', key)
    return len(sites)


def int8_matmul_grid_card_vs_cpu():
    """int8_matmul at odd shapes (M <= 16, K and N off the multiples cuBLASLt
    takes: widths a shrink leaves) on the card against the CPU, bit for bit.
    Returns the number of shapes."""
    from pocketflow_tpu_torch.ops import int8_ops
    shapes = [(m, k, n) for m in INT8_GRID[0] for k in INT8_GRID[1] for n in INT8_GRID[2]]
    for m, k, n in shapes:
        gen = torch.Generator().manual_seed(m + k + n)
        a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
        check(torch.equal(int8_ops.int8_matmul(a.cuda(), b.cuda()).cpu(),
                          int8_ops.int8_matmul(a, b)), 'int8_matmul card != CPU at %s', (m, k, n))
    return len(shapes)


def serving_images(helper, nb):
    """`nb` synthetic eval images of `helper`'s dataset, augmented on the card."""
    ds = helper.build_dataset_eval()
    return ds.augment(torch.from_numpy(ds.synthesize_arrays(nb)[0][:nb]).cuda(), None, False)


def serving_times(model, policies, shape):
    """{name: ms} of the eval forward under each policy (None: the float
    path), measured in turns a, b, ..., b, a: the reference protocol with
    SERVE_WARMUP + SERVE_TIMED calls."""
    from pocketflow_tpu_torch.tools.benchmark import calc_inference_time
    times = {name: [] for name in policies}
    for name in list(policies) + list(reversed(policies)):
        times[name].append(calc_inference_time(model, shape, SERVE_WARMUP, SERVE_TIMED,
                                               policy=policies[name])['latency_ms'])
    return times


def top1_agreement(model, policy, images):
    from pocketflow_tpu_torch.nn.layers import compression
    with torch.no_grad():
        ref = model(images).float()
        with compression(policy):
            out = model(images).float()
    check(torch.isfinite(ref).all() and torch.isfinite(out).all(), 'non-finite logits')
    return float((ref.argmax(-1) == out.argmax(-1)).float().mean())


def logits_delta(a, b, images):
    """max |a(x) - b(x)| / max |a(x)|."""
    with torch.no_grad():
        ya, yb = a(images).float(), b(images).float()
    check(torch.isfinite(ya).all() and torch.isfinite(yb).all(), 'non-finite logits')
    return float((ya - yb).abs().max() / ya.abs().max())


def shrunk_deltas(dense, shrunk, manifest, images):
    """(logits, (worst, block)): max |dense - shrunk| / max |dense| of the
    logits, and the worst over the blocks whose output channels a component
    kept, the dense net's kept channels against the shrunk net's."""
    kept = {c['producers'][0].split('/')[0]: c['kept_channels'] for c in manifest['components']
            if len(c['producers']) == 1}
    outs = {}
    hooks = [module.register_forward_hook(
        lambda mod, inp, out, key=(tag, name): outs.__setitem__(key, out.float()))
        for tag, net in (('dense', dense), ('shrunk', shrunk))
        for name, module in net.named_children() if name in kept]
    try:
        logits = logits_delta(dense, shrunk, images)
    finally:
        for hook in hooks:
            hook.remove()
    worst = (0.0, None)
    for name, channels in kept.items():
        want = outs['dense', name][:, channels]
        delta = float((want - outs['shrunk', name]).abs().max() / want.abs().max().clamp_min(1e-30))
        worst = max(worst, (delta, name), key=lambda d: d[0])
    return logits, worst


def phase_serving(FLAGS, work_dir, serve_ckpt, card):
    """Phase 22: runs T, U and V through export_cli.main and serving.main on
    the card (see SERVE_RUNS): no fake-quant or matmul kernel, one int8_conv
    launch a site of each int8 forward.  Returns {run label: counters}."""
    from pocketflow_tpu_torch.core import checkpoint as ckpt_lib
    from pocketflow_tpu_torch.core.bridge import load_jax_numpy, to_jax_numpy
    from pocketflow_tpu_torch.nets import mobilenet_at_ilsvrc12, resnet_at_ilsvrc12
    from pocketflow_tpu_torch.ops import int8_ops
    from pocketflow_tpu_torch.tools import export as export_lib
    from pocketflow_tpu_torch.tools import export_cli, serving, shrink_graph
    out_dir = os.path.join(work_dir, 'export')
    runs = {}

    # run T: ResNet-50 from phase 6's state
    t_flags = ['--export_model=resnet_at_ilsvrc12', '--resnet_size=50', '--resnet_stem_s2d',
               '--synthetic_data', '--compute_dtype=bfloat16']
    with FLAGS.scope(**FLAGS.as_dict()):
        reset_counters()
        start = time.perf_counter()
        artifacts = {mode: export_cli.main(t_flags + [
            '--ckpt_path=%s' % serve_ckpt, '--export_mode=%s' % mode, '--uql_weight_bits=8',
            '--output_path=%s' % os.path.join(out_dir, 'T', mode)]) for mode in ('plain', 'quant')}
        export_s = time.perf_counter() - start
        served = serving.main(t_flags + ['--artifact=%s' % artifacts['plain'],
                                         '--serve_batch=%d' % SERVE_BATCH])
        check(np.isfinite(served['logits']).all() and served['logits'].shape == (2, 1001),
              'run T: serving.main logits %s', served['logits'].shape)
        helper = resnet_at_ilsvrc12.ModelHelper(resnet_size=50)
        model = serving.load_serving_model(artifacts['plain'], helper.create_model().cuda())
        quant = serving.load_serving_model(artifacts['quant'], helper.create_model().cuda())
        images = serving_images(helper, SERVE_BATCH * (SERVE_CALIB + 1))
        calib = list(images[:SERVE_BATCH * SERVE_CALIB].split(SERVE_BATCH))
        images = images[SERVE_BATCH * SERVE_CALIB:]
        start = time.perf_counter()
        scales = int8_ops.calibrate(model, calib)
        weight_q = int8_ops.quantize_model_weights(model)
        torch.cuda.synchronize()
        calib_s = time.perf_counter() - start
        coverage = int8_ops.verify_quant_coverage(model, images[:2], weight_q, scales)
        check(len(weight_q) == len(scales) == NB_WEIGHT_SITES + 2
              and coverage == {'unquantized_weights': [], 'uncalibrated': []},
              'run T: %d weights, %d scales, coverage %s', len(weight_q), len(scales), coverage)
        # the exports', serving.main's, the calibration's and the coverage
        # check's launches: none ...
        before = counters()
        policy = int8_ops.Int8ServingPolicy(weight_q, scales)
        nb_shapes = int8_sites_card_vs_cpu(int8_distinct_sites(model, policy, images[:2]),
                                           policy)
        nb_grid = int8_matmul_grid_card_vs_cpu()
        agree = top1_agreement(model, policy, images)
        quant_delta = logits_delta(model, quant, images)
        reset_counters()  # ... and the serving forwards': one a site a forward
        times = serving_times(model, {'bf16': None, 'int8': policy},
                              (SERVE_BATCH,) + tuple(images.shape[1:]))
        serving_counts = counters()
        runs[SERVE_RUNS['T']] = {k: v + serving_counts[k] for k, v in before.items()}
    nb_forwards = 2 * (SERVE_WARMUP + 1 + SERVE_TIMED)
    check(before == no_launches(), 'run T: the exports, serving.main, calibration and coverage '
          'launched %s', before)
    check(serving_counts == no_launches(int8_conv=len(weight_q) * nb_forwards),
          'run T: launches %s over %d int8 forwards', serving_counts, nb_forwards)
    log('  %s: plain and quant export %.1f s; serving.main bf16 %.3f ms a batch of %d (%.1f '
        'img/s, %d + %d calls); int8: %d sites int8 (coverage complete), calibration on %d '
        'batches %.2f s, the int8 kernel on the card == the plain version on the CPU at all %d '
        'distinct sites (batch 2), int8_matmul card == CPU at %d odd shapes, one int8_conv '
        'launch a site a forward, top-1 agreement with bf16 %.4f on %d images; '
        'the 8-bit quant artifact\'s logits %.3e of the largest from the plain one\'s | %s',
        SERVE_RUNS['T'], export_s, served['latency_ms'], SERVE_BATCH,
        served['throughput_per_sec'], 100, 100, len(weight_q), SERVE_CALIB, calib_s, nb_shapes,
        nb_grid, agree, SERVE_BATCH, quant_delta, card)
    log('  run T latency at batch %d (ms, %d calls after %d, in turns): bf16 %s, int8 %s; '
        'int8/bf16 %.3f | %s', SERVE_BATCH, SERVE_TIMED, SERVE_WARMUP,
        [round(t, 3) for t in times['bf16']], [round(t, 3) for t in times['int8']],
        median(times['int8']) / median(times['bf16']), card)
    del model, quant, images, calib, weight_q, policy
    torch.cuda.empty_cache()

    # run U: MobileNet-v1 from run S's channel-pruned checkpoint
    s_ckpt = os.path.join(work_dir, 'mobilenet', 'S', 'cp', 'model.ckpt')
    u_flags = ['--export_model=mobilenet_at_ilsvrc12', '--mobilenet_version=1',
               '--mobilenet_depth_mult=1.0', '--synthetic_data', '--compute_dtype=bfloat16']
    with FLAGS.scope(**FLAGS.as_dict()):
        reset_counters()
        start = time.perf_counter()
        artifact = export_cli.main(u_flags + [
            '--ckpt_path=%s' % s_ckpt, '--export_mode=chn-pruned-residual',
            '--output_path=%s' % os.path.join(out_dir, 'U', 'shrunk')])
        export_s = time.perf_counter() - start
        with open(artifact + '.manifest.json') as fin:
            manifest = json.load(fin)
        helper = mobilenet_at_ilsvrc12.ModelHelper(version=1, depth_mult=1.0)
        dense = helper.create_model()
        dense.load_state_dict(ckpt_lib.restore_latest(s_ckpt, map_location='cpu')['model'])
        dense = dense.cuda().eval()
        shrunk = serving.load_serving_model(artifact, helper.create_model().cuda())
        through_dw = [c for c in manifest['components'] if len(c['kept_channels'])
                      < c['orig_channels'] and set(c['consumers']) & set(manifest['depthwise'])]
        nb_dense = sum(p.numel() for p in dense.parameters())
        nb_shrunk = sum(p.numel() for p in shrunk.parameters())
        check(through_dw and nb_shrunk < nb_dense, 'run U: no producer shrunk across a '
              'depthwise chain (%d components), %d vs %d parameters',
              len(manifest['components']), nb_shrunk, nb_dense)
        images = serving_images(helper, SERVE_BATCH * (SERVE_CALIB + 1))
        calib = list(images[:SERVE_BATCH * SERVE_CALIB].split(SERVE_BATCH))
        images = images[SERVE_BATCH * SERVE_CALIB:]
        # the shrunk tree scattered back to dense: the dense net's logits exactly
        packed = export_lib.unpack_quantized(export_lib.load_packed(artifact))
        params, stats = to_jax_numpy(dense)
        expanded = load_jax_numpy(dense.clone(), *shrink_graph.expand_to_dense(
            packed, manifest, params, stats)).cuda().eval()
        with torch.no_grad():
            check(torch.equal(expanded(images), dense(images)),
                  'run U: scattered-back logits differ from the dense net\'s')
        deltas = {'bf16': shrunk_deltas(dense, shrunk, manifest, images)}
        fp32 = {}
        for name, net in (('dense', dense), ('shrunk', shrunk)):
            fp32[name] = net.clone(dtype=torch.float32)
            fp32[name].load_state_dict(net.state_dict())
            fp32[name] = fp32[name].cuda().eval()
        deltas['fp32'] = shrunk_deltas(fp32['dense'], fp32['shrunk'], manifest, images)
        del fp32, expanded
        for dtype, tol in (('bf16', SHRUNK_BF16_TOL), ('fp32', SHRUNK_FP32_TOL)):
            check(max(deltas[dtype][0], deltas[dtype][1][0]) <= tol, 'run U: shrunk net %s '
                  'from the dense one in %s (bound %.0e)', deltas[dtype], dtype, tol)
        shape = (SERVE_BATCH,) + tuple(images.shape[1:])
        times, agree, nb_sites, int8_sites = {}, {}, {}, 0
        total = counters()  # the export's and the checks' (none) ...
        for name, net in (('dense', dense), ('shrunk', shrunk)):
            policy = int8_ops.Int8ServingPolicy(int8_ops.quantize_model_weights(net),
                                                int8_ops.calibrate(net, calib))
            agree[name] = top1_agreement(net, policy, images)
            nb_sites[name] = int8_sites_card_vs_cpu(
                int8_distinct_sites(net, policy, images[:2]), policy)
            # the sites a forward ran in int8: the stem, the pointwise convs
            # and the dense layer, and a depthwise conv pruned to one channel
            # (a conv on one input channel, as a grayscale stem)
            int8_sites += len(policy.sites)
            reset_counters()  # ... and the serving forwards': one launch a site a forward
            times.update({'%s %s' % (name, k): v for k, v in serving_times(
                net, {'bf16': None, 'int8': policy}, shape).items()})
            total = {k: v + counters()[k] for k, v in total.items()}
        runs[SERVE_RUNS['U']] = total
    nb_forwards = 2 * (SERVE_WARMUP + 1 + SERVE_TIMED)
    check(int8_sites >= 2 * INT8_SITES['mobilenet_v1'] and runs[SERVE_RUNS['U']] == no_launches(
        int8_conv=int8_sites * nb_forwards), 'run U: launches %s over 2 x %d int8 forwards of '
        '%d sites', runs[SERVE_RUNS['U']], nb_forwards, int8_sites)
    audit = manifest['flops_audit']
    log('  %s: export %.1f s; %d components, %d through depthwise chains, channels kept %s | '
        'parameters %d -> %d; FLOPs audit (conv + dense) %.4e -> %.4e (-%.2f%%); scattered back '
        'to dense: logits equal at batch %d; shrunk vs dense, of the largest: logits %.3e, '
        'the worst block\'s kept channels %.3e (%s) in bf16 (bound %.0e), %.3e and %.3e (%s) '
        'in fp32 (bound %.0e); int8 top-1 agreement with bf16 %s; the int8 kernel on the card '
        '== the plain version on the CPU at the distinct sites %s (batch 2), one int8_conv '
        'launch a site a forward (%d sites in the two nets) | %s', SERVE_RUNS['U'], export_s, len(manifest['components']), len(through_dw),
        ['%d/%d' % (len(c['kept_channels']), c['orig_channels']) for c in manifest['components']],
        nb_dense, nb_shrunk, audit['flops_before'], audit['flops_after'],
        100 * audit['reduction'], SERVE_BATCH, deltas['bf16'][0], deltas['bf16'][1][0],
        deltas['bf16'][1][1], SHRUNK_BF16_TOL, deltas['fp32'][0], deltas['fp32'][1][0],
        deltas['fp32'][1][1], SHRUNK_FP32_TOL, agree, nb_sites, int8_sites, card)
    log('  run U latency at batch %d (ms, %d calls after %d, in turns; int8 skips the depthwise '
        'convs): %s; shrunk/dense bf16 %.3f, int8 %.3f | %s', SERVE_BATCH, SERVE_TIMED,
        SERVE_WARMUP, {k: [round(t, 3) for t in v] for k, v in times.items()},
        median(times['shrunk bf16']) / median(times['dense bf16']),
        median(times['shrunk int8']) / median(times['dense int8']), card)
    del dense, shrunk, images, calib
    torch.cuda.empty_cache()

    # run V: ResNet-20 @ CIFAR-10 from run O's channel-pruned checkpoint
    o_ckpt = os.path.join(work_dir, 'resnet_at_cifar10', 'O', 'model.ckpt')
    v_flags = ['--export_model=resnet_at_cifar10', '--compute_dtype=bfloat16',
               '--nosynthetic_data', '--data_dir_local=%s' % os.path.join(work_dir, 'cifar10')]
    with FLAGS.scope(**FLAGS.as_dict()):
        reset_counters()
        artifact = export_cli.main(v_flags + [
            '--ckpt_path=%s' % o_ckpt, '--export_mode=chn-pruned-residual',
            '--output_path=%s' % os.path.join(out_dir, 'V', 'shrunk')])
        served = serving.main(v_flags + ['--artifact=%s' % artifact,
                                         '--serve_batch=%d' % ZOO_BATCH])
        with open(artifact + '.manifest.json') as fin:
            manifest = json.load(fin)
        check(manifest['components'] and np.isfinite(served['logits']).all(),
              'run V: %d components, logits %s', len(manifest['components']), served['logits'])
        runs[SERVE_RUNS['V']] = counters()
    check(runs[SERVE_RUNS['V']] == no_launches(), 'run V: launches %s', runs[SERVE_RUNS['V']])
    merged = [c for c in manifest['components'] if len(c['producers']) > 1]
    log('  %s: %d components (%d joining producers across residual merges: %s), channels kept '
        '%s; FLOPs audit -%.2f%%; serving.main %.3f ms a batch of %d | %s', SERVE_RUNS['V'],
        len(manifest['components']), len(merged),
        ['%s %d/%d' % ('+'.join(c['producers']), len(c['kept_channels']), c['orig_channels'])
         for c in merged], ['%d/%d' % (len(c['kept_channels']), c['orig_channels'])
                            for c in manifest['components']],
        100 * manifest['flops_audit']['reduction'], served['latency_ms'], ZOO_BATCH, card)
    return runs


def dp_snapshot(state) -> dict:
    """A state's parameters and BN statistics, copied to the host."""
    return {name: t.detach().cpu().clone()
            for name, t in {**state.params, **state.batch_stats}.items()}


def dp_checksum(snapshot: dict) -> str:
    import hashlib
    digest = hashlib.sha256()
    for name in sorted(snapshot):
        data = snapshot[name].contiguous().view(torch.uint8).numpy()
        digest.update(name.encode() + data.tobytes())
    return digest.hexdigest()


def dp_global_batches(learner):
    """DP_STEPS host batches of DP_WORLD x BATCH synthetic ILSVRC-12 images,
    the same on every rank whatever its shard."""
    arrays, labels = learner.dataset_train.synthesize_arrays(DP_STEPS * DP_WORLD * BATCH)
    n = DP_WORLD * BATCH
    return [{'image': arrays[np.arange(i * n, (i + 1) * n) % len(arrays)],
             'label': labels[np.arange(i * n, (i + 1) * n) % len(labels)]}
            for i in range(DP_STEPS)]


def dp_steps(learner, init_path, host_batches, perturb=None):
    """DP_STEPS quantized train steps of `learner` (the route of the flags in
    scope) from the state at init_path (with `perturb`, every parameter one
    fp32 ulp away from it: 'up', 'down', or 'mixed', each element's way
    drawn from a seeded generator), on this rank's rows of host_batches: the
    losses (the ranks' mean), the state after them, the launches and
    collectives of the steps, the peak memory and the host seconds a step."""
    from pocketflow_tpu_torch.core import mesh
    from pocketflow_tpu_torch.learners.uniform_quantization.bit_optimizer import BitOptimizer
    state, tx, _ = learner.init_state_quant()
    payload = torch.load(init_path, map_location=learner.device, weights_only=True)
    state.model.load_state_dict(payload['model'])
    if perturb:
        gen = torch.Generator(device=learner.device).manual_seed(11)
        with torch.no_grad():
            for param in state.model.parameters():
                if perturb == 'mixed':
                    way = torch.where(torch.rand(param.shape, generator=gen,
                                                 device=param.device) < 0.5, -math.inf, math.inf)
                else:
                    way = torch.full_like(param, math.inf if perturb == 'up' else -math.inf)
                param.copy_(torch.nextafter(param, way))
    state = learner.set_bits(state, *BitOptimizer(learner, state).run())
    step = learner.build_quant_train_step(tx)
    batches = [learner.put_batch(mesh.shard_batch(b)) for b in host_batches]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    mesh.reset_counters()  # the steps' launches and collectives from here ...
    start = time.perf_counter()
    losses = []
    for i, batch in enumerate(batches):
        state, metrics = step(state, batch, learner.generator(i))
        losses.append(metrics['loss'].detach().float())
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - start) / len(batches)
    out = dict(launches=counters(), collectives=mesh.counters())  # ... to here
    losses = torch.stack(losses)
    mesh.all_reduce_mean_([losses])
    out.update(losses=losses.tolist(), end=dp_snapshot(state), seconds=seconds,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    out['checksum'] = dp_checksum(out['end'])
    del state, step, batches
    torch.cuda.empty_cache()
    return out


def dp_learner(flags):
    """The main path's learner (ResNet-50 @224, bf16, exact BN, s2d stem,
    4-bit weights) at the per-rank batch of `flags`, on cuda:0."""
    from pocketflow_tpu_torch.learners.uniform_quantization.learner import UniformQuantLearner
    from pocketflow_tpu_torch.nets.resnet_at_ilsvrc12 import ModelHelper
    from pocketflow_tpu_torch.config import FLAGS
    with FLAGS.scope(**flags):
        return UniformQuantLearner(None, ModelHelper(resnet_size=50),
                                   device=torch.device('cuda', 0))


def dp_rank_x(init_path, flags):
    """Run X on one rank (two share cuda:0 over gloo): each route's steps."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from pocketflow_tpu_torch.config import FLAGS
    import pocketflow_tpu_torch.learners.uniform_quantization.learner  # noqa: F401
    import pocketflow_tpu_torch.nets.resnet_at_ilsvrc12  # noqa: F401
    FLAGS.override(synthetic_data=True, summ_step=10 ** 9, save_step=10 ** 9,
                   resnet_stem_s2d=True, rand_seed=0)
    with FLAGS.scope(**flags):
        learner = dp_learner(flags)
        host_batches = dp_global_batches(learner)
        out = {}
        for route, route_flags in DP_ROUTES:
            with FLAGS.scope(**route_flags):
                out[route] = dp_steps(learner, init_path, host_batches)
    return out


def dp_main_rank(argv):
    """main.main(argv) on one rank of run Y (cuda:0, over gloo): the ratios
    it chose and the checkpoint files it wrote."""
    from pocketflow_tpu_torch import main as port_main
    from pocketflow_tpu_torch.core import checkpoint as ckpt_lib
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    save, writes = ckpt_lib.torch.save, []

    def counted_save(obj, path, *args, **kwargs):
        writes.append(str(path))
        return save(obj, path, *args, **kwargs)

    ckpt_lib.torch.save = counted_save
    try:
        learner = port_main.main(list(argv), device='cuda:0')
    finally:
        ckpt_lib.torch.save = save
    return {'pairs': learner.var_names_n_prune_ratios, 'writes': writes}


def phase_dp_kernel(fq, device, card):
    """Phase 23a: K1''s global-range route (pass 1 alone, the (-min, max)
    pair all-reduced, pass 2 from it) at world size 1 against the fused K1'
    and the plain version, at the main path's activations in bf16 and a
    ragged fp32 tensor, bits 2-32, with and without the select; pass 1's
    pair against torch.aminmax; pass 2 from a wider range against the plain
    version from it; then timed beside the fused kernel and the bound."""
    gen = torch.Generator(device=device).manual_seed(23)

    def act(shape):
        return torch.relu(torch.randn(shape, generator=gen, device=device)).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)

    cases = [('bf16 act %s channels-last' % (shape,), act(shape)) for shape in ACT_SHAPES]
    cases.append(('fp32 ragged n=%d' % RAGGED_N[1],
                  torch.randn(RAGGED_N[1], generator=gen, device=device)))
    max_err = 0.0
    for label, x in cases:
        lo, hi = torch.aminmax(x.float())
        wide = torch.stack([-(lo - 0.5 * (hi - lo)), hi + 0.25 * (hi - lo)])
        for bits_value in (2, 4, 8, 16, 32):
            bits = torch.tensor(float(bits_value), device=device)
            k = fq._levels(bits)
            plain = fq._quantize_math_torch(x, k, None).to(x.dtype)
            plain_wide = fq._quantize_in_range(x.float(), k, -wide[0], wide[1]).to(x.dtype)
            for select in (False, True):
                got = fq.fake_quant_per_tensor_global(x, bits, select)
                check(got.stride() == x.stride() and torch.equal(
                    got, fq.fake_quant_per_tensor(x, bits, select)),
                    'global-range route differs from the fused K1\' at %s, %d bits, select %s',
                    label, bits_value, select)
                want = torch.where(bits < 32, plain, x) if select else plain
                err, _ = compare(got, want, float((hi - lo) / k))
                max_err = max(max_err, err)
                if not (select and bits_value >= 32):
                    check(torch.equal(fq.tensor_minmax(x, bits, select), torch.stack([-lo, hi])),
                          'pass 1 of %s is not (-min, max)', label)
                from_range = fq.tensor_from_range(x, bits, wide, select)
                want = torch.where(bits < 32, plain_wide, x) if select else plain_wide
                check(torch.equal(from_range, want), 'pass 2 from a given range differs from '
                      'the plain version at %s, %d bits, select %s', label, bits_value, select)
            del plain, plain_wide, got, from_range, want
        log('  %s: the global-range route equals the fused K1\' at bits 2-32 with and without '
            'the select; pass 2 from (%.4g, %.4g) equals the plain version', label,
            float(-wide[0]), float(wide[1]))
    del cases
    bits = torch.tensor(8.0, device=device)
    k = fq._levels(bits)
    result = None
    for shape in ACT_SHAPES:
        x = act(shape)

        def plain_route():
            lo_hi = torch.stack(torch.aminmax(x.float()))
            return torch.where(bits < 32, fq._quantize_in_range(
                x.float(), k, lo_hi[0], lo_hi[1]).to(x.dtype), x)

        ms = time_ms(lambda: fq.fake_quant_per_tensor_global(x, bits, select=True))
        fused_ms = time_ms(lambda: fq.fake_quant_per_tensor(x, bits, select=True))
        plain_ms = time_ms(plain_route, 5)
        bound_ms, bound_by = fq_bound(x.numel(), 2)
        log('  fake_quant_per_tensor_global with the select, bf16 act %s, 8 bits, world 1: '
            '%.4f ms a call (%.0f%% of the bound), fused K1\' %.4f ms, plain %.4f ms, bound '
            '%.4f ms (%s) | %s', shape, ms, 100 * bound_ms / ms, fused_ms, plain_ms, bound_ms,
            bound_by, card)
        if result is None:  # the line reports the largest activation
            result = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, library_ms=None, fused_ms=fused_ms)
        del x
    return {'fake_quant_per_tensor_global': result}


def phase_dp_world1(FLAGS, card):
    """Phase 23b, run W: DP_STEPS main-path steps without a process group,
    then the same steps from the same initial state with --enbl_multi_gpu in
    a one-rank NCCL group: the loss, every parameter and BN statistic bit-
    equal, no collective, one grouped K1' launch a forward.  cuDNN runs its
    deterministic algorithms in both (its default weight gradients may sum
    in any order).  Returns {run label: counters}."""
    import torch.distributed as dist
    from pocketflow_tpu_torch.core import mesh
    runs, results, host_batches = {}, [], None
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    for grouped in (False, True):
        store = os.path.join(tempfile.mkdtemp(prefix='pf_dp_'), 'store')
        if grouped:
            dist.init_process_group('nccl', init_method='file://' + store, world_size=1, rank=0)
        try:
            with FLAGS.scope(**DP_FLAGS, enbl_multi_gpu=grouped):
                learner = dp_learner(DP_FLAGS)
                state, tx, _ = learner.init_state_quant()
                step = learner.build_quant_train_step(tx)
                if host_batches is None:
                    iterator = learner.dataset_train.build()
                    host_batches = [next(iterator) for _ in range(DP_STEPS)]
                start = dp_snapshot(state)
                reset_counters()
                mesh.reset_counters()  # the run's launches and collectives from here ...
                losses = []
                for i, batch in enumerate(host_batches):
                    state, metrics = step(state, learner.put_batch(batch), learner.generator(i))
                    losses.append(metrics['loss'].detach())
                torch.cuda.synchronize()
                results.append(dict(launches=counters(), collectives=mesh.counters(),
                                    world=mesh.num_workers(), start=start,
                                    losses=[float(v) for v in losses], end=dp_snapshot(state)))
                del learner, state, step, tx
                torch.cuda.empty_cache()
        finally:
            if grouped:
                dist.destroy_process_group()
    torch.backends.cudnn.deterministic = deterministic
    alone, grouped = results
    runs[DP_RUN_W] = grouped['launches']
    check(grouped['world'] == 1, 'run W: world %d', grouped['world'])
    check(all(torch.equal(alone['start'][k], grouped['start'][k]) for k in alone['start']),
          'run W: the initial states differ')
    check(alone['losses'] == grouped['losses'], 'run W: losses %s vs %s', grouped['losses'],
          alone['losses'])
    differ = [k for k in alone['end'] if not torch.equal(alone['end'][k], grouped['end'][k])]
    check(not differ, 'run W: %d tensors differ after %d steps (%s)', len(differ), DP_STEPS,
          differ[:3])
    check(grouped['collectives'] == {'all_reduce': 0, 'broadcast': 0, 'barrier': 0},
          'run W: collectives %s', grouped['collectives'])
    check(grouped['launches'] == no_launches(fake_quant_per_tensor_group=DP_STEPS),
          'run W: launches %s', grouped['launches'])
    log('  run W: %d steps in a one-rank NCCL group with --enbl_multi_gpu bit-equal to the '
        'same steps without a group (losses %s, %d tensors), collectives %s, launches %s',
        DP_STEPS, ['%.6f' % v for v in grouped['losses']], len(alone['end']),
        grouped['collectives'], grouped['launches'])
    return runs


def dp_errors(got, want, reruns):
    """For the parameters and for the BN statistics, each as one vector:
    (||got - want||, the largest ||rerun - want||); and per tensor, the
    largest ratio of ||got - want|| to its reruns' largest distance and the
    number of tensors past DP_NOISE_FACTOR x that distance."""
    def dist(a, keys):
        return math.sqrt(sum(float(torch.sum((a[k] - want[k]).double() ** 2)) for k in keys))
    groups = {'parameters': [k for k in want if not k.endswith(('/mean', '/var'))],
              'BN statistics': [k for k in want if k.endswith(('/mean', '/var'))]}
    out = {name: (dist(got, keys), max(dist(r, keys) for r in reruns))
           for name, keys in groups.items()}
    ratios = [dist(got, [k]) / max(max(dist(r, [k]) for r in reruns), 1e-30) for k in want]
    return out, max(ratios), sum(ratio > DP_NOISE_FACTOR for ratio in ratios)


def phase_dp_two_ranks(FLAGS, work_dir, card):
    """Phase 23c, run X: one rank at the global batch (DP_WORLD x BATCH) for
    each route, and again from parameters one ulp up (the bound's spread);
    then DP_WORLD ranks on cuda:0 over gloo at BATCH each, from the same
    saved state on the same global batches split by rows: bit-identical
    ranks, within the bound of the one rank, the collectives of a step
    counted.  Returns {run label: rank 0's counters}."""
    from pocketflow_tpu_torch.nn.layers import BatchNorm
    from pocketflow_tpu_torch.tools import launch
    init_path = os.path.join(work_dir, 'dp_init.pt')
    flags1 = dict(DP_FLAGS, batch_size=DP_WORLD * BATCH)
    ref = {}
    with FLAGS.scope(**flags1):
        learner = dp_learner(flags1)
        nb_bn = sum(isinstance(m, BatchNorm) for m in learner.model_helper.create_model().modules())
        state, _, _ = learner.init_state_quant()
        torch.save({'model': state.model.state_dict()}, init_path)
        del state
        host_batches = dp_global_batches(learner)
        for route, route_flags in DP_ROUTES:
            with FLAGS.scope(**route_flags):
                ref[route] = (dp_steps(learner, init_path, host_batches),
                              [dp_steps(learner, init_path, host_batches, perturb=way)
                               for way in DP_PERTURBATIONS])
            log('  run X, one rank at batch %d, %s: losses %s, %.1f ms a step, peak %.2f GiB',
                DP_WORLD * BATCH, route, ['%.6f' % v for v in ref[route][0]['losses']],
                1e3 * ref[route][0]['seconds'], ref[route][0]['peak_gib'])
        del learner
    torch.cuda.empty_cache()
    start = time.perf_counter()
    ranks = launch.spawn('chip_smoke:dp_rank_x', DP_WORLD,
                         {'init_path': init_path, 'flags': DP_FLAGS}, backend='gloo',
                         timeout=DP_RANK_TIMEOUT, work_dir=os.path.join(work_dir, 'dp_x'),
                         threads=0)
    log('  run X: %d ranks spawned and joined in %.1f s', DP_WORLD, time.perf_counter() - start)
    runs = {}
    for route, _ in DP_ROUTES:
        label = DP_RUN_X[route]
        outs = [r[route] for r in ranks]
        runs[label] = outs[0]['launches']
        one, reruns = ref[route]
        check(len({o['checksum'] for o in outs}) == 1, 'run X %s: ranks differ', route)
        check(outs[0]['losses'] == outs[1]['losses'], 'run X %s: rank losses differ', route)
        per_step = {'all_reduce': 1 + 2 * nb_bn + (NB_ACT_SITES if route == 'act8' else 0),
                    'broadcast': 0, 'barrier': 0}
        want = {k: DP_STEPS * v for k, v in per_step.items()}
        check(all(o['collectives'] == want for o in outs), 'run X %s: collectives %s, '
              'expected %s', route, outs[0]['collectives'], want)
        launches = dict(fake_quant_per_tensor_group=DP_STEPS)
        if route == 'act8':
            launches['fake_quant_per_tensor_global'] = DP_STEPS * NB_ACT_SITES
        check(all(o['launches'] == no_launches(**launches) for o in outs),
              'run X %s: launches %s', route, outs[0]['launches'])
        groups, worst, nb_past = dp_errors(outs[0]['end'], one['end'], [r['end'] for r in reruns])
        groups['loss'] = (max(abs(a - b) for a, b in zip(outs[0]['losses'], one['losses'])),
                          max(abs(a - b) for r in reruns
                              for a, b in zip(r['losses'], one['losses'])))
        log('  run X %s: %d ranks bit-identical (sha256 %s...), losses %s (one rank %s); '
            'against one rank at batch %d, distance / the largest of %d 1-ulp reruns\' (%s): '
            '%s; per tensor the largest ratio %.3f, %d of %d past %.0fx; collectives a step '
            '%s; launches %s; %.1f ms a step (gloo, 102 MB of gradients through the host: a '
            'correctness run), peak %.2f / %.2f GiB a rank | %s', route, DP_WORLD,
            outs[0]['checksum'][:12], ['%.6f' % v for v in outs[0]['losses']],
            ['%.6f' % v for v in one['losses']], DP_WORLD * BATCH, len(reruns),
            ', '.join(DP_PERTURBATIONS),
            '; '.join('%s %.4g / %.4g' % (k, *v) for k, v in groups.items()), worst, nb_past,
            len(one['end']), DP_NOISE_FACTOR, per_step, outs[0]['launches'],
            1e3 * max(o['seconds'] for o in outs), outs[0]['peak_gib'], outs[1]['peak_gib'],
            card)
        for name, (err, spread) in groups.items():
            check(err <= DP_NOISE_FACTOR * spread, 'run X %s: %s %.4g from one rank, past %.0fx '
                  'the 1-ulp reruns\' %.4g', route, name, err, DP_NOISE_FACTOR, spread)
    return runs


def phase_dp_main(FLAGS, work_dir, card):
    """Phase 23d, run Y: main.main on DP_WORLD ranks on cuda:0 over gloo,
    ResNet-20 @ CIFAR-10 weight-sparse (optimal, run H's flags) from run A's
    baseline: equal ratios on every rank, one checkpoint written by rank 0,
    every masked weight 0.  Returns {run label: {}} (launches: none)."""
    from pocketflow_tpu_torch.tools import launch
    ws_path = os.path.join(work_dir, 'dp_y', 'ws', 'model.ckpt')
    argv = zoo_argv(work_dir, 'resnet_at_cifar10', WS_RUNS[1][2] + [
        '--ws_save_path=%s' % ws_path, '--enbl_multi_gpu'])
    start = time.perf_counter()
    ranks = launch.spawn('chip_smoke:dp_main_rank', DP_WORLD, {'argv': argv}, backend='gloo',
                         timeout=DP_RANK_TIMEOUT, work_dir=os.path.join(work_dir, 'dp_y'),
                         threads=0)
    elapsed = time.perf_counter() - start
    pairs = [r['pairs'] for r in ranks]
    check(all(p == pairs[0] for p in pairs) and pairs[0], 'run Y: ratios differ: %s', pairs)
    files = sorted(os.listdir(os.path.dirname(ws_path)))
    ckpts = [f for f in files if f.endswith('.pt')]
    check(len(ckpts) == 1 and 'checkpoint.json' in files, 'run Y: files %s', files)
    writes = [[w for w in r['writes'] if w.startswith(ws_path) and w.endswith('.pt.tmp')]
              for r in ranks]
    check(len(writes[0]) == 1 and not any(writes[1:]), 'run Y: checkpoint writes %s', writes)
    nb_masked = ws_masked_weights_zero(ws_path)
    log('  run Y: %d ranks chose equal ratios %s; one checkpoint (%s) written by rank 0 only; '
        '%d masked kernels zero where masked | %.1f s | %s', DP_WORLD,
        [round(r, 4) for _, r in pairs[0]], ckpts[0], nb_masked, elapsed, card)
    return {DP_RUN_Y: no_launches()}


# ---------------------------------------------------------------------------
# phase 24: detection
# ---------------------------------------------------------------------------

def det_argv(work_dir, model, argv):
    """main.main's argv for a detector at phase 24's sizes (synthetic VOC),
    its files under work_dir/detection/<model>, then `argv`."""
    model_dir = os.path.join(work_dir, 'detection', model)
    return ['--model=%s' % model, '--data_dir_local=', '--batch_size=%d' % DET_BATCH,
            '--batch_size_eval=%d' % DET_BATCH, '--nb_smpls_train=%d' % DET_TRAIN,
            '--nb_smpls_eval=%d' % DET_EVAL, '--compute_dtype=bfloat16', '--rand_seed=0',
            '--summ_step=%d' % 10 ** 9, '--save_step=%d' % 10 ** 9,
            '--log_dir=%s' % os.path.join(model_dir, 'logs'),
            '--save_path=%s' % os.path.join(model_dir, 'models', 'model.ckpt'),
            '--uql_save_quant_model_path=%s' % os.path.join(model_dir, 'uql', 'model.ckpt'),
            '--cp_channel_pruned_path=%s' % os.path.join(model_dir, 'cp', 'model.ckpt')] + argv


class DetStepProbe:
    """`on_step` for run_main over a detection run of DET_STEPS steps: the
    host time of the DET_TIMED steps after DET_WARMUP (synchronized at the
    window's edges only); then DET_PROFILED steps under the profiler, the
    device only (busy time, idle share, layers); then DET_PROFILED steps
    with the host's ops recorded, for the detection spans the program names
    (tools/profile_step.py's RANGES), which slows the host."""

    def __init__(self):
        self.index, self.window_ms, self.profile = 0, None, None
        self._t0 = self._prof = None

    def _start(self, ranges: bool):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if ranges else [])
        self._prof = profile(activities=activities)
        self._prof.start()

    def _stop(self):
        prof, self._prof = self._prof, None
        prof.stop()
        return prof

    def close(self):
        """Stop a profile still running (the run raised inside its window)."""
        if self._prof is not None:
            self._stop()

    def __call__(self, when, state):
        from pocketflow_tpu_torch.tools import profile_step
        first_profiled = DET_WARMUP + DET_TIMED
        if when == 'before':
            if self.index == DET_WARMUP:
                torch.cuda.synchronize()
                self._t0 = time.perf_counter()
            elif self.index == first_profiled:
                torch.cuda.synchronize()
                self.window_ms = 1e3 * (time.perf_counter() - self._t0) / DET_TIMED
                self._start(ranges=False)
            elif self.index == first_profiled + DET_PROFILED:
                self._start(ranges=True)
            return
        self.index += 1
        if self.index in (first_profiled + DET_PROFILED, DET_STEPS):
            torch.cuda.synchronize()
            prof = self._stop()
            if self.index < DET_STEPS:
                self.profile = profile_step.summarize(profile_step.device_events(prof),
                                                      DET_PROFILED)
            else:
                spans = profile_step.range_times(prof, DET_PROFILED)
                self.profile['spans_per_step'] = {
                    name: spans[name] for name in profile_step.RANGES if name in spans}


def detection_list(helper):
    """The detections a helper scored last, image by image, as (class,
    score, box) tuples, and a checksum of its ground truths."""
    import hashlib
    dets = [[(d['class'], d['score'], tuple(float(v) for v in d['box'])) for d in image]
            for image in helper._detections]
    digest = hashlib.sha256(b''.join(np.asarray(g, np.float32).tobytes()
                                     for g in helper._groundtruth)).hexdigest()
    return dets, digest


class MapRecorder:
    """Records each learner.eval_map's result, the detections it scored and
    its time by part (forward, decode, host NMS, VOC eval), while open."""

    def __init__(self):
        from pocketflow_tpu_torch.learners.abstract_learner import AbstractLearner
        self.maps, self.detections, self.timings = [], [], []
        eval_map = self._eval_map = AbstractLearner.eval_map
        recorder = self

        def recorded(learner, state, policy=None, timings=None):
            timings = {} if timings is None else timings
            recorder.maps.append(eval_map(learner, state, policy, timings))
            recorder.timings.append(timings)
            recorder.detections.append(detection_list(learner.model_helper))
            return recorder.maps[-1]

        AbstractLearner.eval_map = recorded

    def close(self):
        from pocketflow_tpu_torch.learners.abstract_learner import AbstractLearner
        AbstractLearner.eval_map = self._eval_map


def det_eval(FLAGS, work_dir, label, model, argv, per_forward, card):
    """main.main(argv --exec_mode=eval) of a detector on the card: the eval
    loop and the mAP over the eval set, its launches (per_forward a quantized
    forward), its time by part.  Returns (label, counters)."""
    recorder = MapRecorder()
    try:
        _, counter, counts, elapsed = run_main(FLAGS, work_dir, model,
                                               argv + ['--exec_mode=eval'], None, det_argv)
    finally:
        recorder.close()
    check(len(recorder.maps) == 1 and 'mAP' in recorder.maps[0]
          and all(math.isfinite(v) for v in recorder.maps[0].values()),
          '%s eval: mAP %s', label, recorder.maps)
    want = no_launches(**{name: n * counter.forwards for name, n in per_forward.items()})
    check(counts == want and (counter.forwards > 0) == bool(per_forward),
          '%s eval: launches %s over %d quantized forwards', label, counts, counter.forwards)
    dets, _ = recorder.detections[0]
    times = recorder.timings[0]
    log('  %s eval: mAP %.4f over %d images (%d detections; %d classes with an AP) | eval loss '
        '%s | forward %.3f s, decode + copy %.3f s, host NMS %.3f s, VOC eval %.3f s | launches '
        '%s | %.1f s (restore, eval loop, mAP) | %s', label, recorder.maps[0]['mAP'], len(dets),
        sum(map(len, dets)), len(recorder.maps[0]) - 1,
        {k: round(v, 4) for k, v in counter.evals[-1].items()}, times['forward'],
        times['decode'], times['nms'], times['voc_eval'], counts, elapsed, card)
    return label + ' (eval)', counts


def det_train(FLAGS, work_dir, label, model, argv, per_forward, card, sites=None):
    """A detector's train run through main.main on the card: DET_STEPS
    steps, timed and profiled (DetStepProbe), its launches checked against
    its quantized forwards, its peak memory.  Returns (learner, counters)."""
    probe = DetStepProbe()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        learner, counter, counts, elapsed = run_main(FLAGS, work_dir, model, argv, probe,
                                                     det_argv)
    finally:
        probe.close()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loss = float(counter.metrics['loss'])
    check(counter.steps == DET_STEPS, '%s: %d steps', label, counter.steps)
    check(math.isfinite(loss), '%s: loss %r', label, loss)
    check(counter.evals and all(math.isfinite(v) for v in counter.evals[-1].values()),
          '%s: eval %s', label, counter.evals)
    want = no_launches(**{name: n * counter.forwards for name, n in per_forward.items()})
    check(counts == want, '%s: launches %s over %d quantized forwards, expected %s', label,
          counts, counter.forwards, want)
    if per_forward:
        stats = learner.statistics
        check((stats['nb_matmuls'], stats['nb_activations']) == sites, '%s: sites %d/%d',
              label, stats['nb_matmuls'], stats['nb_activations'])
        check(stats['weight_paths'][-1] == SSD_LAST, '%s: last quantized %s', label,
              stats['weight_paths'][-1])
        check(counter.forwards > counter.steps, '%s: %d forwards, %d steps', label,
              counter.forwards, counter.steps)
    else:
        check(counter.forwards == 0, '%s: %d quantized forwards', label, counter.forwards)
    prof = probe.profile
    log('  %s: %d steps (%d quantized forwards with the eval loop), loss %.4f, eval %s | '
        'launches %s | %.2f ms a step over %d steps after %d (%.1f img/s), device busy %.2f of '
        '%.2f ms a step (idle %.1f%%), %.0f device events a step, peak memory %.2f GiB | %.1f s '
        '(the run, its eval loop and its checkpoint) | %s', label, counter.steps,
        counter.forwards, loss, {k: round(v, 4) for k, v in counter.evals[-1].items()}, counts,
        probe.window_ms, DET_TIMED, DET_WARMUP, DET_BATCH * 1e3 / probe.window_ms,
        prof['busy_ms_per_step'], prof['window_ms_per_step'], 100 * prof['idle_share'],
        prof['device_events_per_step'], peak, elapsed, card)
    log('  %s: device ms a step by layer %s; by program span %s', label,
        {k: round(v, 3) for k, v in prof['by_category_ms_per_step'].items()},
        {k: {kk: round(vv, 3) for kk, vv in v.items()}
         for k, v in prof['spans_per_step'].items()})
    return learner, counts


def phase_det_ssd(FLAGS, work_dir, card):
    """Phase 24a: SSD-VGG16 runs D1-D3 through main.main, each with its
    launches a forward (none; one grouped K1'; and 23 K1' with the select),
    D1 and D2 then evaluated with mAP.  Returns ({label: counters}, the
    quantized weight shapes)."""
    runs, shapes = {}, None
    for label, argv, per_forward, eval_argv in SSD_RUNS:
        learner, runs[label] = det_train(FLAGS, work_dir, label, 'vgg_at_pascalvoc', argv,
                                         per_forward, card, SSD_SITES)
        if per_forward:
            shapes = learner.statistics['weight_shapes']
        del learner
        if eval_argv is not None:
            eval_label, counts = det_eval(FLAGS, work_dir, label, 'vgg_at_pascalvoc',
                                          argv + eval_argv, per_forward, card)
            runs[eval_label] = counts
        torch.cuda.empty_cache()
    return runs, shapes


def phase_det_kernels(fq, shapes, device, card):
    """Phase 24b: the grouped K1' at SSD-300's 33 quantized weight shapes
    (4 bits) bit-equal to the plain version and the per-tensor kernel,
    tensor by tensor; K1' with the select on SSD's largest activation (bf16
    32x64x300x300, 8 bits) against the plain version and its select; each
    timed beside the plain version, with its bound."""
    check(len(shapes) == SSD_SITES[0], '%d SSD weight shapes', len(shapes))
    gen = torch.Generator(device=device).manual_seed(24)
    weights = [torch.randn(s, generator=gen, device=device) * 0.05 for s in shapes]
    bits = torch.full((len(weights),), 4.0, device=device)
    k4 = fq._levels(bits[0])
    got = fq.fake_quant_per_tensor_group(weights, bits)
    for i, (w, g) in enumerate(zip(weights, got)):
        check(torch.equal(g, fq._quantize_math_torch(w, k4, None)),
              'grouped K1\' differs from plain at SSD weight %d %s', i, tuple(w.shape))
        check(torch.equal(g, fq.fake_quant_per_tensor(w, bits[i])),
              'grouped K1\' differs from the per-tensor kernel at SSD weight %d', i)
    ms = time_ms(lambda: fq.fake_quant_per_tensor_group(weights, bits))
    plain_ms = time_ms(lambda: [torch.where(b < 32, fq._quantize_math_torch(w, k4, None), w)
                                for w, b in zip(weights, bits)])
    nb = sum(w.numel() for w in weights)
    bound_ms, bound_by = fq_bound(nb)
    log('  grouped K1\' at SSD-300\'s %d quantized weights (%.1f M values), 4 bits: equal to '
        'plain and to the per-tensor kernel, tensor by tensor | kernel %.4f ms (%.0f%% of the '
        'bound), plain %.4f ms, bound %.4f ms (%s) | %s', len(weights), nb / 1e6, ms,
        100 * bound_ms / ms, plain_ms, bound_ms, bound_by, card)
    del weights, got
    bits8 = torch.tensor(8.0, device=device)
    k8 = fq._levels(bits8)
    shape = (DET_BATCH, 64, 300, 300)
    x = torch.relu(torch.randn(shape, generator=gen, device=device)).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    want = torch.where(bits8 < 32, fq._quantize_math_torch(x, k8, None).to(x.dtype), x)
    got = fq.fake_quant_per_tensor(x, bits8, select=True)
    check(got.stride() == x.stride(), 'K1\' lost the layout of %s', shape)
    err, nd = compare(got, want, float((x.max().float() - x.min().float()) / k8))
    del want, got
    ms = time_ms(lambda: fq.fake_quant_per_tensor(x, bits8, select=True))
    plain_ms = time_ms(lambda: torch.where(
        bits8 < 32, fq._quantize_math_torch(x, k8, None).to(x.dtype), x), 5)
    bound_ms, bound_by = fq_bound(x.numel(), 2)
    log('  K1\' with the select, bf16 act %s (SSD\'s conv1 outputs), 8 bits: max|d|=%.3g '
        'n_diff=%d vs plain + select | kernel %.4f ms (%.0f%% of the bound), plain + select %.4f '
        'ms, bound %.4f ms (%s) | %s', shape, err, nd, ms, 100 * bound_ms / ms, plain_ms,
        bound_ms, bound_by, card)
    del x
    torch.cuda.empty_cache()


def phase_det_frcnn(FLAGS, work_dir, card):
    """Phase 24c: Faster R-CNN (ResNet-50 trunk) run D4 through main.main,
    then its eval with mAP; the proposal layer's and ROI-align's device time
    and launches within the step come from the profiled steps."""
    runs = {}
    argv = FRCNN_FLAGS + ['--learner=full-prec']
    learner, runs[FRCNN_RUN] = det_train(FLAGS, work_dir, FRCNN_RUN, 'faster_rcnn_at_pascalvoc',
                                         argv, {}, card)
    del learner
    torch.cuda.empty_cache()
    label, counts = det_eval(FLAGS, work_dir, FRCNN_RUN, 'faster_rcnn_at_pascalvoc', argv, {},
                             card)
    runs[label] = counts
    return runs


def det_rank(argv):
    """main.main(argv) on one rank of run D5 (cuda:0, over gloo): the
    checkpoint files it wrote, the mAP and detections of its eval_map, and at
    each save the zero input channels of every conv kernel with at least 8."""
    from pocketflow_tpu_torch import main as port_main
    from pocketflow_tpu_torch.core import checkpoint as ckpt_lib
    from pocketflow_tpu_torch.learners.abstract_learner import AbstractLearner
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    save, save_model = ckpt_lib.torch.save, AbstractLearner.save_model
    record = {'writes': [], 'zeros': []}

    def counted_save(obj, path, *args, **kwargs):
        record['writes'].append(str(path))
        return save(obj, path, *args, **kwargs)

    def recorded_save_model(learner, state, *args, **kwargs):
        zeros = {}
        for name, param in state.params.items():
            if name.endswith('/kernel') and param.dim() == 4 and param.shape[2] >= 8:
                norms = param.detach().float().permute(2, 0, 1, 3).reshape(
                    param.shape[2], -1).norm(dim=1)
                zeros[name] = (norms == 0).cpu().numpy()
        record['zeros'].append(zeros)
        return save_model(learner, state, *args, **kwargs)

    ckpt_lib.torch.save, AbstractLearner.save_model = counted_save, recorded_save_model
    recorder = MapRecorder()
    try:
        port_main.main(list(argv), device='cuda:0')
    finally:
        ckpt_lib.torch.save, AbstractLearner.save_model = save, save_model
        recorder.close()
    record.update(maps=recorder.maps, detections=recorder.detections)
    return record


def phase_det_config5(FLAGS, work_dir, card):
    """Phase 24d, run D5: BASELINE config #5 on DET_WORLD ranks sharing the
    card over gloo: the channel learner's pipeline on Faster R-CNN
    (ResNet-50) from D4's baseline (restore, LASSO selection, reconstruction,
    finetune), then its eval on the ranks: pruned input channels zero in
    mid-trunk kernels and equal on every rank, one checkpoint written by
    rank 0, the mAP equal on every rank and to one rank's eval of the
    checkpoint over the same set, the gathered detections that rank's."""
    from pocketflow_tpu_torch.tools import launch
    model = 'faster_rcnn_at_pascalvoc'
    argv = det_argv(work_dir, model, FRCNN_FLAGS + CONFIG5_FLAGS)
    cp_dir = os.path.join(work_dir, 'detection', model, 'cp')
    start = time.perf_counter()
    train = launch.spawn('chip_smoke:det_rank', DET_WORLD, {'argv': argv}, backend='gloo',
                         timeout=DP_RANK_TIMEOUT, work_dir=os.path.join(work_dir, 'det_d5'),
                         threads=0)
    t_train = time.perf_counter() - start
    # after D4's 10 steps the BN running statistics are far from the
    # batches' (D4's eval loss ~1e6) and every foreground score is 0: score
    # every class of 30 proposals an image, so that the gathered detections
    # carry the comparison
    argv_eval = argv + ['--exec_mode=eval', '--frcnn_score_threshold=-1',
                        '--frcnn_nb_proposals=30']
    evals = launch.spawn('chip_smoke:det_rank', DET_WORLD, {'argv': argv_eval},
                         backend='gloo', timeout=DP_RANK_TIMEOUT,
                         work_dir=os.path.join(work_dir, 'det_d5_eval'), threads=0)
    t_eval = time.perf_counter() - start - t_train
    zeros = [r['zeros'][-1] for r in train]
    check(all(sorted(z) == sorted(zeros[0]) and all(np.array_equal(z[k], zeros[0][k])
                                                    for k in z) for z in zeros),
          'run D5: the ranks pruned different channels')
    mid = {k: int(v.sum()) for k, v in zeros[0].items()
           if k.startswith('backbone/') and 'conv_init' not in k and v.any()}
    check(mid, 'run D5: no mid-trunk input channel is zero')
    files = sorted(os.listdir(cp_dir))
    writes = [[w for w in r['writes'] if w.startswith(cp_dir) and w.endswith('.pt.tmp')]
              for r in train]
    check(len([f for f in files if f.endswith('.pt')]) == 1 and len(writes[0]) == 1
          and not any(writes[1:]), 'run D5: files %s, writes %s', files, writes)
    maps = [r['maps'][-1] for r in evals]
    check(all(m == maps[0] for m in maps) and 'mAP' in maps[0], 'run D5: mAP by rank %s', maps)
    check(all(r['detections'][-1] == evals[0]['detections'][-1] for r in evals),
          'run D5: the ranks gathered different detections')
    recorder = MapRecorder()
    try:
        single = [a for a in argv_eval if a != '--enbl_multi_gpu']
        run_main(FLAGS, work_dir, model, single, None, lambda w, m, a: a)
    finally:
        recorder.close()
    check(recorder.maps[-1] == maps[0], 'run D5: 2-rank mAP %s, 1-rank %s', maps[0],
          recorder.maps[-1])
    check(recorder.detections[-1] == evals[0]['detections'][-1],
          'run D5: the gathered detections differ from one rank\'s')
    dets = recorder.detections[-1][0]
    check(sum(map(len, dets)) > 0, 'run D5: no detection to compare')
    log('  %s: equal masks on %d ranks, %d kernels with zero input channels (mid-trunk: %d '
        'kernels, %d channels), one checkpoint (%s) from rank 0 | eval on %d ranks: mAP %.4f on '
        'every rank and on one rank over the same %d images (%d detections, gathered = one '
        'rank\'s) | %.1f s the pipeline, %.1f s the eval | %s', CONFIG5_RUN, DET_WORLD,
        sum(v.any() for v in zeros[0].values()), len(mid), sum(mid.values()),
        [f for f in files if f.endswith('.pt')][0], DET_WORLD, maps[0]['mAP'], len(dets),
        sum(map(len, dets)), t_train, t_eval, card)
    return {CONFIG5_RUN: no_launches()}


def phase_det_reference(FLAGS, UniformQuantLearner):
    """Phase 24e, card vs CPU at 64x64, batch 4, fp32 without TF32, from one
    seed: an SSD-VGG16 QAT step (the grouped K1' on the card, the plain
    version on the CPU): its loss within 1e-3 relative and its update within
    1e-2 of the CPU's (relative L2); a Faster R-CNN (ResNet-50) eval forward:
    the proposals' validity equal, every output within 1e-3 + 1e-3 of its
    largest."""
    from pocketflow_tpu_torch.learners.full_precision import FullPrecLearner
    from pocketflow_tpu_torch.nets import faster_rcnn_at_pascalvoc, vgg_at_pascalvoc
    out = {}
    with FLAGS.scope(**DET_SMALL):
        for device in ('cuda', 'cpu'):
            learner = UniformQuantLearner(None, vgg_at_pascalvoc.ModelHelper(), device=device)
            ds = learner.dataset_train
            ds.augment_xy = lambda batch, gen, is_train, ds=ds: type(ds).augment_xy(
                ds, batch, gen, False)
            state, tx, _ = learner.init_state_quant()
            before = {k: v.detach().cpu().clone() for k, v in state.params.items()}
            images, labels = ds.synthesize_detection_arrays(64)
            batch = learner.put_batch({'image': images[:4], 'label': labels[:4]})
            state, metrics = learner.build_quant_train_step(tx)(state, batch, None)
            update = torch.cat([(v.detach().cpu() - before[k]).reshape(-1)
                                for k, v in state.params.items()])
            with FLAGS.scope(frcnn_backbone='resnet50'):
                det = FullPrecLearner(None, faster_rcnn_at_pascalvoc.ModelHelper(), device=device)
                dstate, _, _ = det.init_state()
                with torch.no_grad():
                    outputs = det.model_helper.forward_eval(
                        dstate.model, ds.augment(batch['image'], None, False))
            out[device] = (float(metrics['loss']), update,
                           {k: v.detach().cpu() for k, v in outputs.items()})
    (loss_gpu, up_gpu, o_gpu), (loss_cpu, up_cpu, o_cpu) = out['cuda'], out['cpu']
    up_err = float((up_gpu - up_cpu).norm() / up_cpu.norm())
    check(abs(loss_gpu - loss_cpu) <= 1e-3 * abs(loss_cpu), 'SSD loss card %r CPU %r',
          loss_gpu, loss_cpu)
    check(up_err <= 1e-2, 'SSD update card vs CPU %.3g relative', up_err)
    check(torch.equal(o_gpu['proposal_valid'], o_cpu['proposal_valid']),
          'Faster R-CNN proposal validity differs card vs CPU')
    errs = {}
    for key in ('obj_logits', 'rpn_deltas', 'proposals', 'cls_logits', 'box_deltas'):
        largest = float(o_cpu[key].abs().max())
        errs[key] = (float((o_gpu[key] - o_cpu[key]).abs().max()), largest)
        check(errs[key][0] <= 1e-3 + 1e-3 * largest, 'Faster R-CNN %s card vs CPU %.3g (of %.3g)',
              key, *errs[key])
    log('  SSD QAT step card vs CPU: loss %.6f / %.6f, update within %.3g (relative L2); Faster '
        'R-CNN eval forward card vs CPU: proposals\' validity equal, max|d| (of the largest) %s',
        loss_gpu, loss_cpu, up_err, {k: '%.3g (%.3g)' % v for k, v in errs.items()})


# phase 25: the real-data path


def rd_write_shards(root):
    """25a: RD_SHARDS train shards of RD_SHARD full-frame samples and a val
    shard of RD_VAL, written with convert_ilsvrc12._flush: frames of aspect
    3:4 to 16:9 (a seeded draw) fitted into the [RD_RESIZE, RD_RESIZE * 4/3]
    container as process_pil_image fits them, zero padding past the extent.
    Returns (bytes written, seconds)."""
    from pocketflow_tpu_torch.tools import convert_ilsvrc12 as cv
    rng = np.random.default_rng(0)
    width = cv.container_width(RD_RESIZE)
    start, nbytes = time.perf_counter(), 0
    for subset, shard, nb in ([('train', i, RD_SHARD) for i in range(RD_SHARDS)]
                              + [('val', 0, RD_VAL)]):
        aspect = np.exp(rng.uniform(np.log(3 / 4), np.log(16 / 9), nb))  # w / h
        scale = np.minimum(RD_RESIZE, width / aspect)  # the frame's height in the container
        vh = np.clip(np.round(scale), 1, RD_RESIZE).astype(np.int32)
        vw = np.clip(np.round(scale * aspect), 1, width).astype(np.int32)
        images = rng.integers(0, 256, (nb, RD_RESIZE, width, 3), dtype=np.uint8)
        rows, cols = np.arange(RD_RESIZE), np.arange(width)
        images[(rows[None, :, None] >= vh[:, None, None])
               | (cols[None, None, :] >= vw[:, None, None])] = 0
        labels = rng.integers(1, 1001, nb).astype(np.int32)
        cv._flush(root, subset, shard, list(images), labels, list(zip(vh, vw)))
        nbytes += images.nbytes + labels.nbytes + 8 * nb
    return nbytes, time.perf_counter() - start


def rd_warm_cache(paths):
    """Read every file once, so that 25b reads from the page cache."""
    for path in paths:
        with open(path, 'rb') as fin:
            while fin.read(1 << 24):
                pass


def rd_loader_rate(FLAGS, shard_dir, native: bool):
    """(batches/s, GB/s) of the train set's iterator at batch BATCH."""
    from pocketflow_tpu_torch.datasets.ilsvrc12 import Ilsvrc12Dataset
    with FLAGS.scope(data_dir_local=shard_dir, batch_size=BATCH, enbl_native_loader=native,
                     synthetic_data=False):
        iterator = Ilsvrc12Dataset(is_train=True).build()
        batch = next(iterator)
        check(batch['label'].shape == (BATCH, 3) and batch['label'].dtype == np.float32,
              'full-frame label rows %s', batch['label'].shape)
        start = time.perf_counter()
        for _ in range(RD_LOADER_BATCHES):
            batch = next(iterator)
        seconds = time.perf_counter() - start
    nbytes = RD_LOADER_BATCHES * batch['image'].nbytes
    return RD_LOADER_BATCHES / seconds, nbytes / seconds / 1e9


class RdStepProbe:
    """`on_step` for run R0/R1: the host time from the start of step
    RD_TIMED_FROM to the start of the last step, synchronized at both edges
    only: RD_TIMED steps, each with the fetch of the next batch, after the
    profiler hook's window and the export of its trace."""

    def __init__(self):
        self.index, self.window_ms, self._t0 = 0, None, None

    def __call__(self, when, state):
        if when == 'after':
            self.index += 1
        elif self.index in (RD_TIMED_FROM, RD_TIMED_FROM + RD_TIMED):
            torch.cuda.synchronize()
            if self.index == RD_TIMED_FROM:
                self._t0 = time.perf_counter()
            else:
                self.window_ms = 1e3 * (time.perf_counter() - self._t0) / RD_TIMED


def rd_argv(root, name, data):
    """main.main's argv for runs R0/R1: the main path's settings (224, bf16,
    batch 256, exact BN, s2d stem, 4-bit per-tensor weights), RD_STEPS steps,
    the profiler hook over steps RD_PROF_START.., its files under root/name."""
    run_dir = os.path.join(root, name)
    return ['--model=resnet_at_ilsvrc12', '--resnet_size=50', '--learner=uniform',
            '--uql_weight_bits=4', '--uql_activation_bits=32', '--uql_quant_epochs=1',
            '--batch_size=%d' % BATCH, '--batch_size_eval=%d' % BATCH,
            '--nb_smpls_train=%d' % RD_TRAIN, '--nb_smpls_eval=%d' % RD_VAL,
            '--nb_epochs_rat=%r' % ((RD_STEPS + 0.5) * BATCH / RD_TRAIN),
            '--compute_dtype=bfloat16', '--bn_stats_subsample=1', '--resnet_stem_s2d',
            '--ilsvrc_augment=inception', '--rand_seed=0', '--summ_step=%d' % 10 ** 9,
            '--save_step=%d' % 10 ** 9, '--enbl_profiler',
            '--profiler_start_step=%d' % RD_PROF_START, '--profiler_nb_steps=%d' % RD_PROF_NB,
            '--log_dir=%s' % os.path.join(run_dir, 'logs'),
            '--save_path=%s' % os.path.join(run_dir, 'models', 'model.ckpt'),
            '--uql_save_quant_model_path=%s' % os.path.join(run_dir, 'uql', 'model.ckpt')] + data


class NativeSamplers:
    """Records the native samplers built while it is open: (file-backed?,
    image shape, label shape) each."""

    def __init__(self):
        from pocketflow_tpu_torch.datasets import native_loader
        self.made, self._module, self._cls = [], native_loader, native_loader.NativeSampler
        made, cls = self.made, self._cls

        class Recorded(cls):
            def __init__(self, images, labels, *args, **kwargs):
                super().__init__(images, labels, *args, **kwargs)
                made.append((not isinstance(images, np.ndarray), tuple(self.image_shape),
                             tuple(self.label_shape)))

        native_loader.NativeSampler = Recorded

    def close(self):
        self._module.NativeSampler = self._cls


def rd_train(FLAGS, root, label, data, card):
    """Run R0 or R1 through main.main: RD_STEPS QAT steps, one grouped K1'
    launch pair a quantized forward, the eval over the val set, the
    checkpoint; the host-clock window, the hook's trace (busy, idle, the
    crop-resize's device time), peak memory.  Returns (learner, counters,
    summary)."""
    from pocketflow_tpu_torch.tools.profile_step import trace_summary
    probe = RdStepProbe()
    samplers = NativeSamplers()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        learner, counter, counts, elapsed = run_main(
            FLAGS, root, 'resnet_at_ilsvrc12', data, probe,
            lambda work_dir, model, argv: rd_argv(work_dir, label, argv))
    finally:
        samplers.close()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loss, evals = float(counter.metrics['loss']), counter.evals[-1]
    check(counter.steps == RD_STEPS and learner.finetune_steps == RD_STEPS, '%s: %d steps',
          label, counter.steps)
    check(math.isfinite(loss) and all(math.isfinite(v) for v in evals.values()),
          '%s: loss %r, eval %s', label, loss, evals)
    nb_eval = -(-learner.dataset_eval.nb_smpls_loaded // BATCH)  # the eval's batches
    check(counts == no_launches(fake_quant_per_tensor_group=counter.forwards)
          and counter.forwards == RD_STEPS + nb_eval,
          '%s: launches %s over %d quantized forwards (%d steps, %d eval batches)', label,
          counts, counter.forwards, RD_STEPS, nb_eval)
    ckpt = os.path.join(root, label, 'uql', 'model.ckpt-%d.pt' % RD_STEPS)
    check(os.path.exists(ckpt), '%s: no checkpoint %s', label, ckpt)
    summary = trace_summary(learner.profile_path)
    check(summary['steps'] == list(range(RD_PROF_START, RD_TIMED_FROM))
          and summary.get('device_events', 0) > 0,
          '%s: the trace holds steps %s, %s device events', label, summary['steps'],
          summary.get('device_events'))
    nb = RD_PROF_NB
    summary.update(step_ms=probe.window_ms, peak_gib=peak, seconds=elapsed, loss=loss,
                   eval=evals, samplers=samplers.made, ckpt=ckpt,
                   busy_step_ms=summary['busy_ms'] / nb,
                   crop_step_ms=summary['spans'].get(CROP_SPAN, {}).get('device_ms', 0.0))
    log('  %s: %d steps, loss %.4f, eval %s | launches %s | %.2f ms a step over steps %d-%d '
        '(%.1f img/s, the next batch\'s fetch included; device busy %.1f%% of it) | the hook\'s '
        'trace of steps %d-%d (host ops recorded too): %.2f ms a step, device busy %.2f ms a '
        'step, idle %.1f%%, %.0f device events a step, crop-resize %.3f ms device a step | '
        'peak memory %.2f GiB | samplers %s | %.1f s | %s', label, counter.steps, loss,
        {k: round(v, 4) for k, v in evals.items()}, counts, probe.window_ms, RD_TIMED_FROM,
        RD_TIMED_FROM + RD_TIMED - 1, BATCH * 1e3 / probe.window_ms,
        100 * summary['busy_step_ms'] / probe.window_ms, RD_PROF_START, RD_TIMED_FROM - 1,
        summary['window_ms'] / nb, summary['busy_step_ms'], 100 * summary['idle_share'],
        summary['device_events'] / nb, summary['crop_step_ms'], peak,
        samplers.made, elapsed, card)
    return learner, counts, summary


def phase_real_data(FLAGS, card):
    """Phase 25: the real-data path on the card (25a-25f).  Returns {run
    label: counters}."""
    import shutil
    from pocketflow_tpu_torch.datasets import remote_fs
    from pocketflow_tpu_torch.tools.convert_ilsvrc12 import container_width
    runs = {}
    with tempfile.TemporaryDirectory(prefix='pf_real_') as root:
        shard_dir, val_dir = os.path.join(root, 'ilsvrc12'), os.path.join(root, 'remote', 'val')
        os.makedirs(shard_dir)
        os.makedirs(val_dir)
        nbytes, seconds = rd_write_shards(shard_dir)
        for name in os.listdir(shard_dir):  # the remote disk's directory holds the val set
            if name.startswith('val_'):
                os.link(os.path.join(shard_dir, name), os.path.join(val_dir, name))
        log('  25a shards: %d train x %d + %d val full-frame samples of %dx%dx3 uint8, %.3f GB '
            'in %.2f s (%.2f GB/s)', RD_SHARDS, RD_SHARD, RD_VAL, RD_RESIZE,
            container_width(RD_RESIZE), nbytes / 1e9, seconds, nbytes / 1e9 / seconds)

        rd_warm_cache([os.path.join(shard_dir, n) for n in sorted(os.listdir(shard_dir))])
        rates = {'native': rd_loader_rate(FLAGS, shard_dir, True),
                 'numpy': rd_loader_rate(FLAGS, shard_dir, False)}
        log('  25b loader alone, batch %d, warm page cache, %d batches: native sampler %.2f '
            'batches/s (%.2f GB/s); NumPy iterator (--enbl_native_loader=False) %.2f batches/s '
            '(%.2f GB/s) | %s', BATCH, RD_LOADER_BATCHES, *rates['native'], *rates['numpy'], card)

        # in turns, R0, R1, R1, R0: the step from disk beside the same step
        # on in-memory synthetic data, each twice, within one call
        synthetic = ['--synthetic_data', '--data_dir_local=']
        disk = ['--data_dir_local=%s' % shard_dir, '--synthetic_data=False']
        frame = (RD_RESIZE, container_width(RD_RESIZE), 3)
        r = {}
        for label, data in (('R0', synthetic), ('R1', disk), ('R1b', disk), ('R0b', synthetic)):
            learner, runs[RD_RUNS[label]], r[label] = rd_train(FLAGS, root, label, data, card)
            if data is disk:
                check(r[label]['samplers'] and all(
                    file_backed and image == frame and labels == (3,)
                    for file_backed, image, labels in r[label]['samplers']),
                    '%s read through %s', label, r[label]['samplers'])
        r0, r1 = r['R0'], r['R1']
        ms = {label: r[label]['step_ms'] for label in r}
        log('  25c R1 from disk %.1f, %.1f img/s against R0 on in-memory synthetic data %.1f, '
            '%.1f img/s (R0/R1 step time %.3f over both pairs); device busy %.2f, %.2f against '
            '%.2f, %.2f ms a step | %s', BATCH * 1e3 / ms['R1'], BATCH * 1e3 / ms['R1b'],
            BATCH * 1e3 / ms['R0'], BATCH * 1e3 / ms['R0b'],
            (ms['R0'] + ms['R0b']) / (ms['R1'] + ms['R1b']), r1['busy_step_ms'],
            r['R1b']['busy_step_ms'], r0['busy_step_ms'], r['R0b']['busy_step_ms'], card)

        # put_batch's pin and copy of one of R1's batches
        from pocketflow_tpu_torch.datasets.ilsvrc12 import Ilsvrc12Dataset
        with FLAGS.scope(data_dir_local=shard_dir, batch_size=BATCH, synthetic_data=False):
            batch = next(Ilsvrc12Dataset(is_train=True).build())
        learner.put_batch(batch)
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(RD_LOADER_BATCHES):
            learner.put_batch(batch)
        torch.cuda.synchronize()
        put_s = (time.perf_counter() - start) / RD_LOADER_BATCHES
        log('  25b put_batch (pin + copy to the card): %.2f ms a batch of %.1f MB (%.2f GB/s) | '
            '%s', 1e3 * put_s, batch['image'].nbytes / 1e6, batch['image'].nbytes / put_s / 1e9,
            card)
        del learner

        hdfs = ['--data_disk=hdfs', '--data_hdfs_host=file://%s' % os.path.join(root, 'remote'),
                '--data_dir_hdfs=val', '--data_cache_dir=%s' % os.path.join(root, 'cache')]
        with FLAGS.scope(**FLAGS.as_dict()):
            FLAGS.parse_args(hdfs)
            start = time.perf_counter()
            staged = remote_fs.resolve_data_dir()
            stage_s = time.perf_counter() - start
            mtime = os.path.getmtime(staged)
            remote_fs._RESOLVED.clear()
            start = time.perf_counter()
            check(remote_fs.resolve_data_dir() == staged and os.path.getmtime(staged) == mtime,
                  'a second resolve staged again')
            cached_s = time.perf_counter() - start
        remote_fs._RESOLVED.clear()
        eval_argv = hdfs + ['--exec_mode=eval', '--synthetic_data=False',
                            '--uql_save_quant_model_path=%s' % r1['ckpt'].rsplit('-', 1)[0]]
        learner, counter, counts, elapsed = run_main(
            FLAGS, root, 'resnet_at_ilsvrc12', eval_argv, None,
            lambda work_dir, model, argv: rd_argv(work_dir, 'R2', []) + argv)
        runs[RD_RUNS['R2']] = counts
        loss, want = counter.evals[-1]['loss'], r1['eval']['loss']
        check(sorted(os.listdir(staged)) == sorted(os.listdir(val_dir))
              and learner.dataset_eval.nb_smpls_loaded == RD_VAL,
              'R2 read %s', sorted(os.listdir(staged)))
        check(abs(loss - want) <= RD_EVAL_RTOL * abs(want), 'R2 eval loss %r, R1\'s %r', loss,
              want)
        check(counts == no_launches(fake_quant_per_tensor_group=RD_VAL // BATCH),
              'R2 launches %s', counts)
        log('  25d R2: staged %s in %.3f s; a second resolve %.4f s, nothing staged; eval of '
            'R1\'s checkpoint over the staged val shard: loss %.5f (R1\'s eval %.5f), %s | '
            '%.1f s | %s', staged, stage_s, cached_s, loss, want,
            {k: round(v, 4) for k, v in counter.evals[-1].items()}, elapsed, card)
        del learner
        shutil.rmtree(shard_dir)  # the ILSVRC-12 shards are done with
        torch.cuda.empty_cache()

        runs[RD_RUNS['R3']] = rd_ssd(FLAGS, root, card)
        runs[RD_RUNS['R4']] = rd_automl(FLAGS, root, card)
    return runs


def rd_ssd(FLAGS, root, card):
    """25e: SSD-300 full-prec through main.main on the VOC shards of the
    ported make_minimal_data, read through the native sampler."""
    from pocketflow_tpu_torch.tools import make_minimal_data
    start = time.perf_counter()
    make_minimal_data.main(['--dst_dir=%s' % root, '--datasets=pascalvoc',
                            '--nb_train=%d' % RD_SSD_TRAIN, '--nb_eval=%d' % RD_SSD_EVAL])
    write_s = time.perf_counter() - start
    voc = os.path.join(root, 'pascalvoc')
    samplers = NativeSamplers()
    torch.cuda.reset_peak_memory_stats()
    try:
        argv = det_argv(root, 'vgg_at_pascalvoc', [
            '--learner=full-prec', '--data_dir_local=%s' % voc, '--synthetic_data=False',
            '--nb_smpls_train=%d' % RD_SSD_TRAIN, '--nb_smpls_eval=%d' % RD_SSD_EVAL,
            '--nb_epochs_rat=%r' % ((RD_SSD_STEPS + 0.5) * DET_BATCH / (RD_SSD_TRAIN * 120))])
        learner, counter, counts, elapsed = run_main(FLAGS, root, 'vgg_at_pascalvoc', argv,
                                                     None, lambda w, m, a: a)
    finally:
        samplers.close()
    loss = float(counter.metrics['loss'])
    check(counter.steps == RD_SSD_STEPS and math.isfinite(loss), 'R3: %d steps, loss %r',
          counter.steps, loss)
    check(learner.dataset_train.nb_smpls_loaded == RD_SSD_TRAIN, 'R3 loaded %d',
          learner.dataset_train.nb_smpls_loaded)
    check(counts == no_launches(), 'R3 launches %s', counts)
    check(samplers.made and all(image == (RD_SSD_SIZE, RD_SSD_SIZE, 3) and len(labels) == 2
                                for _, image, labels in samplers.made),
          'R3 read through %s', samplers.made)
    log('  25e R3: VOC shards written in %.2f s; %d steps, loss %.4f, eval %s | samplers %s | '
        'peak memory %.2f GiB | %.1f s | %s', write_s, counter.steps, loss,
        {k: round(v, 4) for k, v in counter.evals[-1].items()}, samplers.made,
        torch.cuda.max_memory_allocated() / 2 ** 30, elapsed, card)
    return counts


def rd_automl(FLAGS, root, card):
    """25f: the AutoML CLI on the card: 2 GP trials (random proposals before
    the GP's warm-up) of the weight-sparsification learner on ResNet-20."""
    from pocketflow_tpu_torch.automl import cli
    out = os.path.join(root, 'automl', 'result.json')
    os.makedirs(os.path.dirname(out))
    argv = ['--model=resnet_at_cifar10', '--learner=weight-sparse', '--automl_algo=GP',
            '--automl_nb_trials=2', '--automl_output=%s' % out, '--synthetic_data',
            '--batch_size=%d' % ZOO_BATCH, '--batch_size_eval=%d' % ZOO_BATCH,
            '--nb_smpls_train=%d' % RD_AUTOML_TRAIN, '--nb_smpls_eval=%d' % RD_AUTOML_TRAIN,
            '--nb_epochs_rat=%r' % ((RD_AUTOML_STEPS + 0.5) * ZOO_BATCH / (RD_AUTOML_TRAIN * 250)),
            '--ws_prune_ratio_prtl=uniform', '--ws_prune_ratio=0.5', '--compute_dtype=bfloat16',
            '--summ_step=%d' % 10 ** 9, '--log_dir=%s' % os.path.join(root, 'automl', 'logs'),
            '--save_path=%s' % os.path.join(root, 'automl', 'models', 'model.ckpt'),
            '--ws_save_path=%s' % os.path.join(root, 'automl', 'ws', 'model.ckpt')]
    start = time.perf_counter()
    with FLAGS.scope(**FLAGS.as_dict()):
        reset_counters()
        best, best_obj, history, seconds = cli.main(argv, device='cuda')
        torch.cuda.synchronize()
        counts = counters()
    with open(out) as fin:
        result = json.load(fin)
    check(len(result['history']) == 2 and result['best_params'] == best
          and 0.0 <= best_obj <= 1.0, 'R4 result %s', result)
    check(counts == no_launches(), 'R4 launches %s', counts)
    log('  25f R4: trials %s s, objectives %s; best %.4f at %s | %.1f s | %s',
        [round(t, 2) for t in seconds], [round(o, 4) for _, o in history], best_obj,
        {k: round(v, 4) for k, v in result['best_params'].items()},
        time.perf_counter() - start, card)
    return counts


def phase_export(FLAGS, work_dir, card, device):
    """Phase 26: the deployment export on the card.  26a: run K's uniform-tf
    MobileNet-v1 through build_qat_deploy_forward, its fold one grouped K2'
    launch pair and no plain call, every folded kernel bit-equal to the CPU's
    plain version and to the per-site op on the card; the deploy forward
    against the QAT reference forward (fp32, no TF32) at batch MB_BATCH,
    each timed.  26b: the TF lowering's stage 1 on the deploy forward and on
    ResNet-50 with the s2d stem at 224, every ATen node lowered, the op
    counts by kind.  26c: the conversion, where TensorFlow is installed.
    Returns {DEPLOY_FOLD_RUN: counters}."""
    import importlib.util
    from pocketflow_tpu_torch.core import checkpoint as ckpt_lib
    from pocketflow_tpu_torch.learners.uniform_quantization import utils as uq
    from pocketflow_tpu_torch.nets.mobilenet_at_ilsvrc12 import ModelHelper as MbHelper
    from pocketflow_tpu_torch.nets.resnet_at_ilsvrc12 import ModelHelper as RnHelper
    from pocketflow_tpu_torch.ops import fake_quant as fq
    from pocketflow_tpu_torch.tools import export_tflite, tf_lowering
    ckpt = os.path.join(work_dir, 'mobilenet', 'K', 'uqtf', 'model.ckpt')
    with FLAGS.scope(compute_dtype='float32', mobilenet_version=1, mobilenet_depth_mult=1.0,
                     batch_size=MB_BATCH, batch_size_eval=MB_BATCH):
        helper = MbHelper()
        model = helper.create_model().to(device).eval()
        payload = ckpt_lib.restore_latest(ckpt, map_location=device)
        check(payload is not None, 'no run K checkpoint under %s', ckpt)
        model.load_state_dict(payload['model'])
        ds = helper.build_dataset_eval()
        images = ds.augment(torch.from_numpy(ds.synthesize_arrays(MB_BATCH)[0][:MB_BATCH]).to(
            device), None, False)
        with FLAGS.scope(uql_quantize_all_layers=True):
            stats = uq.discover_quant_sites(model, images[:2])
    paths = stats['weight_paths']
    check((len(paths), stats['nb_activations']) == MB_SITES[1], 'run K sites %d/%d', len(paths),
          stats['nb_activations'])
    spec = {'weight_paths': paths, 'act_min': payload['extra']['act_min'].cpu().numpy(),
            'act_max': payload['extra']['act_max'].cpu().numpy(), 'weight_bits': 8,
            'act_bits': 8}

    torch.cuda.synchronize()
    reset_counters()  # the deploy fold's launches are counted from here ...
    deploy, qat_ref = export_tflite.build_qat_deploy_forward(model, None, spec)
    torch.cuda.synchronize()
    counts = counters()  # ... to here
    check(counts == no_launches(fake_quant_per_column_group=1), 'deploy fold launches %s',
          counts)
    kernels = uq.quant_weights(model, paths)
    folded = uq.quant_weights(deploy.model, paths)
    bits8 = torch.tensor(8.0, device=device)
    k8 = fq._levels(torch.tensor(8.0))
    for path, w, got in zip(paths, kernels, folded):
        check(torch.equal(got.detach().cpu(), fq._column_plain(w.detach().cpu(), k8, None)),
              'folded %s differs from the CPU plain version', path)
        check(torch.equal(got, fq.fake_quant_channel_bucket(w.detach(), bits8)),
              'folded %s differs from the per-site op on the card', path)
    bits = torch.full((len(paths),), 8.0, device=device)
    weights = [w.detach() for w in kernels]
    fold_ms = time_ms(lambda: fq.fake_quant_bucket_group(weights, bits, 'channel', 0,
                                                         select=False))
    per_site_ms = time_ms(lambda: [fq.fake_quant_channel_bucket(w, bits8) for w in weights])
    bound_ms, bound_by = fq_bound(sum(w.numel() for w in weights))
    log('  26a deploy fold of run K\'s %d kernels: one grouped K2\' launch pair, no plain call '
        '(%s); every kernel bit-equal to the CPU plain version and to the per-site op on the '
        'card | grouped %.4f ms (%.0f%% of the bound), %d per-site calls %.4f ms, bound %.4f ms '
        '(%s) | %s', len(paths), counts, fold_ms, 100 * bound_ms / fold_ms, len(paths),
        per_site_ms, bound_ms, bound_by, card)
    with torch.no_grad(), export_tflite._fp32_reference(device):
        out_deploy, out_ref, out_float = deploy(images), qat_ref(images), model(images)
        deploy_ms = time_ms(lambda: deploy(images), 5)
        ref_ms = time_ms(lambda: qat_ref(images), 5)
    check(float(out_ref.abs().max()) > 0, 'the QAT reference forward gives all-zero logits')
    rel = float((out_deploy - out_ref).abs().max() / out_ref.abs().max())
    rel_float = float((out_float - out_ref).abs().max() / out_ref.abs().max())
    agree = float((out_deploy.argmax(-1) == out_ref.argmax(-1)).float().mean())
    check(bool(torch.isfinite(out_deploy).all()) and out_deploy.shape == (MB_BATCH, 1001),
          'deploy forward %s', tuple(out_deploy.shape))
    log('  26a deploy forward (folded kernels, activations clipped at run K\'s ranges) against '
        'the QAT reference forward (RangeQuantPolicy), fp32 without TF32, batch %d: max|d| / '
        'max|ref| %.4g (the float forward\'s %.4g; max|ref| %.4g), top-1 agreement %.4f | '
        'deploy %.3f ms, reference %.3f ms a forward | %s', MB_BATCH, rel, rel_float,
        float(out_ref.abs().max()), agree, deploy_ms, ref_ms, card)

    with FLAGS.scope(compute_dtype='float32'):
        resnet = RnHelper(resnet_size=50).create_model()
    resnet.reset_parameters(torch.Generator().manual_seed(0))
    resnet = resnet.to(device)
    for name, net in (('MobileNet-v1 deploy forward', deploy), ('ResNet-50 (s2d stem)', resnet)):
        start = time.perf_counter()
        plan = tf_lowering.lower(net, (1, 224, 224, 3))
        check(plan.counts() == EXPORT_PLANS[name], '%s plan %s', name, plan.counts())
        log('  26b TF lowering (stage 1) of the %s at 224, batch 1: all %d ATen nodes lowered to '
            '%d ops %s in %.1f s', name, plan.nb_nodes, len(plan.ops), plan.counts(),
            time.perf_counter() - start)
    del resnet

    if importlib.util.find_spec('tensorflow') is None:
        log('  26c TensorFlow is absent on this machine: no .tflite is converted here; '
            'tests/test_torch_export_tflite.py holds the conversion on the CPU')
    else:
        with tempfile.TemporaryDirectory(prefix='pf_tflite_') as out_dir:
            start = time.perf_counter()
            path = export_tflite.export_tflite(model, None, images[:1], os.path.join(
                out_dir, 'mobilenet_qat'), quantize='int8', qat_spec=spec)
            log('  26c int8-qat .tflite of run K\'s MobileNet-v1: %d bytes in %.1f s',
                os.path.getsize(path), time.perf_counter() - start)
    torch.cuda.empty_cache()
    return {DEPLOY_FOLD_RUN: counts}


def remat_steps(learner, base, tx, step, batch, label_modes, extra=None):
    """One train step from `base` on `batch` for each (label, mode), each
    model built under its --remat_blocks mode: {label: (the state after it,
    cloned; its launches; its peak memory in GiB)}."""
    from pocketflow_tpu_torch.experiments import step_remat as sr
    out = {}
    for label, mode in label_modes:
        state = sr.state_under(learner, base, tx, mode, extra)
        reset_counters()  # this step's launches are counted from here ...
        state, peak, _ = sr.peak_step(learner, state, step, batch)
        out[label] = (sr.snapshot(state), counters(), peak / 2 ** 30)  # ... to here
        del state
    return out


def differing(got, want) -> list:
    """The keys of the tensors of `got` that are not bit-equal to `want`'s."""
    return [key for key in want if not torch.equal(got[key], want[key])]


def tensor_leaves(tree, prefix=''):
    """{path: tensor} of a nested checkpoint payload."""
    if torch.is_tensor(tree):
        return {prefix: tree}
    out = {}
    items = tree.items() if isinstance(tree, dict) else (
        enumerate(tree) if isinstance(tree, (list, tuple)) else ())
    for key, value in items:
        out.update(tensor_leaves(value, '%s/%s' % (prefix, key)))
    return out


def phase_remat_resnet(FLAGS, card):
    """27a-27c: the main path's QAT ResNet-50 step under each mode.  27a: one
    step of each mode from one seeded state on one batch with
    cudnn.deterministic, 'none' twice: parameters, momentum and BN running
    statistics bit-identical, one grouped K1' launch pair and no plain call
    a step in every mode; then 'none' twice and 'full' without the setting,
    printed.  27b: the same at 8-bit activations: K1' with the select at the
    49 sites of the forward, and again at the 48 inside the blocks under
    'save_convs' and 'full'.  27c: each mode's peak memory and step time in
    turns (experiments/step_remat.run), then 'none' and 'full' at
    REMAT_BIG_BATCH.  Returns {run label: counters}."""
    from pocketflow_tpu_torch.experiments import step_remat as sr
    from pocketflow_tpu_torch.learners.uniform_quantization import utils as uq_utils
    runs = {}
    with FLAGS.scope(**sr.settings(BATCH), uql_activation_bits=32):
        start = time.perf_counter()
        built = sr.build_learner()
        learner, base, tx, step, batch = built
        check(learner.statistics['nb_activations'] == NB_ACT_SITES, 'sites %s',
              learner.statistics['nb_activations'])
        log('  set-up (learner, seeded state, one batch) %.1f s', time.perf_counter() - start)
        for bits, run_label, per_site in ((32, REMAT_RUN, 0), (8, REMAT_ACT8_RUN, 1)):
            with FLAGS.scope(uql_activation_bits=bits):
                extra = uq_utils.bits_state(learner.statistics, device=learner.device)
                torch.backends.cudnn.deterministic = True
                try:
                    got = remat_steps(learner, base, tx, step, batch,
                                      [('none', 'none'), ('none#2', 'none')]
                                      + [(mode, mode) for mode in REMAT_MODES[1:]], extra)
                finally:
                    torch.backends.cudnn.deterministic = False
            want = got['none'][0]
            check(differing(got['none#2'][0], want) == [],
                  '%d-bit activations: two \'none\' steps differ under cudnn.deterministic in %s',
                  bits, differing(got['none#2'][0], want)[:5])
            for label, (snap, counts, peak) in got.items():
                check(differing(snap, want) == [], '%s differs from \'none\' in %s',
                      run_label % label, differing(snap, want)[:5])
                sites = per_site * (NB_ACT_SITES + (REMAT_BLOCK_SITES if label in REMAT_MODES[1:]
                                                    else 0))
                check(counts == no_launches(fake_quant_per_tensor_group=1,
                                            fake_quant_per_tensor=sites,
                                            fake_quant_per_tensor_select=sites),
                      '%s: launches %s', run_label % label, counts)
                if label != 'none#2':
                    runs[run_label % label] = counts
                log('  %s: bit-identical to \'none\' (%d tensors: parameters, BN statistics, '
                    'momentum; cudnn.deterministic) | launches %s | peak %.2f GiB',
                    run_label % label, len(want), {k: v for k, v in counts.items() if v}, peak)
            del got, want
        got = remat_steps(learner, base, tx, step, batch,
                          [('none', 'none'), ('none#2', 'none'), ('full', 'full')])
        log('  27a without cudnn.deterministic: \'none\' twice bit-identical: %s (%d tensors '
            'differ); \'full\' against \'none\' bit-identical: %s (%d differ)',
            not differing(got['none#2'][0], got['none'][0]),
            len(differing(got['none#2'][0], got['none'][0])),
            not differing(got['full'][0], got['none'][0]),
            len(differing(got['full'][0], got['none'][0])))
        del got
        torch.cuda.empty_cache()

        out = sr.run(REMAT_MODES, REMAT_WINDOWS, REMAT_STEPS, built, REMAT_PROFILED)
        for mode, row in out.items():
            log('  27c %s at batch %d: %.2f ms a step (median of %d windows of %d steps in turns: '
                '%s), %.1f img/s, %+.1f%% against none | device busy %.2f ms a step, idle '
                '%.1f%%, %d events a step (%d steps profiled) | peak %.2f GiB (%.2f above the '
                '%.2f allocated before the step) | %s', mode, BATCH, row['median_ms'],
                REMAT_WINDOWS, REMAT_STEPS, ['%.2f' % t for t in row['ms']], row['img_s'],
                100 * (row['median_ms'] / out['none']['median_ms'] - 1),
                row['device']['busy_ms_per_step'], 100 * row['device']['idle_share'],
                row['device']['device_events_per_step'], REMAT_PROFILED, row['peak_gib'],
                row['step_gib'], row['allocated_before_gib'], card)
            check(all(math.isfinite(t) for t in row['ms']), '%s times %s', mode, row['ms'])
        check(out['full']['step_gib'] < out['save_convs']['step_gib'] < out['none']['step_gib'],
              'peak memory above the step\'s start: none %.2f, save_convs %.2f, full %.2f GiB',
              *(out[m]['step_gib'] for m in REMAT_MODES))
        torch.cuda.empty_cache()
        iterator = learner.dataset_train.build()
        parts = [learner.put_batch(next(iterator)) for _ in range(REMAT_BIG_BATCH // BATCH)]
        big = {key: torch.cat([p[key] for p in parts]) for key in parts[0]}
        del parts
        out = sr.run(('none', 'full'), 1, REMAT_BIG_STEPS, (learner, base, tx, step, big))
        for mode, row in out.items():
            log('  27c %s at batch %d: %.2f ms a step (%d steps), %.1f img/s | peak %.2f GiB '
                '(%.2f above the %.2f allocated before the step) | %s', mode, REMAT_BIG_BATCH,
                row['median_ms'], REMAT_BIG_STEPS, row['img_s'], row['peak_gib'],
                row['step_gib'], row['allocated_before_gib'], card)
        check(out['full']['step_gib'] < out['none']['step_gib'], 'batch %d: full %.2f GiB, none '
              '%.2f GiB', REMAT_BIG_BATCH, out['full']['step_gib'], out['none']['step_gib'])
        del big, built, learner, base, tx, step, batch
    torch.cuda.empty_cache()
    return runs


def phase_remat_others(FLAGS, work_dir, card, device):
    """27d: MobileNet-v1 uniform-tf at 224, batch MB_BATCH, through main.main
    under 'none' and 'save_convs' with cudnn.deterministic: the same
    checkpoint (parameters, BN statistics, momentum, the EMA'd act_min and
    act_max) and the same launches, one grouped K2' launch pair a forward for
    the 28 weights.  27e: Faster R-CNN ResNet-50 at 300x300, batch
    DET_BATCH, one full-prec step under 'none' and 'full': the peak memory
    of each, lower under 'full'.  Returns {run label: counters}."""
    from pocketflow_tpu_torch.core import checkpoint as ckpt_lib
    from pocketflow_tpu_torch.experiments import step_remat as sr
    from pocketflow_tpu_torch.learners.full_precision import FullPrecLearner
    from pocketflow_tpu_torch.nets.faster_rcnn_at_pascalvoc import ModelHelper as FrcnnHelper
    runs, payloads = {}, {}
    torch.backends.cudnn.deterministic = True
    try:
        for label, mode in REMAT_MB_RUNS:
            _, counter, counts, elapsed, peak = run_mobilenet(
                FLAGS, work_dir, label, 1, ['--learner=uniform-tf', '--uqtf_quant_delay=0',
                                            '--remat_blocks=%s' % mode], REMAT_MB_STEPS)
            runs[label] = counts
            nb_eval = counter.forwards - counter.steps
            check(counts == no_launches(fake_quant_per_column_group=REMAT_MB_STEPS + nb_eval),
                  '%s: launches %s (%d eval forwards)', label, counts, nb_eval)
            run_dir = os.path.join(work_dir, 'mobilenet', label.split(':')[0].split()[-1])
            payload = ckpt_lib.restore_latest(os.path.join(run_dir, 'uqtf', 'model.ckpt'),
                                              map_location=device)
            check(payload is not None and payload['step'] == REMAT_MB_STEPS, '%s: checkpoint',
                  label)
            payloads[mode] = tensor_leaves(payload)
            log('  %s: loss %.4f | launches %s | peak %.2f GiB | %.1f s (the run, its eval and '
                'its checkpoint)', label, float(counter.metrics['loss']),
                {k: v for k, v in counts.items() if v}, peak, elapsed)
    finally:
        torch.backends.cudnn.deterministic = False
    want = payloads['none']
    check(set(payloads['save_convs']) == set(want) and any('act_max' in k for k in want),
          '27d: checkpoint keys differ')
    check(differing(payloads['save_convs'], want) == [], '27d: save_convs\' checkpoint differs '
          'in %s', differing(payloads['save_convs'], want)[:5])
    log('  27d: the two checkpoints bit-identical (%d tensors: parameters, BN statistics, '
        'momentum, act_min, act_max)', len(want))
    del payloads, want
    torch.cuda.empty_cache()

    with FLAGS.scope(frcnn_backbone='resnet50', lrn_rate_init=0.01, batch_size=DET_BATCH,
                     batch_size_eval=DET_BATCH, nb_smpls_train=2 * DET_BATCH,
                     nb_smpls_eval=DET_BATCH, compute_dtype='bfloat16', remat_blocks='none'):
        learner = FullPrecLearner(None, FrcnnHelper(), device=device)
        base, tx, _ = learner.init_state()
        step = learner.build_train_step(tx)
        batch = learner.put_batch(next(learner.dataset_train.build()))
        peaks, snaps = {}, {}
        for mode in ('none', 'full'):
            torch.cuda.empty_cache()
            state = sr.state_under(learner, base, tx, mode)
            blocks = [m.remat for m in state.model.modules() if hasattr(m, 'remat')]
            check(len(blocks) == 13 and set(blocks) == {mode}, '27e: trunk blocks %s', blocks)
            state, peak, start = sr.peak_step(learner, state, step, batch)
            peaks[mode] = ((peak - start) / 2 ** 30, peak / 2 ** 30)
            snaps[mode] = sr.snapshot(state)
            del state
        delta = max(float((snaps['full'][k].float() - snaps['none'][k].float()).abs().max())
                    for k in snaps['none'])
        log('  27e Faster R-CNN ResNet-50 at 300x300, batch %d, one full-prec step: peak %.2f GiB '
            '(%.2f above the step\'s start) under none, %.2f GiB (%.2f) under full; after the '
            'step max|full - none| %.3g (%d of %d tensors differ) | %s', DET_BATCH,
            peaks['none'][1], peaks['none'][0], peaks['full'][1], peaks['full'][0], delta,
            len(differing(snaps['full'], snaps['none'])), len(snaps['none']), card)
        check(peaks['full'][0] < peaks['none'][0], '27e: full %.2f GiB, none %.2f GiB',
              peaks['full'][0], peaks['none'][0])
        del learner, base, tx, step, batch, snaps
    torch.cuda.empty_cache()
    return runs


def phase_parity(FLAGS, work_dir, card):
    """Phase 28 (see PARITY_RUN_*): 28a and 28b through the harness's public
    functions, each counted in a ForwardCounter from a reset just before it;
    28c the width-mapped detector card vs CPU.  Returns {run label:
    counters}."""
    from pocketflow_tpu_torch.experiments import composed_cp_qat, synthetic_parity
    runs = {}
    start = time.perf_counter()
    counter = ForwardCounter()
    try:
        with FLAGS.scope(**FLAGS.as_dict()):
            reset_counters()
            out = synthetic_parity.run_sweep(os.path.join(work_dir, 'parity'), quick=True,
                                             points=('uniform@4bit',))
            torch.cuda.synchronize()
            runs[PARITY_RUN_UQ] = counts = counters()
    finally:
        counter.close()
    check(counts == no_launches(fake_quant_per_column_group=counter.forwards)
          and counter.forwards > 0,
          '28a: launches %s over %d quantized forwards (%d steps)', counts, counter.forwards,
          counter.steps)
    check(out['full-prec'] > PARITY_MIN_BASELINE, '28a: baseline %.4f at chance',
          out['full-prec'])
    check(all(math.isfinite(out[k]) for k in ('full-prec', 'uniform@4bit')), '28a: %s', out)
    log('  28a %s: full-prec %.4f, uniform@4bit %.4f (delta %.4f; band %.2f), chance %.4f | '
        '%d quantized forwards (%d steps), launches %s | %.1f s | %s', PARITY_RUN_UQ,
        out['full-prec'], out['uniform@4bit'], out['uniform@4bit_delta'],
        synthetic_parity.LOCKED_MAX_DELTA['uniform@4bit'], 1 / 64, counter.forwards,
        counter.steps, {k: v for k, v in counts.items() if v}, time.perf_counter() - start,
        card)

    start = time.perf_counter()
    counter = ForwardCounter()
    try:
        with FLAGS.scope(**FLAGS.as_dict()):
            reset_counters()
            out = composed_cp_qat.run(os.path.join(work_dir, 'parity_cp'), quick=True)
            torch.cuda.synchronize()
            runs[PARITY_RUN_CP] = counts = counters()
    finally:
        counter.close()
    sites = 19  # ResNet-20's activation sites, each at 8 bits
    check(counts == no_launches(fake_quant_per_tensor_group=counter.forwards,
                                fake_quant_per_tensor=sites * counter.forwards,
                                fake_quant_per_tensor_select=sites * counter.forwards)
          and counter.forwards > 0, '28b: launches %s over %d quantized forwards', counts,
          counter.forwards)
    check(composed_cp_qat.check_results(out) == [], '28b: %s', composed_cp_qat.check_results(out))
    check(out['pruned_channel_frac'] >= 0.3, '28b: pruned %.4f', out['pruned_channel_frac'])
    log('  28b %s: full-prec %.4f, channel@50%%+sched %.4f, cp+qat@8bit %.4f; pruned input '
        'channels %.4f before QAT, %.4f after; packed %.4f of the dense parameters | %d '
        'quantized forwards, launches %s | %.1f s | %s', PARITY_RUN_CP, out['full-prec'],
        out['channel@50%+sched'], out['cp+qat@8bit'], out['pruned_channel_frac'],
        out['pruned_channel_frac_after_qat'], out['packed_param_frac'], counter.forwards,
        {k: v for k, v in counts.items() if v}, time.perf_counter() - start, card)

    start = time.perf_counter()
    from pocketflow_tpu_torch.datasets.pascalvoc import PascalVocDataset
    from pocketflow_tpu_torch.nets import faster_rcnn_at_pascalvoc as frcnn
    from pocketflow_tpu_torch.nn.layers import BatchNorm
    with FLAGS.scope(**DET_SMALL, frcnn_backbone='resnet50'):
        helper = frcnn.ModelHelper()
        dense = helper.create_model()
        mapped = dense.clone(width_map=PARITY_FRCNN_MAP)
        mapped.reset_parameters(torch.Generator().manual_seed(0))
        ds = PascalVocDataset(False)
        images = torch.from_numpy(ds.synthesize_detection_arrays(64)[0][:DET_SMALL['batch_size']])
        images = ds.augment(images, None, False)
        # BN statistics set to the batch's (a train-mode forward at momentum 0),
        # so that the eval forward stays at unit scale through the trunk
        bns = [m for m in mapped.modules() if isinstance(m, BatchNorm)]
        for bn in bns:
            bn.momentum = 0.0
        with torch.no_grad():
            mapped.train()(images)
        for bn in bns:
            bn.momentum = 0.997
        kernels = dict(mapped.named_parameters())
        check(kernels['backbone.stage1_block0.conv1.kernel'].shape[-1] == 32
              and kernels['backbone.stage2_block3.conv2.kernel'].shape[-1] == 64
              and kernels['backbone.stage3_block0.conv1.kernel'].shape[-1] == 256,
              '28c: widths %s', {k: tuple(v.shape) for k, v in kernels.items()
                                 if k.endswith('conv1.kernel')})
        nb_dense = sum(p.numel() for p in dense.parameters())
        nb_mapped = sum(p.numel() for p in kernels.values())
        outs = {}
        for device in ('cuda', 'cpu'):
            model = copy.deepcopy(mapped).to(device).eval()
            with torch.no_grad():
                got = helper.forward_eval(model, images.to(device))
                got['c3'], got['c4'] = model.backbone(images.to(device))
            outs[device] = {k: v.detach().cpu() for k, v in got.items()}
    # the trunk (where the map applies) and the RPN's dense outputs; the
    # proposals and the heads behind them follow a top-k, whose near-ties at
    # a random init may order differently on the two devices
    errs = {}
    for key in ('c3', 'c4', 'obj_logits', 'rpn_deltas'):
        largest = float(outs['cpu'][key].abs().max())
        errs[key] = (float((outs['cuda'][key] - outs['cpu'][key]).abs().max()), largest)
        check(errs[key][0] <= 1e-3 + 1e-3 * largest, '28c: %s card vs CPU %.3g (of %.3g)', key,
              *errs[key])
    check(outs['cuda']['c4'].shape[1] == 1024 and outs['cuda']['cls_logits'].shape[-1] == 21,
          '28c: shapes %s', {k: tuple(v.shape) for k, v in outs['cuda'].items()})
    same = (outs['cuda']['proposals'] - outs['cpu']['proposals']).abs().amax(-1) <= 1e-3
    log('  28c width-mapped Faster R-CNN ResNet-50 (%d of %d parameters), eval forward at '
        '64x64, batch %d: card vs CPU max|d| (of the largest) %s; proposals within 1e-3 %d of '
        '%d, valid %d / %d | %.1f s', nb_mapped, nb_dense, DET_SMALL['batch_size'],
        {k: '%.3g (%.3g)' % v for k, v in errs.items()}, int(same.sum()), same.numel(),
        int(outs['cuda']['proposal_valid'].sum()), int(outs['cpu']['proposal_valid'].sum()),
        time.perf_counter() - start)
    return runs


def det_parity_line(out, key):
    """A strip point's figures as one log fragment."""
    return '%s mAP %.4f, %d steps at %.2f ms (train call), eval %s s' % (
        key, out[key + '_mAP'], out['_steps'][key], out['_ms_per_step'][key],
        out['_eval_seconds'][key])


def phase_det_parity(FLAGS, work_dir, card):
    """Phase 29 (see DET_PARITY_RUN_*): each strip through its public
    run_strip, counted in a ForwardCounter from a reset just before it.
    Returns {run label: counters}."""
    from pocketflow_tpu_torch.experiments import detection_parity, frcnn_compression_parity
    runs = {}
    start = time.perf_counter()
    counter = ForwardCounter()
    try:
        with FLAGS.scope(**FLAGS.as_dict()):
            reset_counters()
            out = detection_parity.run_strip(os.path.join(work_dir, 'det_parity'), quick=True,
                                             only={'baseline', 'uq'})
            torch.cuda.synchronize()
            runs[DET_PARITY_RUN_SSD] = counts = counters()
    finally:
        counter.close()
    check(counts == no_launches(fake_quant_per_column_group=counter.forwards)
          and counter.forwards > out['_steps']['uniform@8bit'] > 0,
          '29a: launches %s over %d quantized forwards (%d steps)', counts, counter.forwards,
          counter.steps)
    check(detection_parity.check_results(out) == [] and out['_quick']
          and all(math.isfinite(out[k + '_mAP']) for k in ('full-prec', 'uniform@8bit')),
          '29a: %s', out)
    log('  29a %s: %s; %s (delta %.4f; band %.2f) | %d quantized forwards (%d steps), launches '
        '%s | %.1f s | %s', DET_PARITY_RUN_SSD, det_parity_line(out, 'full-prec'),
        det_parity_line(out, 'uniform@8bit'), out['uniform@8bit_delta'],
        detection_parity.LOCKED_MAX_DELTA['uniform@8bit'], counter.forwards, counter.steps,
        {k: v for k, v in counts.items() if v}, time.perf_counter() - start, card)

    start = time.perf_counter()
    with FLAGS.scope(**FLAGS.as_dict()):
        reset_counters()
        out = frcnn_compression_parity.run_strip(os.path.join(work_dir, 'frcnn_parity'),
                                                 quick=True, points=())
        torch.cuda.synchronize()
        runs[DET_PARITY_RUN_FRCNN] = counts = counters()
    check(counts == no_launches() and out['_steps']['full-prec'] == 16
          and math.isfinite(out['full-prec_mAP']), '29b: launches %s, %s', counts, out)
    log('  29b %s: %s | %.1f s | %s', DET_PARITY_RUN_FRCNN, det_parity_line(out, 'full-prec'),
        time.perf_counter() - start, card)
    return runs


def phase_root_experiments(FLAGS, work_dir, card):
    """Phase 30 (see ROOT_RUN_*): the root experiments through their public
    run functions, each counted from a reset just before it.  Returns {run
    label: counters}."""
    from pocketflow_tpu_torch.experiments import (
        amc_mobilenet_onchip, int8_serving_speed, shrunk_serving_latency, uqtf_phases)
    from pocketflow_tpu_torch.ops import matmul as mm
    runs = {}
    start = time.perf_counter()
    with FLAGS.scope(**FLAGS.as_dict()):
        reset_counters()
        out = uqtf_phases.run(batch=BATCH, warm=ROOT_WARM, reps=ROOT_TIMED)
        torch.cuda.synchronize()
        # the script counts each phase's fake-quant calls from its own reset:
        # the run's counters are their sum and the matmul kernels' since ours
        total = no_launches(**mm.counters())
    phases = out['phases']
    steps = ROOT_WARM + ROOT_TIMED
    for ph in phases.values():
        for name, value in ph['launches'].items():
            total[name] += value
    runs[ROOT_RUN_UQTF] = total
    check(phases[uqtf_phases.PHASES[0]]['launches'] == {}, '30a: warm-up launches %s',
          phases[uqtf_phases.PHASES[0]]['launches'])
    for name in uqtf_phases.PHASES[1:]:
        check(phases[name]['launches'] == {'fake_quant_per_column_group': steps},
              '30a: %s launches %s over %d steps', name, phases[name]['launches'], steps)
    check(total == no_launches(fake_quant_per_column_group=2 * steps),
          '30a: launches %s', total)
    log('  30a %s: %s | %.1f s | %s', ROOT_RUN_UQTF, '; '.join(
        '%s %.2f ms a step (%.0f img/s), launches %s' % (name, ph['ms'], ph['img_s'],
                                                        ph['launches'] or 'none')
        for name, ph in phases.items()), time.perf_counter() - start, card)

    start = time.perf_counter()
    with FLAGS.scope(**FLAGS.as_dict()):
        reset_counters()
        served = int8_serving_speed.run(nb_warmup=ROOT_SERVE_WARMUP, nb_timed=ROOT_SERVE_TIMED)
        shrunk = shrunk_serving_latency.run(nb_timed=ROOT_SERVE_TIMED)
        torch.cuda.synchronize()
        runs[ROOT_RUN_SERVE] = counts = counters()
    # one int8_conv launch a site a forward: ResNet-50 in the default mode,
    # MobileNet-v1 in both (13 depthwise sites on the plain route when quantized)
    forwards = ROOT_SERVE_WARMUP + 1 + ROOT_SERVE_TIMED
    check(counts == no_launches(
        int8_conv=forwards * (INT8_SITES['resnet50'] + 2 * INT8_SITES['mobilenet_v1']),
        int8_depthwise=forwards * 13), '30b: launches %s', counts)
    for model in ('resnet50', 'mobilenet_v1'):
        check(all(math.isfinite(v) and v > 0 for v in served[model].values()), '30b: %s %s',
              model, served[model])
    check(shrunk['logits_max_delta'] <= SHRUNK_BF16_TOL * shrunk['logits_max']
          and shrunk['params_shrunk'] < 0.3 * shrunk['params_dense'],
          '30b: shrunk %s', shrunk)
    log('  30b %s: int8 serving (ms a batch, %d after %d) %s, band %s; shrunk ResNet-50 '
        '%.1fM -> %.1fM parameters, logits max |d| %.3g of %.3g, dense %.3f ms, shrunk %.3f ms '
        '(%.2fx) | %.1f s | %s', ROOT_RUN_SERVE, ROOT_SERVE_TIMED, ROOT_SERVE_WARMUP,
        {m: served[m] for m in ('resnet50', 'mobilenet_v1')},
        int8_serving_speed.check_results(served) or 'held', shrunk['params_dense'] / 1e6,
        shrunk['params_shrunk'] / 1e6, shrunk['logits_max_delta'], shrunk['logits_max'],
        shrunk['dense_ms'], shrunk['shrunk_ms'], shrunk['speedup'],
        time.perf_counter() - start, card)

    start = time.perf_counter()
    with FLAGS.scope(**FLAGS.as_dict()):
        reset_counters()
        drill = amc_mobilenet_onchip.run(ROOT_DRILL_RLOUTS, ROOT_DRILL_WARM,
                                         workdir=os.path.join(work_dir, 'amc_drill'))
        torch.cuda.synchronize()
        runs[ROOT_RUN_DRILL] = counts = counters()
    check(counts == no_launches() and len(drill['reward_trace']) == ROOT_DRILL_RLOUTS
          and drill['preserved_flops_frac'] <= 0.5 + 1e-6 and drill['image_size'] == 224,
          '30c: launches %s, %s', counts, drill)
    log('  30c %s: baseline %.4f (train batches), rewards %s, preserved FLOPs %.4f, warm-up '
        '%.1f s, search %.1f s | %.1f s | %s', ROOT_RUN_DRILL, drill['baseline_accuracy'],
        drill['reward_trace'], drill['preserved_flops_frac'], drill['_seconds']['warm'],
        drill['wall_s'], time.perf_counter() - start, card)
    return runs


# ---------------------------------------------------------------------------
# phase 31: tensor parallelism
# ---------------------------------------------------------------------------

def phase_tp_kernel(fq, weight_shapes, device, card):
    """Phase 31a: the split grouped K1' (pass 1 into a [T, 2] buffer of
    (-min, max), the MAX all-reduce over the model group, pass 2 from it) at
    the main path's 52 weight shapes, at model size 1: bit-equal to the
    fused grouped K1' and to the plain version on the card (torch.aminmax,
    _quantize_in_range), at 4 bits and at mixed bits 2/4/8/32; pass 1's
    buffer against each tensor's (-min, max); pass 2 from wider ranges
    against the plain version from them; then timed beside the fused route
    and the bound."""
    gen = torch.Generator(device=device).manual_seed(31)
    xs = [torch.randn(shape, generator=gen, device=device) * 0.05 for shape in weight_shapes]
    mixed = [float((2, 4, 8, 32)[i % 4]) for i in range(len(xs))]
    max_err = 0.0

    def plain(xs, bits, neg_ranges=None):
        if neg_ranges is None:
            neg_ranges = torch.stack([torch.stack([-x.min(), x.max()]) for x in xs])
        return [torch.where(b < 32, fq._quantize_in_range(x, fq._levels(b), -r[0], r[1]), x)
                for x, b, r in zip(xs, bits, neg_ranges)]

    for label, values in (('4 bits', [4.0] * len(xs)), ('bits 2/4/8/32', mixed)):
        bits = torch.tensor(values, device=device)
        got = fq.fake_quant_per_tensor_group_global(xs, bits)
        fused = fq.fake_quant_per_tensor_group(xs, bits)
        want = plain(xs, bits)
        check(all(torch.equal(g, f) for g, f in zip(got, fused)),
              '31a: the split grouped K1\' differs from the fused one at %s', label)
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              '31a: the split grouped K1\' differs from the plain version at %s', label)
        max_err = max(max_err, max(float((g - w).abs().max()) for g, w in zip(got, want)))
        ranges = fq.tensor_group_minmax(xs, bits)
        for t, (x, b) in enumerate(zip(xs, values)):
            lo_hi = torch.stack([-x.min(), x.max()]) if b < 32 else torch.full(
                (2,), -torch.finfo(torch.float32).max, device=device)
            check(torch.equal(ranges[t], lo_hi), '31a: pass 1 of tensor %d is %s, not %s', t,
                  ranges[t].tolist(), lo_hi.tolist())
        wide = torch.stack([-(-ranges[:, 0] - 0.5), ranges[:, 1] + 0.25], dim=1).contiguous()
        from_range = fq.tensor_group_from_range(xs, bits, wide)
        check(all(torch.equal(g, w) for g, w in zip(from_range, plain(xs, bits, wide))),
              '31a: pass 2 from wider ranges differs from the plain version at %s', label)
        log('  31a %s: the split grouped K1\' equals the fused one and the plain version at the '
            '%d weights; pass 1\'s ranges exact; pass 2 from wider ranges equals the plain '
            'version', label, len(xs))
    bits = torch.tensor([4.0] * len(xs), device=device)
    ms = time_ms(lambda: fq.fake_quant_per_tensor_group_global(xs, bits))
    fused_ms = time_ms(lambda: fq.fake_quant_per_tensor_group(xs, bits))
    plain_ms = time_ms(lambda: plain(xs, bits), 5)
    device_ms = kernel_device_ms(lambda: fq.fake_quant_per_tensor_group_global(xs, bits),
                                 ('group_minmax_partials', 'group_ranges',
                                  'group_quantize_from_range'))
    fused_device_ms = kernel_device_ms(lambda: fq.fake_quant_per_tensor_group(xs, bits),
                                       ('group_minmax_partials', 'group_quantize('))
    nb = sum(x.numel() for x in xs)
    bound_ms, bound_by = fq_bound(nb)
    log('  31a fake_quant_per_tensor_group_global, %d weights (%.2fM elements), 4 bits, model '
        'size 1: %.4f ms a call (%.0f%% of the bound), device %s ms (its 3 kernels), fused '
        '%.4f ms a call, device %s ms, plain %.4f ms, bound %.4f ms (%s) | %s', len(xs),
        nb / 1e6, ms, 100 * bound_ms / ms, device_ms, fused_ms, fused_device_ms, plain_ms,
        bound_ms, bound_by, card)
    return {'fake_quant_per_tensor_group_global': dict(
        max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, fused_ms=fused_ms, device_ms=device_ms,
        fused_device_ms=fused_device_ms)}


def kernel_device_ms(fn, names, reps=20):
    """The device time a call of fn() spends in the kernels whose names
    contain one of `names`, from torch.profiler's CUDA records over `reps`
    calls after one; None where the profiler recorded none of them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.time_range.end - e.time_range.start for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and any(n in e.name for n in names))
    return total / reps / 1e3 if total else None


def tp_global_batches(learner):
    """TP_STEPS host batches of TP_GLOBAL_BATCH synthetic ILSVRC-12 images,
    the same on every rank whatever its shard."""
    arrays, labels = learner.dataset_train.synthesize_arrays(TP_STEPS * TP_GLOBAL_BATCH)
    n = TP_GLOBAL_BATCH
    return [{'image': arrays[np.arange(i * n, (i + 1) * n) % len(arrays)],
             'label': labels[np.arange(i * n, (i + 1) * n) % len(labels)]}
            for i in range(TP_STEPS)]


def tp_state_digest(state):
    """(the full state's snapshot, its sha256, the sha256 of this rank's
    replicated parameters and buffers, the bytes of this rank's parameters
    and SGD momentum)."""
    import hashlib
    from pocketflow_tpu_torch.core import mesh
    from pocketflow_tpu_torch.nn import layers
    full = {k.replace('.', '/'): v.detach().cpu().clone()
            for k, v in layers.full_state_dict(state.model).items()}
    digest = hashlib.sha256()
    for name, value in sorted(state.model.state_dict(keep_vars=True).items()):
        if not isinstance(value, mesh.ModelShard):
            digest.update(name.encode() + value.detach().contiguous().view(torch.uint8)
                          .cpu().numpy().tobytes())
    nb_bytes = sum(p.numel() * p.element_size() for p in state.model.parameters())
    nb_bytes += sum(b.numel() * b.element_size() for buffers in state.optimizer.state.values()
                    for b in buffers.values() if torch.is_tensor(b))
    return full, dp_checksum(full), digest.hexdigest(), nb_bytes


def tp_steps(learner, init_path, host_batches):
    """TP_STEPS quantized train steps of `learner` under the mesh in scope,
    from the full state at init_path, on this rank's rows of host_batches:
    the losses (the data group's mean), the full state after them (rank 0),
    its checksum and the replicated tensors', the launches and collectives
    of the steps, the state bytes a rank, the peak memory and the host
    seconds a step."""
    from pocketflow_tpu_torch.core import mesh
    from pocketflow_tpu_torch.learners.uniform_quantization.bit_optimizer import BitOptimizer
    from pocketflow_tpu_torch.nn import layers
    t0 = time.perf_counter()
    state, tx, _ = learner.init_state_quant()
    payload = torch.load(init_path, map_location=learner.device, weights_only=True)
    layers.load_full_state_dict(state.model, payload['model'])
    state = learner.set_bits(state, *BitOptimizer(learner, state).run())
    step = learner.build_quant_train_step(tx)
    batches = [learner.put_batch(mesh.shard_batch(b)) for b in host_batches]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    mesh.reset_counters()  # the steps' launches and collectives from here ...
    start = time.perf_counter()
    losses = []
    for i, batch in enumerate(batches):
        state, metrics = step(state, batch, learner.generator(i))
        losses.append(metrics['loss'].detach().float())
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - start) / len(batches)
    out = dict(launches=counters(), collectives=mesh.counters(),  # ... to here
               prep_seconds=start - t0)
    losses = torch.stack(losses)
    mesh.all_reduce_mean_([losses])
    end, checksum, replicated, nb_bytes = tp_state_digest(state)
    out.update(losses=losses.tolist(), checksum=checksum, replicated=replicated,
               state_bytes=nb_bytes, seconds=seconds,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               shards=sum(isinstance(p, mesh.ModelShard) for p in state.model.parameters()),
               place=(mesh.data_rank(), mesh.model_rank()))
    if mesh.worker_rank() == 0:
        out['end'] = end
    del state, step, batches
    torch.cuda.empty_cache()
    return out


def tp_gloo_probe():
    """Which collectives gloo runs with CUDA tensors on cuda:0: {name: 'ok'
    or the exception's type and first line}."""
    import torch.distributed as dist
    device = torch.device('cuda', 0)
    world = dist.get_world_size()
    t = torch.ones(8, device=device)
    calls = {
        'all_reduce': lambda: dist.all_reduce(t.clone()),
        'broadcast': lambda: dist.broadcast(t.clone(), src=0),
        'barrier': dist.barrier,
        'all_gather': lambda: dist.all_gather([torch.empty_like(t) for _ in range(world)], t),
        'all_gather_into_tensor': lambda: dist.all_gather_into_tensor(
            torch.empty(world * 8, device=device), t),
        'reduce_scatter_tensor': lambda: dist.reduce_scatter_tensor(
            torch.empty(8 // world, device=device), t),
        'all_to_all_single': lambda: dist.all_to_all_single(torch.empty_like(t), t),
    }
    out = {}
    for name in GLOO_PROBES:
        try:
            calls[name]()
            torch.cuda.synchronize()
            out[name] = 'ok'
        except Exception as exc:  # recorded, not retried: the probe's result
            out[name] = '%s: %s' % (type(exc).__name__, str(exc).splitlines()[0][:120])
        dist.barrier()
    return out


def tp_payload_record(model, optimizer, step):
    """sha256 of a full state dict `model`, of the momentum of a full
    optimizer state dict `optimizer`, and `step`."""
    import hashlib
    full = {k.replace('.', '/'): v.detach().cpu().clone() for k, v in model.items()}
    digest = hashlib.sha256()
    for index, buffers in sorted(optimizer['state'].items()):
        digest.update(buffers['momentum_buffer'].detach().cpu().contiguous().view(torch.uint8)
                      .numpy().tobytes())
    return {'model': dp_checksum(full), 'momentum': digest.hexdigest(), 'step': step,
            'nb_tensors': len(full)}


def tp_full_record(state):
    """tp_payload_record of a train state, its shards gathered."""
    from pocketflow_tpu_torch.core import checkpoint as ckpt_lib
    from pocketflow_tpu_torch.nn import layers
    return tp_payload_record(layers.full_state_dict(state.model),
                             ckpt_lib.full_optimizer_state(state.optimizer), state.step)


def tp_main_saves(work_dir):
    """31c on this rank: main.main (TP_CKPT_ARGV) on the mesh of the ranks
    (data:2,model:2) under each --ckpt_backend, saving after every step, so
    that a save is written while the next step trains.  {backend: the
    record of the state at its last save, the save path, seconds; and for
    'orbax', 'earlier': (the record at each earlier save, the record of
    what its directory holds)}."""
    from pocketflow_tpu_torch import main as port_main
    from pocketflow_tpu_torch.core import checkpoint as ckpt_lib
    from pocketflow_tpu_torch.learners import abstract_learner
    save_model = abstract_learner.AbstractLearner.save_model
    argv = [a for a in TP_CKPT_ARGV if not a.startswith('--save_step=')] + ['--save_step=1']
    out = {}
    for backend in ('msgpack', 'orbax'):
        path = os.path.join(work_dir, 'tp_ckpt', backend, 'model.ckpt')
        records = []

        def recorded(self, state, *args, **kwargs):
            records.append(tp_full_record(state))
            return save_model(self, state, *args, **kwargs)

        abstract_learner.AbstractLearner.save_model = recorded
        start = time.perf_counter()
        try:
            port_main.main(argv + [
                '--mesh_shape=data:2,model:2', '--enbl_tensor_parallel',
                '--ckpt_backend=%s' % backend, '--uql_save_quant_model_path=%s' % path,
                '--save_path=%s' % os.path.join(work_dir, 'tp_ckpt', 'base', 'model.ckpt'),
                '--log_dir=%s' % os.path.join(work_dir, 'tp_ckpt', 'logs')], device='cuda:0')
        finally:
            abstract_learner.AbstractLearner.save_model = save_model
        out[backend] = dict(records[-1], path=path, seconds=time.perf_counter() - start)
        if backend == 'orbax':
            earlier = [r for r in records if r['step'] < records[-1]['step']]
            out[backend]['earlier'] = []
            for record in earlier:
                payload = ckpt_lib._dcp_load('%s-%d.dcp' % (path, record['step']))
                out[backend]['earlier'].append((record, tp_payload_record(
                    payload['model'], payload['optimizer'], payload['step'])))
    return out


def tp_restore(paths, mesh_shape):
    """The QAT ResNet-50 learner of TP_CKPT_ARGV restored on `mesh_shape`
    from each backend's checkpoint: {backend: the full record}."""
    from pocketflow_tpu_torch.config import FLAGS
    from pocketflow_tpu_torch import main as port_main
    from pocketflow_tpu_torch.learners.uniform_quantization.learner import UniformQuantLearner
    from pocketflow_tpu_torch.nets.resnet_at_ilsvrc12 import ModelHelper
    port_main.register_flags()
    out = {}
    for backend, path in paths.items():
        with FLAGS.scope(**FLAGS.as_dict()):
            FLAGS.parse_args(TP_CKPT_ARGV + ['--mesh_shape=%s' % mesh_shape,
                                             '--ckpt_backend=%s' % backend])
            learner = UniformQuantLearner(None, ModelHelper(resnet_size=50),
                                          device=torch.device('cuda', 0))
            state, _, _ = learner.init_state_quant()
            restored = learner.restore_model(state, path)
            check(restored is not None, '31c: no checkpoint under %s', path)
            out[backend] = tp_full_record(restored)
            del learner, state, restored
    torch.cuda.empty_cache()
    return out


def tp_rank_z(init_path, flags, work_dir=None):
    """Run Z on one rank of a TP mesh (gloo ranks sharing cuda:0): the gloo
    probe (first mesh only), TP_STEPS main-path steps, and with `work_dir`
    31c's main.main saves."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from pocketflow_tpu_torch.config import FLAGS
    import pocketflow_tpu_torch.learners.uniform_quantization.learner  # noqa: F401
    import pocketflow_tpu_torch.nets.resnet_at_ilsvrc12  # noqa: F401
    FLAGS.override(synthetic_data=True, summ_step=10 ** 9, save_step=10 ** 9,
                   resnet_stem_s2d=True, rand_seed=0)
    out, start = {}, time.perf_counter()
    if work_dir is None:
        out['gloo'] = tp_gloo_probe()
    with FLAGS.scope(**flags):
        learner = dp_learner(flags)
        out['steps'] = tp_steps(learner, init_path, tp_global_batches(learner))
        del learner
    out['steps']['rank_seconds'] = time.perf_counter() - start
    if work_dir is not None:
        out['saves'] = tp_main_saves(work_dir)
    return out


def tp_restore_rank(paths, mesh_shape):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return tp_restore(paths, mesh_shape)


def phase_tp(FLAGS, work_dir, card):
    """Phase 31b and 31c.  31b: one rank at the global batch
    (TP_GLOBAL_BATCH) and again from parameters one ulp away (the bound's
    spread), then each mesh of TP_MESHES on cuda:0 over gloo from the same
    saved state on the same global batches split by data rank (run Z1:
    data:1,model:2, two ranks; Z2: data:2,model:2, four): every rank's full
    state identical, the replicated tensors bit-identical across the model
    ranks, within 2x the 1-ulp reruns of the one rank, one split grouped K1'
    launch a step and no plain call, the collectives a step by kind, the
    state bytes a rank against world 1.  31c on Z2's ranks: main.main saves
    under each backend; the checkpoints resume at world 1 here and on two
    data ranks, bit for bit.  Returns {run label: rank 0's counters}."""
    from pocketflow_tpu_torch.tools import launch
    init_path = os.path.join(work_dir, 'tp_init.pt')
    flags1 = dict(DP_FLAGS, batch_size=TP_GLOBAL_BATCH)
    start = time.perf_counter()
    with FLAGS.scope(**flags1):
        learner = dp_learner(flags1)
        state, _, _ = learner.init_state_quant()
        torch.save({'model': state.model.state_dict()}, init_path)
        world1_bytes = 2 * sum(p.numel() * p.element_size() for p in state.model.parameters())
        del state
        host_batches = tp_global_batches(learner)
        one = dp_steps(learner, init_path, host_batches)
        reruns = [dp_steps(learner, init_path, host_batches, perturb=way)
                  for way in DP_PERTURBATIONS]
        del learner
    torch.cuda.empty_cache()
    log('  31b one rank at batch %d: losses %s, %.1f ms a step, parameters + momentum %.1f MB '
        '| with its %d reruns %.1f s', TP_GLOBAL_BATCH, ['%.6f' % v for v in one['losses']],
        1e3 * one['seconds'], world1_bytes / 1e6, len(reruns), time.perf_counter() - start)
    runs, saves = {}, None
    for data, model in TP_MESHES:
        label = TP_RUN[(data, model)]
        flags = dict(DP_FLAGS, batch_size=TP_GLOBAL_BATCH // data,
                     mesh_shape='data:%d,model:%d' % (data, model), enbl_tensor_parallel=True)
        last = (data, model) == TP_MESHES[-1]
        start = time.perf_counter()
        ranks = launch.spawn('chip_smoke:tp_rank_z', data * model,
                             {'init_path': init_path, 'flags': flags,
                              'work_dir': work_dir if last else None},
                             backend='gloo', timeout=TP_RANK_TIMEOUT,
                             work_dir=os.path.join(work_dir, 'tp_z%d%d' % (data, model)),
                             threads=0)
        elapsed = time.perf_counter() - start
        if 'gloo' in ranks[0]:
            log('  31b gloo collectives with CUDA tensors (torch %s): %s', torch.__version__,
                ranks[0]['gloo'])
        outs = [r['steps'] for r in ranks]
        runs[label] = outs[0]['launches']
        check([o['place'] for o in outs] == [(r // model, r % model) for r in range(len(outs))],
              '%s: places %s', label, [o['place'] for o in outs])
        check(len({o['checksum'] for o in outs}) == 1, '%s: ranks\' full states differ', label)
        check(len({o['replicated'] for o in outs}) == 1,
              '%s: replicated tensors differ across ranks', label)
        check(all(o['losses'] == outs[0]['losses'] for o in outs), '%s: losses differ', label)
        check(all(o['launches'] == no_launches(fake_quant_per_tensor_group_global=TP_STEPS)
                  for o in outs), '%s: launches %s', label, outs[0]['launches'])
        per_step = {k: v / TP_STEPS for k, v in outs[0]['collectives'].items()}
        check(per_step.get('all_gather_model') == outs[0]['shards']
              and per_step.get('all_reduce_max_model') == 1,
              '%s: model-group collectives a step %s for %d shards', label, per_step,
              outs[0]['shards'])
        groups, worst, nb_past = dp_errors(outs[0]['end'], one['end'], [r['end'] for r in reruns])
        groups['loss'] = (max(abs(a - b) for a, b in zip(outs[0]['losses'], one['losses'])),
                          max(abs(a - b) for r in reruns
                              for a, b in zip(r['losses'], one['losses'])))
        log('  31b %s: %d ranks, full states identical (sha256 %s...), replicated tensors '
            'bit-identical across the model ranks; losses %s (one rank %s); against one rank, '
            'distance / the largest of %d 1-ulp reruns\' (%s): %s; per tensor the largest ratio '
            '%.3f, %d of %d past %.0fx; %d shards a rank; collectives a step %s; launches %s; '
            '%.1f ms a step (gloo through the host); parameters + momentum %.1f MB a rank '
            '(%.1f%% of world 1\'s %.1f MB); peak %s GiB | spawned and joined in %.1f s | %s',
            label, len(outs), outs[0]['checksum'][:12], ['%.6f' % v for v in outs[0]['losses']],
            ['%.6f' % v for v in one['losses']], len(reruns), ', '.join(DP_PERTURBATIONS),
            '; '.join('%s %.4g / %.4g' % (k, *v) for k, v in groups.items()), worst, nb_past,
            len(one['end']), DP_NOISE_FACTOR, outs[0]['shards'], per_step, outs[0]['launches'],
            1e3 * max(o['seconds'] for o in outs), outs[0]['state_bytes'] / 1e6,
            100 * outs[0]['state_bytes'] / world1_bytes, world1_bytes / 1e6,
            ['%.2f' % o['peak_gib'] for o in outs], elapsed, card)
        log('  31b %s: a rank\'s set-up and steps %.1f s (its state, load and batches %.1f s)',
            label, outs[0]['rank_seconds'], outs[0]['prep_seconds'])
        for name, (err, spread) in groups.items():
            check(err <= DP_NOISE_FACTOR * spread, '%s: %s %.4g from one rank, past %.0fx the '
                  '1-ulp reruns\' %.4g', label, name, err, DP_NOISE_FACTOR, spread)
        check(outs[0]['state_bytes'] < 0.6 * world1_bytes, '%s: %d state bytes a rank', label,
              outs[0]['state_bytes'])
        if last:
            saves = [r['saves'] for r in ranks]
            # 31c's main.main on rank 0, by its log's clock
            with open(os.path.join(work_dir, 'tp_z%d%d' % (data, model), 'rank0.log')) as fin:
                lines = [line.strip() for line in fin if 'pocketflow_tpu_torch:' in line]
            for line in lines[-24:]:
                log('  31c rank 0: %s', line[:160])
    # 31c: the ranks' records agree; the checkpoints resume on other meshes
    start = time.perf_counter()
    for backend in saves[0]:
        check(all(s[backend]['model'] == saves[0][backend]['model']
                  and s[backend]['momentum'] == saves[0][backend]['momentum'] for s in saves),
              '31c %s: the ranks saved different states', backend)
    earlier = saves[0]['orbax']['earlier']
    check(earlier and all(got == want for want, got in earlier),
          '31c orbax: a save made while training went on differs from the state at the save '
          '(%s)', earlier)
    log('  31c orbax: %d saves made while the next step trained, each directory the state at '
        'its save bit for bit (steps %s)', len(earlier), [w['step'] for w, _ in earlier])
    paths = {b: rec['path'] for b, rec in saves[0].items()}
    with FLAGS.scope(**FLAGS.as_dict()):
        world1 = tp_restore(paths, '')
    log('  31c: the restores at world 1 %.1f s', time.perf_counter() - start)
    data2 = launch.spawn('chip_smoke:tp_restore_rank', 2, {'paths': paths, 'mesh_shape': 'data:2'},
                         backend='gloo', timeout=TP_RANK_TIMEOUT,
                         work_dir=os.path.join(work_dir, 'tp_restore'), threads=0)
    for backend, saved in saves[0].items():
        for where, got in [('world 1', world1[backend])] + [
                ('data:2 rank %d' % r, d[backend]) for r, d in enumerate(data2)]:
            check(got['model'] == saved['model'] and got['momentum'] == saved['momentum']
                  and got['step'] == saved['step'], '31c %s: the state restored at %s differs '
                  'from the saved one (%s vs %s)', backend, where, got, saved)
        files = sorted(os.listdir(os.path.dirname(paths[backend])))
        log('  31c --ckpt_backend=%s: main.main on data:2,model:2, saving every step, in '
            '%.1f s; step %d (%d tensors; files %s), restored bit for bit at world 1 and on '
            'data:2 (sha256 %s...)',
            backend, saved['seconds'], saved['step'], saved['nb_tensors'], files,
            saved['model'][:12])
    log('  31c: restores %.1f s | %s', time.perf_counter() - start, card)
    runs[TP_CKPT_RUN] = no_launches()
    return runs


# ---------------------------------------------------------------------------
# phase 32: the int8 serving kernel
# ---------------------------------------------------------------------------

def int8_site_row(tag, key, entry):
    """One distinct int8 site (int8_distinct_sites' entry) on the card: the
    kernel against its plain version bit for bit (and against the output of
    the forward that recorded it), the kernel, the plain version and cuDNN's
    bf16 conv (cuBLAS's product for the dense layer: the bf16 forward's own
    call) timed over INT8_REPS calls, the site's bound and its tile plan
    (rows and columns of a tile, splits of K)."""
    from pocketflow_tpu_torch.core.cuda_timing import int8_conv_bound_ms
    from pocketflow_tpu_torch.ops import int8_ops
    x, site = entry['x'], entry['site']
    got = int8_ops.int8_conv(x, site)
    want = int8_ops.int8_conv_plain(x, site)
    torch.cuda.synchronize()
    check(torch.equal(got, want) and torch.equal(got, entry['y']),
          '32a %s: the int8 kernel differs from its plain version at %s (max |d| %.3g)', tag, key,
          float((got.float() - want.float()).abs().max()))
    kernel = entry['kernel'].detach().to(torch.bfloat16)
    if site.dense:
        library = lambda: x @ kernel  # noqa: E731
    else:
        library = lambda: entry['layer'].conv_fn(x, kernel)  # noqa: E731
    cout = site.codes.shape[-1]
    k = site.codes.numel() // cout
    bound_ms, bound_by = int8_conv_bound_ms(x.numel() * x.element_size(), k * cout,
                                            got.numel() * got.element_size(), got.numel() // cout,
                                            cout, k)
    plan = int8_ops.launch_plan(x, site)
    return dict(site=entry['path'], kernel=key[0], x=key[1], strides=key[3], padding=key[4],
                count=entry['count'], max_abs_err=0.0, plan=(plan.bm, plan.bn, plan.splits),
                ms=time_ms(lambda: int8_ops.int8_conv(x, site), INT8_REPS),
                plain_ms=time_ms(lambda: int8_ops.int8_conv_plain(x, site), INT8_REPS),
                library_ms=time_ms(library, INT8_REPS), bound_ms=bound_ms, bound_by=bound_by)


def phase_int8(FLAGS, card):
    """Phase 32a-b (see INT8_RUN): every distinct int8 site of each net
    (int8_site_row), INT8_FORWARDS int8 forwards of each net counted, one
    ResNet-50 int8 forward profiled.  Returns (the kernel's entry of the
    result line: its ms, plain_ms, library_ms and bound_ms summed over the
    sites of one ResNet-50 forward; {run label: counters})."""
    from pocketflow_tpu_torch.experiments import int8_serving_profile, int8_serving_speed
    from pocketflow_tpu_torch.nets.mobilenet import MobileNetV1
    from pocketflow_tpu_torch.nets.resnet import ResNetImageNet
    from pocketflow_tpu_torch.nn.layers import compression
    from pocketflow_tpu_torch.ops import int8_ops
    from pocketflow_tpu_torch.tools import benchmark as bm
    device = torch.device('cuda')
    shape = (INT8_BATCH, 224, 224, 3)
    nets = {'resnet50': lambda: ResNetImageNet(resnet_size=50, nb_classes=1000,
                                               dtype=torch.bfloat16),
            'mobilenet_v1': lambda: MobileNetV1(nb_classes=1000, dtype=torch.bfloat16),
            'mobilenet_v1 odd widths': lambda: MobileNetV1(nb_classes=1000, dtype=torch.bfloat16,
                                                           width_map=INT8_ODD_WIDTHS)}
    total, entry, net_sums = no_launches(), None, {}
    with FLAGS.scope(**int8_serving_speed.SERVE_FLAGS):
        for tag, make in nets.items():
            start = time.perf_counter()
            model = make()
            model.reset_parameters(torch.Generator().manual_seed(0))
            model = model.to(device).eval()
            calib = [x * 0.5 for x in bm._staged_inputs(shape, torch.float32, device, seed=7,
                                                         nb=INT8_CALIB)]
            policy = int8_ops.Int8ServingPolicy(int8_ops.quantize_model_weights(model),
                                                int8_ops.calibrate(model, calib))
            inputs = bm._staged_inputs(shape, torch.bfloat16, device)
            sites = int8_distinct_sites(model, policy, inputs[0])
            check(sum(e['count'] for e in sites.values()) == INT8_SITES[tag],
                  '32a %s: %d int8 sites a forward', tag, sum(e['count'] for e in sites.values()))
            rows = [int8_site_row(tag, key, e) for key, e in sites.items()]
            reset_counters()  # the forwards' launches are counted from here ...
            with torch.no_grad(), compression(policy):
                for i in range(INT8_FORWARDS):
                    logits = model(inputs[i % len(inputs)])
            torch.cuda.synchronize()
            counts = counters()  # ... to here
            check(counts == no_launches(int8_conv=INT8_SITES[tag] * INT8_FORWARDS)
                  and torch.isfinite(logits).all() and logits.shape == (INT8_BATCH, 1000),
                  '32a %s: launches %s over %d forwards, logits %s', tag, counts,
                  INT8_FORWARDS, tuple(logits.shape))
            total = {k: v + counts[k] for k, v in total.items()}
            sums = {key: sum(r['count'] * r[key] for r in rows)
                    for key in ('ms', 'plain_ms', 'library_ms', 'bound_ms')}
            by_bytes = sum(r['count'] * r['bound_ms'] for r in rows if r['bound_by'] == 'bytes')
            net_sums[tag] = (sums['ms'], sums['library_ms'])
            for r in rows:
                log('  32a %s %s: kernel %s, x %s, strides %s %s, x%d a forward, plan %dx%d '
                    'tiles, %d split(s) of K: int8 kernel %.4f ms, bound %.4f ms (%s, %.0f%% of '
                    'it), plain %.4f ms, cuDNN bf16 %.4f ms (int8/cuDNN %.2f) | %s', tag,
                    r['site'], r['kernel'], r['x'], r['strides'], r['padding'], r['count'],
                    *r['plan'], r['ms'], r['bound_ms'], r['bound_by'],
                    100 * r['bound_ms'] / r['ms'], r['plain_ms'], r['library_ms'],
                    r['ms'] / r['library_ms'], card)
            log('  32a %s: %d distinct int8 sites (%d a forward) bit-equal to the plain version; '
                'summed over a forward\'s sites: int8 kernel %.3f ms, bound %.3f ms (%.0f%% of '
                'it bytes-bound), plain %.3f ms, cuDNN/cuBLAS bf16 %.3f ms; %d forwards: %s | '
                '%.1f s | %s', tag, len(rows), INT8_SITES[tag], sums['ms'], sums['bound_ms'],
                100 * by_bytes / sums['bound_ms'], sums['plain_ms'], sums['library_ms'],
                INT8_FORWARDS, {k: v for k, v in counts.items() if v},
                time.perf_counter() - start, card)
            if tag == 'resnet50':
                entry = dict(sums, max_abs_err=0.0,
                             bound_by='bytes' if 2 * by_bytes >= sums['bound_ms'] else 'operations')
                prof = int8_serving_profile.profile_forward(model, policy, inputs, 1, 2)
                # the launches a forward are the counters' (above): the
                # profiler drops kernel records in some windows, so its
                # count is held only to at most one a site
                check(prof['htod_copies'] == 0 and prof['stream_syncs'] == 0
                      and 0 < prof['launches_by_part'].get('int8 kernel', 0) <= INT8_SITES[tag]
                      and set(prof['device_ms_by_part']) <= {'int8 kernel', 'float layers'},
                      '32b: the int8 forward\'s profile %s', prof)
                log('  32b the ResNet-50 int8 forward profiled (2 forwards): %s | %s',
                    json.dumps(prof), card)
            del model, policy, inputs, calib, sites
            torch.cuda.empty_cache()
    log('  32a the int8 kernel against cuDNN/cuBLAS bf16, ms summed over a forward\'s sites: %s '
        '| %s', '; '.join('%s %.3f / %.3f (%.2fx)' % (tag, ms, lib, ms / lib)
                          for tag, (ms, lib) in net_sums.items()), card)
    return entry, {INT8_RUN: total}


def phase_example(FLAGS, work_dir, card):
    """Phase 32c (EXAMPLE_RUN): the bring-your-own-model example through its
    main() on the card: weight sparsification of its ConvNet, pr_msk at the
    target, the masked weights 0, no kernel.  Returns {run label: counters}."""
    from pocketflow_tpu_torch.examples import self_defined_convnet as example
    root = os.path.join(work_dir, 'example')
    ws_path = os.path.join(root, 'ws', 'model.ckpt')
    argv = ['--learner=weight-sparse', '--ws_prune_ratio_prtl=uniform', '--ws_prune_ratio=0.5',
            '--ws_mask_update_step=3', '--synthetic_data', '--nb_epochs_rat=0.01',
            '--lrn_rate_init=0.05', '--save_path=%s' % os.path.join(root, 'models', 'model.ckpt'),
            '--log_dir=%s' % os.path.join(root, 'logs'), '--ws_save_path=%s' % ws_path]
    counter = ForwardCounter()
    start = time.perf_counter()
    try:
        with FLAGS.scope(**FLAGS.as_dict()):
            reset_counters()
            learner = example.main(argv, device='cuda')
            torch.cuda.synchronize()
            counts = counters()
    finally:
        counter.close()
    ev = counter.evals[-1]
    pairs = learner.var_names_n_prune_ratios
    params = dict(learner.init_state()[0].model.named_parameters())
    sizes = [params[name].numel() for name, _ in pairs]
    target = sum(n * r for n, (_, r) in zip(sizes, pairs)) / sum(sizes)
    check(counts == no_launches() and counter.steps > 0 and learner.device.type == 'cuda'
          and all(math.isfinite(v) for v in ev.values()) and target >= 0.5 - 0.01
          and abs(ev['pr_msk'] - target) <= 0.02, '32c: launches %s, %d steps on %s, eval %s, '
          'target %.4f', counts, counter.steps, learner.device, ev, target)
    nb_masked = ws_masked_weights_zero(ws_path)
    log('  32c %s: %d steps, loss %.4f, eval %s, %d masked kernels exactly zero where masked | '
        '%.1f s | %s', EXAMPLE_RUN, counter.steps, float(counter.metrics['loss']),
        {k: round(v, 4) for k, v in ev.items()}, nb_masked, time.perf_counter() - start, card)
    return {EXAMPLE_RUN: counts}


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this smoke needs an NVIDIA GPU',
              file=sys.stderr)
        sys.exit(1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device('cuda')

    from pocketflow_tpu_torch.config import FLAGS
    # every flag main.main defines, registered before any run's scope saves them
    import pocketflow_tpu_torch.learners.channel_pruning.learner  # noqa: F401
    import pocketflow_tpu_torch.learners.channel_pruning_gpu.learner  # noqa: F401
    import pocketflow_tpu_torch.learners.channel_pruning_rmt.learner  # noqa: F401
    import pocketflow_tpu_torch.learners.discr_channel_pruning.learner  # noqa: F401
    import pocketflow_tpu_torch.learners.nonuniform_quantization.learner  # noqa: F401
    import pocketflow_tpu_torch.learners.uniform_quantization_tf.learner  # noqa: F401
    import pocketflow_tpu_torch.learners.weight_sparsification.learner  # noqa: F401
    import pocketflow_tpu_torch.nets.faster_rcnn_at_pascalvoc  # noqa: F401
    import pocketflow_tpu_torch.nets.mobilenet_at_ilsvrc12  # noqa: F401
    import pocketflow_tpu_torch.nets.vgg_at_pascalvoc  # noqa: F401
    from pocketflow_tpu_torch.learners.uniform_quantization.learner import UniformQuantLearner
    from pocketflow_tpu_torch.nets.resnet_at_ilsvrc12 import ModelHelper
    from pocketflow_tpu_torch.ops import build
    from pocketflow_tpu_torch.ops import fake_quant as fq
    from pocketflow_tpu_torch.ops import matmul as mm

    card = card_line()
    serve_dir = tempfile.TemporaryDirectory(prefix='pf_serve_')  # removed at exit
    log('phase 1 device: %s | %s | torch %s cuda %s', card, torch.cuda.get_device_name(0),
        torch.__version__, torch.version.cuda)

    start = time.perf_counter()
    built = build.load_all(sorted({source for source, _ in KERNELS.values()}))
    log('phase 2 build: %s side by side in %.1f s', ', '.join(built), time.perf_counter() - start)
    for source, (_, build_log, build_s) in built.items():
        log('  %s%s: nvcc %.1f s', CSRC, source, build_s)
        for line in build_log.splitlines():
            if any(key in line for key in ('registers', 'spill', 'Compiling entry')) \
                    or 'warning' in line.lower():
                log('  ptxas: %s', line.strip())

    FLAGS.override(synthetic_data=True, summ_step=10 ** 9, save_step=10 ** 9,
                   resnet_stem_s2d=True, rand_seed=0)

    log('phase 3 reference: small QAT step, card vs CPU (ResNet-50 @ 64)')
    phase_reference(FLAGS, lambda: ModelHelper(resnet_size=50), UniformQuantLearner,
                    ilsvrc_image_size=64)

    with FLAGS.scope(batch_size=BATCH, batch_size_eval=BATCH, nb_smpls_train=4096,
                     nb_smpls_eval=512, compute_dtype='bfloat16', bn_stats_subsample=1,
                     uql_weight_bits=4, uql_activation_bits=32):
        t0 = time.perf_counter()
        learner = UniformQuantLearner(None, ModelHelper(resnet_size=50), device=device)
        stats = learner.statistics
        weight_shapes_50 = stats['weight_shapes']
        check(stats['nb_matmuls'] == NB_WEIGHT_SITES and stats['nb_activations'] == NB_ACT_SITES,
              'sites %d/%d', stats['nb_matmuls'], stats['nb_activations'])

        log('phase 4 fake-quant kernels vs plain at the %d quantized weight shapes of ResNet-50',
            len(set(stats['weight_shapes'])))
        kernels = phase_kernels(fq, stats['weight_shapes'], device)
        log('phase 5 matmul kernels vs plain at the experiments\' shapes')
        kernels.update(phase_matmul(mm, device))
        torch.cuda.empty_cache()

        log('phase 6 main path: QAT ResNet-50 @224, bf16, batch %d, exact BN, s2d stem', BATCH)
        state, tx, _ = learner.init_state_quant()
        train_step = learner.build_quant_train_step(tx)
        eval_step = learner.build_quant_eval_step()
        iterator = learner.dataset_train.build()
        batches = [learner.put_batch(next(iterator)) for _ in range(4)]
        eval_batch = learner.put_batch(next(learner.dataset_eval.build()))
        torch.cuda.synchronize()
        log('  set-up (learner, data, init) %.1f s', time.perf_counter() - t0)
        torch.cuda.reset_peak_memory_stats()

        reset_counters()  # the main path's launches are counted from here ...
        for i in range(N_WARMUP):
            state, metrics = train_step(state, batches[i % 4], learner.generator(i))
        torch.cuda.synchronize()
        start = time.perf_counter()
        for i in range(N_WARMUP, N_WARMUP + N_TIMED):
            state, metrics = train_step(state, batches[i % 4], learner.generator(i))
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - start
        runs = {MAIN_RUN: counters()}  # ... to here
        loss = float(metrics['loss'])
        counts = runs[MAIN_RUN]
        check(math.isfinite(loss), 'loss %r', loss)
        check(state.step == N_WARMUP + N_TIMED, 'step %d', state.step)
        # one grouped launch a forward quantizes the 52 weights; no weight
        # goes through the per-tensor kernel
        check(counts == no_launches(fake_quant_per_tensor_group=state.step),
              'main path launches %s for %d steps', counts, state.step)
        reset_counters()
        ev = {k: float(v) for k, v in eval_step(state, eval_batch).items()}
        check(all(math.isfinite(v) for v in ev.values()), 'eval %s', ev)
        check(counters() == no_launches(fake_quant_per_tensor_group=1),
              'eval step launches %s', counters())
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        serve_ckpt = os.path.join(serve_dir.name, 'models', 'model.ckpt')
        learner.save_model(state, serve_ckpt)  # phase 22's run T serves this state
        log('  step %d loss %.4f acc %.4f | eval %s', state.step, loss,
            float(metrics['accuracy']), ev)
        log('  %.2f img/s, %.2f ms/step over %d steps, peak memory %.2f GiB | %s',
            BATCH * N_TIMED / elapsed, 1e3 * elapsed / N_TIMED, N_TIMED, peak_gib, card)

        log('phase 7 other quantization routes, %d warm-up and %d timed steps each',
            ROUTE_WARMUP, ROUTE_TIMED)
        runs.update(phase_routes(FLAGS, learner, state, train_step, batches, card))
        del state, train_step, eval_step, batches, eval_batch
        torch.cuda.empty_cache()

        log('phase 8 the matmul experiments, short, at full shapes')
        runs.update(phase_experiments())
        torch.cuda.empty_cache()

        log('phase 9 composed pruned+QAT step (bench.py): ResNet-50 @224, bf16, batch %d, '
            'exact BN, s2d stem, 4-bit weights, half the input channels of every conv kernel '
            'with more than 16 masked', BATCH)
        runs[COMPOSED_RUN] = phase_composed(learner, card)
    del learner
    torch.cuda.empty_cache()

    from pocketflow_tpu_torch.nets import convnet_at_fmnist, lenet_at_cifar10, resnet_at_cifar10
    log('phase 10 reference: small QAT step of ResNet-20 @ CIFAR-10, card vs CPU')
    phase_reference(FLAGS, resnet_at_cifar10.ModelHelper, UniformQuantLearner)

    log('phase 11 fake-quant kernels vs plain at the model zoo\'s shapes')
    zoo_shapes = {}
    for name, helper in (('ResNet-20', resnet_at_cifar10.ModelHelper),
                         ('ConvNet', convnet_at_fmnist.ModelHelper),
                         ('LeNet', lenet_at_cifar10.ModelHelper)):
        with FLAGS.scope(compute_dtype='float32'):
            site_learner = UniformQuantLearner(None, helper(), device=device)
        zoo_shapes[name] = site_learner.statistics['weight_shapes']
    phase_zoo_kernels(fq, zoo_shapes, device)

    with tempfile.TemporaryDirectory(prefix='pf_zoo_') as work_dir:
        log('phase 12 the model zoo through main.main at full width: ResNet-20 @ CIFAR-10 at '
            'batch %d (full-prec, then QAT from it with distillation), ConvNet, LeNet', ZOO_BATCH)
        runs.update(phase_zoo_path(FLAGS, work_dir, card))
        log('phase 13 ResNet-20 @ CIFAR-10 steps timed, batch %d', ZOO_BATCH)
        phase_zoo_timing(FLAGS, work_dir, card)
        log('phase 14 the DDPG agent: an update on the card against the CPU, timed')
        phase_ddpg(card)
        log('phase 15 weight sparsification through main.main at full width: ResNet-20 @ '
            'CIFAR-10 at batch %d (uniform, optimal), ConvNet @ FMNIST (uniform); then a WS '
            'step, a roll-out and prune_update timed', ZOO_BATCH)
        runs.update(phase_ws_path(FLAGS, work_dir, card))
        phase_ws_timing(FLAGS, work_dir, card)
        log('phase 16 the RL bit search through main.main: ResNet-20 @ CIFAR-10 at batch %d, '
            'mixed per-layer bits through the grouped K1\'', ZOO_BATCH)
        runs.update(phase_bit_search(FLAGS, work_dir, card))
        torch.cuda.empty_cache()
        log('phase 17 MobileNet @ ILSVRC-12 through main.main at full width (depth 1.0, 224x224, '
            'bf16, batch %d, synthetic data): uniform-tf on v1 (run K, the slice\'s main path) '
            'and v2 (run L), non-uniform on v1 (run M); the non-uniform RL bit search on '
            'ResNet-20 (run N)', MB_BATCH)
        runs.update(phase_mobilenet_uqtf(FLAGS, work_dir, card))
        runs.update(phase_mobilenet_nuq(FLAGS, work_dir, card))
        runs.update(phase_nuq_search(FLAGS, work_dir, card))
        torch.cuda.empty_cache()
        log('phase 18 MobileNet\'s shapes on the card: K2\' at the 28 weights of v1, K1\' with '
            'the select at its largest activations, a small step of each new learner card vs '
            'CPU, the two plain ops card vs CPU and timed')
        phase_mobilenet_kernels(FLAGS, fq, device, card)
        phase_mobilenet_reference(FLAGS)
        mobilenet_grad_precision()
        phase_plain_ops(FLAGS, card)
        torch.cuda.empty_cache()
        log('phase 19 the channel-pruning family through main.main: ResNet-20 @ CIFAR-10 at '
            'batch %d from run A\'s baseline (runs O-R)', ZOO_BATCH)
        runs.update(phase_cp_path(FLAGS, work_dir, card))
        torch.cuda.empty_cache()
        log('phase 20 the AMC search through main.main: MobileNet-v1 @ 224, depth 1.0, bf16, '
            'batch %d (run S)', MB_BATCH)
        runs.update(phase_mobilenet_amc(FLAGS, work_dir, card))
        torch.cuda.empty_cache()
        log('phase 21 the channel pruner\'s solvers card vs CPU, timed; a CPG PGD step and a '
            'DCP grad-norm step card vs CPU')
        phase_cp_solvers(FLAGS, card)
        phase_cp_steps(FLAGS)
        torch.cuda.empty_cache()
        log('phase 22 the deployment path through export_cli.main and serving.main: ResNet-50 '
            'from phase 6 in bf16 and int8 (run T), MobileNet-v1 from run S shrunk across its '
            'depthwise chains (run U), ResNet-20 from run O shrunk across residual merges (run '
            'V), batch %d', SERVE_BATCH)
        runs.update(phase_serving(FLAGS, work_dir, serve_ckpt, card))
        torch.cuda.empty_cache()
        t23 = time.perf_counter()
        log('phase 23 data parallelism on torch.distributed: K1\'\'s global-range route (23a), '
            'run W (world 1 under NCCL), run X (%d ranks on the card over gloo, batch %d a '
            'rank, the main and act8 routes), run Y (main.main on %d ranks)', DP_WORLD, BATCH,
            DP_WORLD)
        kernels.update(phase_dp_kernel(fq, device, card))
        torch.cuda.empty_cache()
        runs.update(phase_dp_world1(FLAGS, card))
        runs.update(phase_dp_two_ranks(FLAGS, work_dir, card))
        runs.update(phase_dp_main(FLAGS, work_dir, card))
        log('  phase 23: %.1f s', time.perf_counter() - t23)
        torch.cuda.empty_cache()
        t24 = time.perf_counter()
        log('phase 24 detection at 300x300, bf16, batch %d through main.main: SSD-VGG16 (runs '
            'D1-D3: full-prec, uniform, 8-bit activations), the kernels at its shapes, Faster '
            'R-CNN with a ResNet-50 trunk (run D4), BASELINE config #5 on %d ranks (run D5); '
            'card vs CPU at 64x64', DET_BATCH, DET_WORLD)
        det_runs, ssd_shapes = phase_det_ssd(FLAGS, work_dir, card)
        runs.update(det_runs)
        phase_det_kernels(fq, ssd_shapes, device, card)
        runs.update(phase_det_frcnn(FLAGS, work_dir, card))
        runs.update(phase_det_config5(FLAGS, work_dir, card))
        phase_det_reference(FLAGS, UniformQuantLearner)
        log('  phase 24: %.1f s', time.perf_counter() - t24)
        torch.cuda.empty_cache()
        t25 = time.perf_counter()
        log('phase 25 the real-data path: full-frame ILSVRC-12 shards on disk (25a), the '
            'loader alone (25b), QAT ResNet-50 fed from them through main.main (R1, beside R0 '
            'on synthetic data), the eval from --data_disk=hdfs (R2), SSD-300 on VOC shards '
            '(R3), the AutoML CLI (R4)')
        runs.update(phase_real_data(FLAGS, card))
        log('  phase 25: %.1f s', time.perf_counter() - t25)
        t26 = time.perf_counter()
        log('phase 26 the deployment export: run K\'s MobileNet-v1 through '
            'build_qat_deploy_forward (26a: the fold in one grouped K2\' call, the deploy '
            'forward against the QAT reference at batch %d), the TF lowering of it and of '
            'ResNet-50 at 224 (26b), the conversion where TensorFlow exists (26c)', MB_BATCH)
        runs.update(phase_export(FLAGS, work_dir, card, device))
        log('  phase 26: %.1f s', time.perf_counter() - t26)
        t27 = time.perf_counter()
        log('phase 27 --remat_blocks on the main path: QAT ResNet-50 @224, bf16, batch %d, one '
            'step under each mode from one seeded state (27a; 27b at 8-bit activations), their '
            'peak memory and step times (27c, and at batch %d), MobileNet-v1 uniform-tf '
            'through main.main (27d), Faster R-CNN ResNet-50 (27e)', BATCH, REMAT_BIG_BATCH)
        runs.update(phase_remat_resnet(FLAGS, card))
        runs.update(phase_remat_others(FLAGS, work_dir, card, device))
        log('  phase 27: %.1f s', time.perf_counter() - t27)
        t28 = time.perf_counter()
        log('phase 28 the accuracy-parity harness: ResNet-20 full-prec and uniform@4bit on the '
            'hard synthetic task at the --quick budget (28a), the composed CP -> QAT 8/8 '
            'pipeline at its --quick budget (28b), the width-mapped Faster R-CNN ResNet-50 '
            'card vs CPU (28c)')
        runs.update(phase_parity(FLAGS, work_dir, card))
        log('  phase 28: %.1f s', time.perf_counter() - t28)
        t29 = time.perf_counter()
        log('phase 29 the detection parity strips at their --quick budget: SSD-VGG16 full-prec '
            'and uniform@8bit (29a, one grouped K2\' launch a quantized forward), Faster R-CNN '
            'ResNet-18 full-prec (29b)')
        runs.update(phase_det_parity(FLAGS, work_dir, card))
        log('  phase 29: %.1f s', time.perf_counter() - t29)
        torch.cuda.empty_cache()
        t30 = time.perf_counter()
        log('phase 30 the root experiments at a short budget: uqtf_phases on the main path\'s '
            'QAT ResNet-50 (30a, one grouped K2\' launch a QAT forward, none in the warm-up), '
            'int8 and shrunk serving at batch 64 (30b), the AMC drill on MobileNet-v1 (30c)')
        runs.update(phase_root_experiments(FLAGS, work_dir, card))
        log('  phase 30: %.1f s', time.perf_counter() - t30)
        torch.cuda.empty_cache()
        t31 = time.perf_counter()
        log('phase 31 tensor parallelism: the split grouped K1\' at the main path\'s %d '
            'weights (31a), QAT ResNet-50 @224 on data:1,model:2 and data:2,model:2 over gloo '
            'on the card against one rank (31b), checkpoints saved on data:2,model:2 resumed at '
            'world 1 and on data:2 under both backends (31c)', NB_WEIGHT_SITES)
        kernels.update(phase_tp_kernel(fq, weight_shapes_50, device, card))
        torch.cuda.empty_cache()
        runs.update(phase_tp(FLAGS, work_dir, card))
        log('  phase 31: %.1f s', time.perf_counter() - t31)
        torch.cuda.empty_cache()
        t32 = time.perf_counter()
        log('phase 32 the int8 serving kernel: every distinct int8 site of ResNet-50, '
            'MobileNet-v1 and MobileNet-v1 at odd widths at batch %d, 224x224, against its plain '
            'version and timed beside its bound and cuDNN bf16 (32a), a ResNet-50 int8 forward '
            'profiled (32b), the bring-your-own-model example (32c)', INT8_BATCH)
        kernels['int8_conv'], int8_runs = phase_int8(FLAGS, card)
        runs.update(int8_runs)
        runs.update(phase_example(FLAGS, work_dir, card))
        log('  phase 32: %.1f s', time.perf_counter() - t32)
    serve_dir.cleanup()

    # each kernel's launches in the run that drives it: the main path for the
    # grouped K1', the 8-bit-activation route for K1' itself, the
    # channel-bucket route for K2', an experiment for each matmul kernel
    own_run = {'fake_quant_per_tensor_group': MAIN_RUN, 'fake_quant_per_tensor': ACT8_RUN,
               'fake_quant_per_tensor_global': DP_RUN_X['act8'],
               'fake_quant_per_tensor_group_global': TP_RUN[TP_MESHES[-1]],
               'fake_quant_per_column_group': CHANNEL_RUN,
               'matmul_bf16': next(label for label in runs if 'mm_shape_sweep' in label),
               'bn_relu_matmul_stats': next(label for label in runs if 'fused_mm_proto' in label),
               'int8_conv': INT8_RUN}
    line = {'kernels': [{'name': name, 'route': 'cuda', 'source': CSRC + source,
                         'replaces': replaces, 'run': own_run[name],
                         'launches': runs[own_run[name]][name],
                         'launches_by_run': {label: c[name] for label, c in runs.items()},
                         **{key: kernels[name][key] for key in (
                             'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
                             'library_ms')}}
                        for name, (source, replaces) in KERNELS.items()]}
    for entry in line['kernels']:
        check(entry['launches'] > 0, '%s never launched in %s', entry['name'], entry['run'])
    log('total %.1f s', time.perf_counter() - t_start)
    log('%s', card_line())
    log('%s', json.dumps(line))
    log('%s', json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


def main_phase31():
    """Phase 31 alone (``python3 chip_smoke.py --phase31``): fake_quant.cu
    built, 31a, 31b and 31c, each checked as in the whole smoke; no result
    line."""
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this smoke needs an NVIDIA GPU',
              file=sys.stderr)
        sys.exit(1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from pocketflow_tpu_torch import main as port_main
    from pocketflow_tpu_torch.config import FLAGS
    from pocketflow_tpu_torch.learners.uniform_quantization.learner import UniformQuantLearner
    from pocketflow_tpu_torch.nets.resnet_at_ilsvrc12 import ModelHelper
    from pocketflow_tpu_torch.ops import build
    from pocketflow_tpu_torch.ops import fake_quant as fq
    port_main.register_flags()
    card = card_line()
    log('device %s | torch %s cuda %s', card, torch.__version__, torch.version.cuda)
    for source, (_, _, build_s) in build.load_all(['fake_quant.cu']).items():
        log('  %s: nvcc %.1f s', source, build_s)
    FLAGS.override(synthetic_data=True, summ_step=10 ** 9, save_step=10 ** 9,
                   resnet_stem_s2d=True, rand_seed=0)
    with FLAGS.scope(**DP_FLAGS):
        learner = UniformQuantLearner(None, ModelHelper(resnet_size=50),
                                      device=torch.device('cuda'))
        shapes = learner.statistics['weight_shapes']
        del learner
    log('31a %s', phase_tp_kernel(fq, shapes, torch.device('cuda'), card))
    with tempfile.TemporaryDirectory(prefix='pf_tp_') as work_dir:
        runs = phase_tp(FLAGS, work_dir, card)
    log('runs %s', {k: {n: c for n, c in v.items() if c} for k, v in runs.items()})
    log('phase 31 alone: %.1f s | %s', time.perf_counter() - t_start, card)


def main_phase32():
    """Phase 32 alone (``python3 chip_smoke.py --phase32``): int8_conv.cu
    built, 32a, 32b and 32c, each checked as in the whole smoke; no result
    line."""
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this smoke needs an NVIDIA GPU',
              file=sys.stderr)
        sys.exit(1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from pocketflow_tpu_torch import main as port_main
    from pocketflow_tpu_torch.config import FLAGS
    from pocketflow_tpu_torch.ops import build
    port_main.register_flags()
    card = card_line()
    log('device %s | torch %s cuda %s', card, torch.__version__, torch.version.cuda)
    for source, (_, build_log, build_s) in build.load_all(['int8_conv.cu']).items():
        log('  %s: nvcc %.1f s', source, build_s)
        for line in build_log.splitlines():
            if any(key in line for key in ('registers', 'spill', 'Compiling entry')) \
                    or 'warning' in line.lower():
                log('  ptxas: %s', line.strip())
    FLAGS.override(synthetic_data=True, summ_step=10 ** 9, save_step=10 ** 9, rand_seed=0)
    entry, runs = phase_int8(FLAGS, card)
    log('32a int8_conv over a ResNet-50 forward: %s', entry)
    with tempfile.TemporaryDirectory(prefix='pf_int8_') as work_dir:
        runs.update(phase_example(FLAGS, work_dir, card))
    log('runs %s', {k: {n: c for n, c in v.items() if c} for k, v in runs.items()})
    log('phase 32 alone: %.1f s | %s', time.perf_counter() - t_start, card)


if __name__ == '__main__':
    if sys.argv[1:] == ['--phase31']:
        main_phase31()
    elif sys.argv[1:] == ['--phase32']:
        main_phase32()
    else:
        main()
