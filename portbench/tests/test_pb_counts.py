"""The benchmark's operation and byte counts against values worked by
hand, one layer of each kind."""

import json
from pathlib import Path

from portbench.harness import counts
from portbench.tests.tiny import RESNET18_2D

ROOT = Path(__file__).resolve().parents[2]


def config(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())


def test_nvsmall_layers_by_hand():
    flops = dict(counts.layer_flops(config("nvsmall-321x1025-bf16"),
                                    (321, 1025)))
    # stem: 5x5 stride 2 over 3 channels, 32 out, both towers, 161 x 513
    assert flops["encoder2D/conv1"] == 2 * 2 * 161 * 513 * 25 * 3 * 32
    # conv3D_1 over the (64, 48, 161, 513) concat volume, 32 out
    assert flops["encoder3D/conv3D_1"] == 2 * 48 * 161 * 513 * 27 * 64 * 32
    # conv3D_3ds: stride 2 -> (24, 81, 257), 32 in, 64 out
    assert flops["encoder3D/conv3D_3ds"] == 2 * 24 * 81 * 257 * 27 * 32 * 64
    # deconv3D_1: its input is conv3D_8's (12, 41, 129), 128 in, 64 out
    assert flops["decoder3D/deconv3D_1"] == 2 * 12 * 41 * 129 * 27 * 128 * 64
    # deconv3D_3: input conv3D_2's size after deconv3D_2, (48, 161, 513)
    assert flops["decoder3D/deconv3D_3"] == 2 * 48 * 161 * 513 * 27 * 32 * 1
    assert abs(counts.forward_flops(config("nvsmall-321x1025-bf16"),
                                    (321, 1025)) / 1e12 - 1.17745) < 1e-4


def test_resnet18_3d_train_forward_by_hand():
    c = config("resnet18_3d-bf16")
    flops = dict(counts.layer_flops(c, (160, 512), 4))
    assert flops["encoder2D/resblock1/res_conv1"] == \
        2 * 2 * 4 * 80 * 256 * 9 * 32 * 32
    assert flops["encoder3D/conv3D_1a"] == 2 * 4 * 68 * 80 * 256 * 27 * 64 * 32
    # deconv3D_5 reads deconv3D_4's output at conv3D_1b's (68, 80, 256)
    assert flops["decoder3D/deconv3D_5"] == 2 * 4 * 68 * 80 * 256 * 27 * 32


def test_resnet18_2d_by_hand():
    """The correlation family at 321x1025, n = 1: the towers, the
    correlation, the bottleneck's strided convs (left image only) and
    transposed convs."""
    flops = dict(counts.layer_flops(RESNET18_2D, (321, 1025)))
    h2w2 = 161 * 513
    # correlation: a product and a sum a channel (32), disparity (48), pixel
    assert flops["corr_cost_volume+softargmax"] == 2 * h2w2 * 48 * 32
    # conv2D_1 over the joined map (32 conv1 channels and the soft-argmax)
    assert flops["bneck_encoder2D/conv2D_1"] == 2 * h2w2 * 9 * 33 * 32
    # conv2D_3ds: stride 2 -> (81, 257), 32 in, 64 out
    assert flops["bneck_encoder2D/conv2D_3ds"] == 2 * 81 * 257 * 9 * 32 * 64
    # deconv2D_1 reads conv2D_8's (41, 129), 128 in, 64 out
    assert flops["bneck_decoder2D/deconv2D_1"] == 2 * 41 * 129 * 9 * 128 * 64
    # deconv2D_3 reads deconv2D_2's output at conv2D_2's (161, 513), 32 in
    assert flops["bneck_decoder2D/deconv2D_3"] == 2 * h2w2 * 9 * 32 * 1

    def total(prefix):
        return sum(v for k, v in flops.items() if k.startswith(prefix))
    assert round(total("encoder2D/") / 1e9, 3) == 52.553
    assert round(total("bneck_") / 1e9, 3) == 12.424
    assert round(flops["corr_cost_volume+softargmax"] / 1e9, 3) == 0.254
    assert counts.forward_flops(RESNET18_2D, (321, 1025)) == 65_230_272_000
    # two (161, 513, 32) bf16 maps read, a (161, 513) fp32 map written
    b = counts.corr_softargmax_bytes(RESNET18_2D, (321, 1025))
    assert b == 2 * h2w2 * 32 * 2 + h2w2 * 4 == 10_902_276
    assert abs(b / counts.HBM_BYTES_PER_S * 1e6 - 3.254) < 1e-3  # us


def test_kernel_bytes_by_hand():
    n = config("nvsmall-321x1025-bf16")
    # maps (161, 513, 3 x 32) and (161, 513, 6 x 32) bf16, fp32 bias of 32,
    # output (48, 161, 513, 32) bf16
    assert counts.emission_bytes(n, (321, 1025)) == \
        161 * 513 * 96 * 2 + 161 * 513 * 192 * 2 + 32 * 4 \
        + 48 * 161 * 513 * 32 * 2
    r = config("resnet18_3d-bf16")
    # two (4, 80, 256, 32) maps in, (4, 68, 80, 256, 64) volume out, bf16
    want = 2 * 4 * 80 * 256 * 32 * 2 + 4 * 68 * 80 * 256 * 64 * 2
    assert counts.concat_bytes(r, (160, 512), 4) == want
    assert counts.concat_bwd_bytes(r, (160, 512), 4) == want


def test_roofline_share():
    assert counts.roofline_share(1e-4, 10, 2e-3) == 50.0
