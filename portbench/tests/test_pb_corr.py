"""The correlation family (ResNet18-2D) in the harness on the CPU: the
configuration's spec and layer table against the program's, the weights
and counts at 321x1025, the reference's soft-argmax and its fp8 control
at a small size, the correlation by hand. The program against the
reference: `test_pb_reference.py`; the counts by hand: `test_pb_counts.py`."""

import dataclasses

import numpy as np
import pytest
import torch

from portbench.harness import counts, data, port
from portbench.reference import stereo as ref
from portbench.tests.tiny import RESNET18_2D, tiny_corr_config

SEED = 2 ** 31 + 211
POOL = {"pool": 2}


def _setup(config, seed=SEED):
    g = data.generator(seed, "cpu")
    return g, data.make_weights(config, g, "cpu")


def _volumes(monkeypatch):
    """The correlation volumes the reference's soft-argmax is given."""
    caught = []
    real = ref.soft_argmax

    def spy(vol):
        caught.append(vol)
        return real(vol)
    monkeypatch.setattr(ref, "soft_argmax", spy)
    return caught


def test_port_spec_is_the_programs():
    """A correlation-family file's spec is the program's ResNet18-2D at
    the file's input size (the published spec ships at 257x513)."""
    from redtail_tpu_torch.models.stereo import STEREO_SPECS
    spec = port.port_spec(RESNET18_2D)
    assert spec.corr and not spec.enc3d and not spec.dec3d
    assert spec == dataclasses.replace(STEREO_SPECS["resnet18_2d"],
                                       input_hw=(321, 1025))
    wrong = dict(RESNET18_2D, bneck_dec=RESNET18_2D["bneck_dec"][:2])
    with pytest.raises(ValueError, match="differs"):
        port.port_spec(wrong)


def test_layer_table_is_the_programs():
    from redtail_tpu_torch.models.stereo import _spec_layer_shapes
    spec = port.port_spec(RESNET18_2D)
    assert ref.layer_table(RESNET18_2D) == _spec_layer_shapes(spec)


def test_published_size_passes_the_harness():
    """At 321x1025: the spec, the weights (every leaf drawn at the
    program's shapes, the sigmoid's deconv damped) and the counts
    (`test_pb_counts.py` has them by hand); the reference's forward runs
    on the card only at that size."""
    _g, tree = _setup(RESNET18_2D)
    for path, kshape, bshape in ref.layer_table(RESNET18_2D):
        node = ref.leaf(tree, path)
        assert node["weights"].shape == kshape
        assert node["biases"].shape == bshape
    last = ref.leaf(tree, "bneck_decoder2D/deconv2D_3")["weights"]
    he = np.sqrt(2.0 / 9)  # fan in 3 x 3 x 1
    assert 0.05 * he < last.std() < 0.2 * he
    assert counts.forward_flops(RESNET18_2D, (321, 1025)) == 65_230_272_000


def test_soft_argmax_is_not_pinned(monkeypatch):
    """At a small size the reference's soft-argmax is neither pinned (the
    largest probability near 1) nor flat (near 1 / D), and the output in
    pixels is not flat; the served forward is compared with the program's
    in `test_pb_reference.py`."""
    config = tiny_corr_config()
    g, tree = _setup(config)
    left, right, shifts = data.make_frames(config, POOL, g, "cpu")
    assert len(set(shifts.tolist())) > 1
    p = ref.to_torch(tree, config, "cpu")
    vols = _volumes(monkeypatch)
    for k in range(2):
        with torch.no_grad():
            out = ref.forward(
                p, config, ref.frames_to_rgb(torch.from_numpy(left[k:k + 1])),
                ref.frames_to_rgb(torch.from_numpy(right[k:k + 1])))
        assert out.shape == (1, *config["input_hw"])
        assert float(out.std()) > 1e-3
        top = torch.softmax(vols[-1], dim=1).amax(1).flatten()
        assert 1.5 / config["max_disp"] < float(top.median()) < 0.5


def test_fp8_control_reads_far():
    """The fp8 reference against the fp32 one: well off, so a control of
    the family can fail a limit set above the program."""
    config = tiny_corr_config()
    g, tree = _setup(config)
    left, right, _ = data.make_frames(config, POOL, g, "cpu")
    p = ref.to_torch(tree, config, "cpu")
    pair = [ref.frames_to_rgb(torch.from_numpy(x[:1])) for x in (left, right)]
    with torch.no_grad():
        fp32 = ref.forward(p, config, *pair)
        fp8 = ref.forward(p, config, *pair, precision="fp8")
    assert float((fp8 - fp32).abs().mean()) > 0.5


def test_correlation_by_hand():
    fl = torch.arange(2 * 1 * 3, dtype=torch.float32).reshape(1, 2, 1, 3)
    fr = torch.ones(1, 2, 1, 3)
    vol = ref.correlation(fl, fr, 4)
    # x = 0..2; channel sums of fl: 3, 5, 7; d = 3 lies past the width
    assert vol[0, :, 0].tolist() == [[3, 5, 7], [0, 5, 7], [0, 0, 7],
                                     [0, 0, 0]]
    flat = ref.soft_argmax(torch.zeros(1, 4, 1, 1))
    assert float(flat) == pytest.approx(1.5)
