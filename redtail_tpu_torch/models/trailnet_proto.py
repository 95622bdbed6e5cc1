"""TrailNet prototxt emitter (`redtail_tpu/models/trailnet_proto.py`), the
net-generator role of the reference's
`models/nets/ResNet/caffe_srelu_resnet.py`.

Emits the shipped deploy topology: the layer names, types, wiring and
conv/pool parameters of `models/nets/ResNet/TrailNet_SResNet-18.prototxt`
(64-base channels, stride 2 on the second conv of each stage's first block,
10x6 AVE pool), so native weights serve through the `CaffeNet` interpreter
and the reference toolchain alike. `native_params_to_blobs` converts a
native param tree into the Caffe blob dict (including the frozen SReLU and
sub_mean Scale blobs); through `CaffeNet` it reproduces the native forward.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from redtail_tpu_torch.models.trailnet import _BLOCKS, _CHANNELS, INPUT_HW


def _conv_layer(name, bottom, num_output, kernel, stride=1, pad=None):
    pad_line = f"\n    pad: {pad}" if pad else ""
    return f"""layer {{
  name: "{name}"
  type: "Convolution"
  bottom: "{bottom}"
  top: "{name}"
  convolution_param {{
    num_output: {num_output}
    bias_term: true{pad_line}
    kernel_size: {kernel}
    stride: {stride}
    weight_filler {{ type: "xavier" }}
  }}
}}
"""


def _srelu_layers(prefix, blob):
    """The SReLU triplet: Scale(+1) -> ReLU -> Scale(-1), in place on
    ``blob`` (shifted ReLU: max(x, -1)), frozen params like the shipped
    graph (`TrailNet_SResNet-18.prototxt` conv1_srelu1_1..3)."""
    return f"""layer {{
  name: "{prefix}_1"
  type: "Scale"
  bottom: "{blob}"
  top: "{blob}"
  param {{ lr_mult: 0.0 decay_mult: 0.0 }}
  param {{ lr_mult: 0.0 decay_mult: 0.0 }}
  scale_param {{ filler {{ value: 1.0 }} bias_term: true \
bias_filler {{ value: 1.0 }} }}
}}
layer {{
  name: "{prefix}_2"
  type: "ReLU"
  bottom: "{blob}"
  top: "{blob}"
}}
layer {{
  name: "{prefix}_3"
  type: "Scale"
  bottom: "{blob}"
  top: "{blob}"
  param {{ lr_mult: 0.0 decay_mult: 0.0 }}
  param {{ lr_mult: 0.0 decay_mult: 0.0 }}
  scale_param {{ filler {{ value: 1.0 }} bias_term: true \
bias_filler {{ value: -1.0 }} }}
}}
"""


def emit_trailnet_prototxt() -> str:
    h, w = INPUT_HW
    out: List[str] = [f"""input: "data"
input_shape {{ dim: 1 dim: 3 dim: {h} dim: {w} }}
layer {{
  name: "sub_mean"
  type: "Scale"
  bottom: "data"
  top: "sub_mean"
  param {{ lr_mult: 0.0 decay_mult: 0.0 }}
  param {{ lr_mult: 0.0 decay_mult: 0.0 }}
  scale_param {{ filler {{ value: 0.00390625 }} bias_term: true \
bias_filler {{ value: -0.5 }} }}
}}
"""]
    out.append(_conv_layer("conv1", "sub_mean", _CHANNELS[0], 7, 2))
    out.append(_srelu_layers("conv1_srelu1", "conv1"))
    out.append("""layer {
  name: "pool1"
  type: "Pooling"
  bottom: "conv1"
  top: "pool1"
  pooling_param { pool: MAX kernel_size: 3 stride: 2 }
}
""")
    bottom = "pool1"
    cin = _CHANNELS[0]
    for stage, (nblocks, cout) in enumerate(zip(_BLOCKS, _CHANNELS), 1):
        for blk in range(1, nblocks + 1):
            stride = 2 if (stage > 1 and blk == 1) else 1
            base = f"res{stage}_{blk}"
            out.append(_conv_layer(f"{base}_1", bottom, cout, 3, 1, pad=1))
            out.append(_srelu_layers(f"{base}_1_srelu", f"{base}_1"))
            # stride-2 sits on the SECOND conv (shipped graph: res2_1_2
            # stride 2) with a 1x1 s2 projection shortcut.
            out.append(_conv_layer(f"{base}_2", f"{base}_1", cout, 3,
                                   stride, pad=1))
            shortcut = bottom
            if stride != 1 or cin != cout:
                out.append(_conv_layer(f"{base}_proj", bottom, cout, 1,
                                       stride))
                shortcut = f"{base}_proj"
            out.append(f"""layer {{
  name: "{base}_sum"
  type: "Eltwise"
  bottom: "{shortcut}"
  bottom: "{base}_2"
  top: "{base}"
}}
""")
            out.append(_srelu_layers(f"{base}_srelu", base))
            bottom = base
            cin = cout
    # 10x6 AVE pool: "TensorRT currently does not support global pooling"
    # so the reference hardcodes the 320x180 trunk output size
    # (`caffe_srelu_resnet.py:80-100`).
    out.append(f"""layer {{
  name: "pool_avg"
  type: "Pooling"
  bottom: "{bottom}"
  top: "pool_avg"
  pooling_param {{ kernel_w: 10 kernel_h: 6 stride: 1 pool: AVE }}
}}
""")
    for head, top_sm in (("fc3", "softmax"), ("fc3_t", "softmax_t")):
        out.append(f"""layer {{
  name: "{head}"
  type: "InnerProduct"
  bottom: "pool_avg"
  top: "{head}"
  inner_product_param {{ num_output: 3 }}
}}
layer {{
  name: "{top_sm}"
  type: "Softmax"
  bottom: "{head}"
  top: "{top_sm}"
}}
""")
    out.append("""layer {
  name: "concat"
  type: "Concat"
  bottom: "softmax"
  bottom: "softmax_t"
  top: "out"
}
""")
    return "".join(out)


def native_params_to_blobs(params: Dict) -> Dict[str, List[np.ndarray]]:
    """Native param tree (numpy) -> Caffe blob dict for the emitted
    prototxt.

    Conv weights HWIO -> OIHW; fc weights (in, out) -> (out, in) (the fc
    input is the pooled (N, C, 1, 1) blob, so NCHW flattening order
    matches the channel order directly). Also materializes the frozen
    Scale blobs (sub_mean and every SReLU shift pair) so the dict is a
    complete caffemodel payload."""
    blobs: Dict[str, List[np.ndarray]] = {}
    for name, leaf in params.items():
        w = np.asarray(leaf["w"], np.float32)
        b = np.asarray(leaf["b"], np.float32)
        if w.ndim == 4:  # conv
            blobs[name] = [np.transpose(w, (3, 2, 0, 1)), b]
        else:            # fc (in, out)
            blobs[name] = [np.transpose(w, (1, 0)), b]

    def scale_pair(name, c, shift):
        blobs[f"{name}_1"] = [np.ones(c, np.float32),
                              np.full(c, shift, np.float32)]
        blobs[f"{name}_3"] = [np.ones(c, np.float32),
                              np.full(c, -shift, np.float32)]

    blobs["sub_mean"] = [np.full(3, 1.0 / 256.0, np.float32),
                         np.full(3, -0.5, np.float32)]
    scale_pair("conv1_srelu1", _CHANNELS[0], 1.0)
    for stage, (nblocks, cout) in enumerate(zip(_BLOCKS, _CHANNELS), 1):
        for blk in range(1, nblocks + 1):
            scale_pair(f"res{stage}_{blk}_1_srelu", cout, 1.0)
            scale_pair(f"res{stage}_{blk}_srelu", cout, 1.0)
    return blobs
