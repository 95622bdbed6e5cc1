"""The port's layer profiler (`runtime/layer_profiler.py`) against the JAX
package's, on the CPU.

For the four specs under every head (the 3D models' fused default,
`plain_lowering()`, `packed3d_lowering()` with the unpack and the D-folded
final deconv; ResNet18-2D on raw and s2d-packed frames), with the port's
seeded weights conditioned as `tests/test_torch_stereo.py` conditions them
(random biases): the port's layer plan composes to exactly
`StereoNet.forward`; its entry names map one to one onto the JAX plan's
under `map_names`; each entry the map keeps by name, and each half of a
tower entry, is within 1e-4 of the JAX entry (fp32 summation order through
the layers before it); the composed output is within the slice tolerances
of JAX `stereo_forward` (1e-3 px for the 3D models, 1e-4 sigmoid units for
ResNet18-2D). The JAX side runs under its own same head: its CPU defaults,
``REDTAIL_TPU_PACKED3D=1`` (as `tests/test_packed3d.py:310` does), its
`plain_lowering()`, and ``REDTAIL_TPU_DFOLD=1`` on both sides for the
D-folded deconv.

Then the cost columns (the kernel entries' flops are the ops' flop
formulas, `kernels/_ops.py`; bytes are inputs plus outputs), the profiler
on the CPU with a short loop, its plan check, and the table's columns.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from redtail_tpu.models import STEREO_SPECS as JSPECS
from redtail_tpu.models import stereo as jstereo
from redtail_tpu.ops.convolution import plain_lowering as jplain_lowering
from redtail_tpu.runtime import layer_profiler as jlp

from redtail_tpu_torch.kernels import _ops
from redtail_tpu_torch.models import (STEREO_SPECS, init_stereo_params,
                                      params_from_numpy)
from redtail_tpu_torch.ops.convolution import (packed3d_lowering,
                                               plain_lowering)
from redtail_tpu_torch.runtime import layer_profiler as lp
from test_torch_stereo import _inputs, conditioned

HW_3D, HW_2D, MAX_DISP = (65, 129), (34, 66), 8
HEADS_3D = ("fused", "plain", "packed", "packed_dfold")
CASES = ([(name, head, HW_3D, False) for name in ("nvtiny", "nvsmall",
                                                   "resnet18")
          for head in HEADS_3D]
         + [("resnet18_2d", "corr", HW_2D, s2d) for s2d in (False, True)])


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """A few intra-op threads, so that parallel test workers do not
    oversubscribe the cores (restored after)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("REDTAIL_TPU_PACKED3D", "REDTAIL_TPU_DFOLD",
                "REDTAIL_TPU_FUSED_TOWERS", "REDTAIL_TPU_HPACK2D",
                "REDTAIL_TPU_HPACK_CORR", "REDTAIL_TPU_PALLAS_CONV3D",
                "REDTAIL_TPU_MASK_FORM", "REDTAIL_TPU_MASK_MUL"):
        monkeypatch.delenv(var, raising=False)


def map_names(names):
    """The port's entry names -> the JAX plan's, one list per entry:
    ``towers_X`` stands for ``left_X`` and ``right_X``,
    ``corr_cost_volume+softargmax`` for ``corr_cost_volume`` and
    ``softargmax``; under `plain_lowering()` the port's ``cost_volume`` and
    the dense first 3D conv after it stand together for JAX's one
    ``cost_volume+<conv>`` (given to the conv's entry); every other name
    for itself."""
    mapped = []
    for i, name in enumerate(names):
        if name.startswith("towers_"):
            layer = name[len("towers_"):]
            mapped.append([f"left_{layer}", f"right_{layer}"])
        elif name == "corr_cost_volume+softargmax":
            mapped.append(["corr_cost_volume", "softargmax"])
        elif name == "cost_volume":
            mapped.append([])
        elif i and names[i - 1] == "cost_volume":
            mapped.append([f"cost_volume+{name}"])
        else:
            mapped.append([name])
    return mapped


def _heads(head, monkeypatch):
    """(port context, JAX context) of ``head``."""
    if head == "plain":
        return plain_lowering(), jplain_lowering()
    if head.startswith("packed"):
        monkeypatch.setenv("REDTAIL_TPU_PACKED3D", "1")
        if head == "packed_dfold":
            monkeypatch.setenv("REDTAIL_TPU_DFOLD", "1")
        return packed3d_lowering(), contextlib.nullcontext()
    return contextlib.nullcontext(), contextlib.nullcontext()


def _case(name, hw, s2d, seed=0):
    spec = dataclasses.replace(STEREO_SPECS[name], input_hw=hw,
                               max_disp=MAX_DISP)
    jspec = dataclasses.replace(JSPECS[name], input_hw=hw, max_disp=MAX_DISP)
    params = conditioned(init_stereo_params(spec, seed=seed))
    left, right = _inputs(hw, s2d)
    return spec, jspec, params, left, right


def _nhwc(t, shape):
    """A port activation in the JAX entry's layout: channels-first ones
    (NCHW, NCDHW) moved last; the packed head's are NDHWC already."""
    t = t.detach().float()
    if tuple(t.shape) != tuple(shape) and t.dim() >= 4:
        t = t.movedim(1, -1)
    return t.numpy()


@pytest.mark.parametrize("name,head,hw,s2d", CASES,
                         ids=[f"{c[0]}-{c[1]}{'-s2d' if c[3] else ''}"
                              for c in CASES])
def test_plan_is_the_forward_and_maps_onto_jax(name, head, hw, s2d,
                                               monkeypatch):
    spec, jspec, params, left, right = _case(name, hw, s2d)
    net = params_from_numpy(spec, params, device="cpu")
    l, r = torch.from_numpy(left), torch.from_numpy(right)
    ctx, jctx = _heads(head, monkeypatch)
    jp = jax.tree.map(jnp.asarray, params)
    with ctx, torch.inference_mode():
        entries, out = lp.stereo_layer_plan(net, l, r)
        assert torch.equal(out, net(l, r))
        outs = {n: fn(*args) for n, fn, args, _ in entries}
    with jctx:
        jentries, jout = jlp.stereo_layer_plan(jspec, jp, jnp.asarray(left),
                                               jnp.asarray(right))
        want = np.asarray(jstereo.stereo_forward(
            jspec, jp, jnp.asarray(left), jnp.asarray(right)), np.float32)
        jouts = {n: np.asarray(fn(*args), np.float32)
                 for n, fn, args, _ in jentries}
    jnames = [n for n, *_ in jentries]
    names = [n for n, *_ in entries]
    mapped = map_names(names)

    # one to one under the map: the towers' entries pair off, everything
    # else in the same order
    flat = [j for js in mapped for j in js]
    assert sorted(flat) == sorted(jnames)
    assert ([j for j in flat if not j.startswith(("left_", "right_"))]
            == [j for j in jnames if not j.startswith(("left_", "right_"))])
    if head.startswith("packed"):
        assert any(n.endswith("[pk]") for n in names)
    if head == "packed_dfold":
        assert names[-1].endswith("+softargmin[pk]")
    if head == "plain":
        assert names[names.index("cost_volume") + 1] == spec.enc3d[0].name

    n = left.shape[0]
    for pname, jn in zip(names, mapped):
        got = outs[pname]
        if pname.startswith("towers_"):
            halves = got.detach().float().movedim(1, -1).numpy()
            np.testing.assert_allclose(halves[:n], jouts[jn[0]], atol=1e-4,
                                       err_msg=pname)
            np.testing.assert_allclose(halves[n:], jouts[jn[1]], atol=1e-4,
                                       err_msg=pname)
        elif pname == "corr_cost_volume+softargmax":
            np.testing.assert_allclose(got.numpy(),
                                       jouts["softargmax"][..., 0],
                                       atol=1e-4, err_msg=pname)
        elif len(jn) == 1:
            jo = jouts[jn[0]]
            np.testing.assert_allclose(_nhwc(got, jo.shape), jo, atol=1e-4,
                                       err_msg=pname)
    tol = 1e-4 if spec.corr else 1e-3
    np.testing.assert_allclose(out.numpy(), want, atol=tol)


# ------------------------------------------------------------- cost columns


def _entry(entries, name):
    return next(e for e in entries if e[0] == name)


def _conv_flops(x_shape, w_shape, out_shape):
    """2 x (input channels x taps) a conv output (FlopCounterMode's
    convolution count)."""
    return 2 * int(np.prod(out_shape)) * int(np.prod(w_shape[1:]))


@pytest.mark.parametrize("kernel", ["corr", "concat", "emit", "conv223"])
def test_cost_of_the_kernel_entries_is_the_flop_formula(kernel,
                                                        monkeypatch):
    name = "resnet18_2d" if kernel == "corr" else "nvtiny"
    head = {"corr": "corr", "concat": "plain", "emit": "fused",
            "conv223": "packed"}[kernel]
    spec, _, params, left, right = _case(name, HW_2D if kernel == "corr"
                                         else HW_3D, False)
    net = params_from_numpy(spec, params, device="cpu")
    ctx, _ = _heads(head, monkeypatch)
    with ctx, torch.inference_mode():
        entries, _ = lp.stereo_layer_plan(net, torch.from_numpy(left),
                                          torch.from_numpy(right))
        entry = {"corr": "corr_cost_volume+softargmax",
                 "concat": "cost_volume", "emit": "cost_volume+conv3D_1",
                 "conv223": "conv3D_2[pk]"}[kernel]
        _, fn, args, out_shape = _entry(entries, entry)
        gflop, gbytes = lp.layer_cost_analysis(fn, args)
        out = fn(*args)
    n = left.shape[0]
    feats = args[0]
    nhwc = (n, feats.shape[2], feats.shape[3], feats.shape[1])
    if kernel == "corr":
        want = _ops.corr_flops(nhwc, MAX_DISP)
    elif kernel == "concat":
        want = 0
    elif kernel == "emit":
        layer = net.encoder3D.conv3D_1
        k = layer.k_left.shape[0] // 3
        la = nhwc[:3] + (3 * k,)
        want = (_ops.emit_flops(la, MAX_DISP)
                + _conv_flops(None, layer.k_left.shape, la)
                + _conv_flops(None, layer.k_right.shape, la[:3] + (6 * k,)))
    else:
        xp = args[0]
        k = net.packed3D["conv3D_2"].kernel0
        want = _ops.conv223_flops(tuple(xp.shape), tuple(k.shape), "kc")
    assert gflop * 1e9 == pytest.approx(want, rel=1e-12)
    nbytes = sum(a.numel() * a.element_size() for a in args
                 if isinstance(a, torch.Tensor))
    assert gbytes * 1e9 == nbytes + out.numel() * out.element_size()
    assert tuple(out.shape) == out_shape


# ------------------------------------------------------ profiler and table


def test_profile_stereo_layers_on_cpu():
    spec, _, params, left, right = _case("nvtiny", (34, 66), False)
    net = params_from_numpy(spec, params, device="cpu")
    l, r = torch.from_numpy(left), torch.from_numpy(right)
    rows, e2e = lp.profile_stereo_layers(net, l, r, n_lo=1, n_hi=2, reps=1)
    with torch.inference_mode():
        entries, _ = lp.stereo_layer_plan(net, l, r)
    assert [row.name for row in rows] == [n for n, *_ in entries]
    assert all(row.ms > 0 and row.gbytes > 0 for row in rows)
    assert e2e > 0
    assert sum(row.gflop for row in rows) > 0


def test_profile_check_raises_on_a_perturbed_plan(monkeypatch):
    spec, _, params, left, right = _case("resnet18_2d", HW_2D, True)
    net = params_from_numpy(spec, params, device="cpu")

    def perturbed_plan(net, left, right):
        entries = []

        def run(name, fn, *args):
            out = fn(*args)
            if name == "towers_resblock4":
                out = out + 1e-2
            entries.append((name, fn, args, tuple(out.shape)))
            return out
        return entries, net.layers(left, right, run)

    monkeypatch.setattr(lp, "stereo_layer_plan", perturbed_plan)
    with pytest.raises(RuntimeError, match="diverged"):
        lp.profile_stereo_layers(net, torch.from_numpy(left),
                                 torch.from_numpy(right), n_lo=1, n_hi=1,
                                 reps=1)


ROWS = [lp.LayerTime("towers_conv1", 0.5, (2, 32, 161, 513), 1.5, 0.02),
        lp.LayerTime("corr_cost_volume+softargmax", 0.02, (1, 161, 513),
                     0.25, 0.011)]


@pytest.mark.parametrize("with_peaks", [True, False])
def test_format_layer_table(with_peaks):
    peaks = lp.DevicePeaks(989.0, 3350.0, "NVIDIA H100 80GB HBM3")
    table = lp.format_layer_table(ROWS, 0.6e-3, peaks if with_peaks else None)
    lines = table.splitlines()
    assert lines[1].startswith("towers_conv1")   # slowest first
    assert any(line.startswith("sum of layers") for line in lines)
    assert lines[-1].startswith("end-to-end (eager)")
    for col in ("GFLOP", "MFU%", "xRL", "NVIDIA H100 80GB HBM3"):
        assert (col in table) == with_peaks
    if with_peaks:
        # 1.5 GFLOP in 0.5 ms is 3 TFLOP/s; the bound is 1.5 / 989 ms
        assert "3.00" in lines[1]


@pytest.mark.parametrize("name,want", [
    ("NVIDIA H100 80GB HBM3", (989.0, 3350.0)),
    ("NVIDIA H100 PCIe", (756.0, 2000.0)),
    ("NVIDIA A100-SXM4-80GB", None)])
def test_device_peaks(name, want, monkeypatch):
    assert lp.device_peaks("cpu") is None
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    peaks = lp.device_peaks("cuda")
    assert (None if peaks is None else (peaks.tflops, peaks.gbs)) == want
    if peaks is not None:
        assert peaks.name == name


def test_stereo_app_profile_layers(tmp_path, capsys):
    """`stereo_app --profile-layers` prints the table on the serving input
    form (s2d for ResNet18-2D's 3x3 stem)."""
    cv2 = pytest.importorskip("cv2")
    from redtail_tpu_torch.apps import stereo_app

    frame = np.random.RandomState(4).randint(0, 256, (34, 66, 3)).astype(
        np.uint8)
    cv2.imwrite(str(tmp_path / "l.png"), frame)
    cv2.imwrite(str(tmp_path / "r.png"), np.roll(frame, 2, axis=1))
    stereo_app.main(["resnet18_2d", "--cpu", "--hw", "34", "66",
                     "--no-cache", "--profile-layers", "--left",
                     str(tmp_path / "l.png"), "--right",
                     str(tmp_path / "r.png"), "--out", str(tmp_path / "d")])
    err = capsys.readouterr().err
    assert "corr_cost_volume+softargmax" in err
    assert "towers_conv1" in err and "(2, 32, 17, 33)" in err
    assert "end-to-end (eager)" in err
