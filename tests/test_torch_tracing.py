"""The port's trace spans (`runtime/profiler.py:span`), on the CPU: with no
profiler collecting they enter no `record_function`; under
`torch.profiler` the serving node's stages (pack, dispatch with its upload
and enqueue, fetch), the stereo net's five stages and the train step's
three phases appear as ``user_annotation`` events, each inside its parent.
The net's stages are checked on every path a node serves (ResNet-18 3D's
and NVSmall's fused and packed heads, the int8 stem, the correlation
model), each path yielding its stages once a forward, in forward order."""

import contextlib
import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from redtail_tpu_torch.models import STEREO_SPECS, init_stereo_params
from redtail_tpu_torch.models import stereo as pstereo
from redtail_tpu_torch.models.stereo import layer_stage
from redtail_tpu_torch.ops.convolution import packed3d_lowering
from redtail_tpu_torch.parallel.training import make_train_step
from redtail_tpu_torch.runtime import StageProfiler, StereoNode
from redtail_tpu_torch.runtime import profiler as rprof

HW, MAX_DISP = (33, 65), 8
STAGES_3D = ("stereo/towers", "stereo/volume", "stereo/enc3d",
             "stereo/dec3d", "stereo/head")
STAGES_CORR = ("stereo/towers", "stereo/volume", "stereo/head")
PHASES = ("train/forward", "train/backward", "train/optimizer")

@contextlib.contextmanager
def _dfold():
    """The packed head's last deconv D-folded with the soft-argmin fused,
    as the card runs it (off the card under ``REDTAIL_TPU_DFOLD=1``)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REDTAIL_TPU_DFOLD", "1")
        yield


# path -> (model, the lowerings that select it, quantize, a layer that
# shows the path ran)
FORMS = {
    "batch": ("resnet18", (), None, "towers_conv1"),
    "nvsmall": ("nvsmall", (), None, "cost_volume+conv3D_1"),
    "nvsmall+packed": ("nvsmall", (packed3d_lowering, _dfold), None,
                       "deconv3D_3+softargmin[pk]"),
    "packed": ("resnet18", (packed3d_lowering,), None,
               "cost_volume+conv3D_1a[pk]"),
    "packed+dfold": ("resnet18", (packed3d_lowering, _dfold), None,
                     "deconv3D_5+softargmin[pk]"),
    "int8": ("resnet18", (), "int8", "towers_conv1"),
    "corr": ("resnet18_2d", (), None, "corr_cost_volume+softargmax"),
}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two intra-op threads: the tier-1 run puts six test workers on the
    cores (restored after)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in ("REDTAIL_TPU_PACKED3D", "REDTAIL_TPU_DFOLD",
                "REDTAIL_TPU_S2D"):
        monkeypatch.delenv(var, raising=False)


def _spec(model):
    return dataclasses.replace(STEREO_SPECS[model], input_hw=HW,
                               max_disp=MAX_DISP)


def _frames(seed=3):
    rs = np.random.RandomState(seed)
    return tuple(rs.randint(0, 256, HW + (3,)).astype(np.uint8)
                 for _ in range(2))


def _node(form, overlap):
    model, _, quantize, _ = FORMS[form]
    spec = _spec(model)
    return StereoNode(spec, init_stereo_params(spec, seed=1),
                      dtype=torch.float32, device="cpu", overlap=overlap,
                      quantize=quantize,
                      calib_frames=[_frames(5)] if quantize else None)


def _lowered(form):
    stack = contextlib.ExitStack()
    for lowering in FORMS[form][1]:
        stack.enter_context(lowering())
    return stack


def _train_batch(seed=4):
    rs = np.random.RandomState(seed)
    left, right = (rs.rand(2, *HW, 3).astype(np.float32) for _ in range(2))
    target = (rs.rand(2, *HW) * 6).astype(np.float32)
    valid = (rs.rand(2, *HW) > 0.3).astype(np.float32)
    return left, right, target, valid


def _spans(fn, tmp_path):
    """``fn()``'s result and the (name, start, end) of every
    ``user_annotation`` in its `torch.profiler` trace, by start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in events
                   if e.get("cat") == "user_annotation")
    return out, [(n, a, b) for a, b, n in spans]


def _named(spans, name):
    found = [s for s in spans if s[0] == name]
    assert found, f"no span {name!r} in {[s[0] for s in spans]}"
    return found


def _inside(child, parent) -> bool:
    return parent[1] <= child[1] and child[2] <= parent[2]


def _stages_in(spans, parent):
    """The names of the ``stereo/*`` spans inside ``parent``, in order."""
    return [s[0] for s in spans
            if s[0].startswith("stereo/") and s[0].count("/") == 1
            and _inside(s, parent)]


def _step(remat):
    spec = _spec("resnet18")
    init_fn, step_fn = make_train_step(spec, device="cpu", remat=remat)
    state = init_fn(init_stereo_params(spec, seed=1))
    return lambda: step_fn(state, *_train_batch())


def test_span_is_a_shared_no_op_without_a_profiler():
    assert not rprof.tracing()
    assert rprof.span("a") is rprof.span("b")
    with profile(activities=[ProfilerActivity.CPU]):
        assert rprof.tracing()
        assert isinstance(rprof.span("a"), rprof.record_function)


@pytest.mark.parametrize("what", ["node", "train_step"])
def test_no_profiler_enters_no_record_function(monkeypatch, what):
    def refuse(name, *args):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(rprof, "record_function", refuse)
    if what == "node":
        node = _node("batch", overlap=1)
        for _ in range(2):
            node(*_frames(), stamp=0.0)
        assert "stereo/resnet18/enqueue" in node.profiler.stats()
    else:
        _step(remat=True)()
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="entered"):
            StageProfiler().stage("x").__enter__()


@pytest.mark.parametrize("overlap", [0, 1])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_node_spans_nest(monkeypatch, tmp_path, form, overlap):
    node = _node(form, overlap)
    name = f"stereo/{node.spec.name}"
    frames = _frames()
    layers = []

    def stage_of(spec, layer):
        layers.append(layer)
        return layer_stage(spec, layer)
    monkeypatch.setattr(pstereo, "layer_stage", stage_of)
    with _lowered(form):
        first = node(*frames, stamp=0.0)
        out, spans = _spans(lambda: node(*frames, stamp=1.0), tmp_path)
        assert FORMS[form][3] in layers
        if overlap:  # the traced dispatch's result comes a call later
            last = node(*frames, stamp=2.0)
            assert first is None and (out.stamp, last.stamp) == (0.0, 1.0)
            first, out = out.data, last.data
    # the spans change nothing of what the node computes
    np.testing.assert_array_equal(out, first)
    parent = _named(spans, f"{name}/dispatch" if overlap else name)
    assert len(parent) == 1
    _named(spans, f"{name}/pack")
    if overlap:
        _named(spans, f"{name}/fetch")
    (upload,), (enqueue,) = (_named(spans, f"{name}/{s}")
                             for s in ("upload", "enqueue"))
    assert _inside(upload, parent[0]) and _inside(enqueue, parent[0])
    assert upload[2] <= enqueue[1]
    stages = STAGES_CORR if node.spec.corr else STAGES_3D
    assert _stages_in(spans, enqueue) == list(stages)
    assert set(node.profiler.stats()) >= {f"{name}/upload",
                                          f"{name}/enqueue"}


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
def test_train_step_spans_nest(tmp_path, remat):
    step = _step(remat)
    step()
    _, spans = _spans(step, tmp_path)
    phases = [_named(spans, p) for p in PHASES]
    assert [len(p) for p in phases] == [1, 1, 1]
    (fwd,), (bwd,), (opt,) = phases
    assert fwd[2] <= bwd[1] and bwd[2] <= opt[1]
    assert _stages_in(spans, fwd) == list(STAGES_3D)
    # the remat recompute re-enters the net's stages inside the backward
    recompute = _stages_in(spans, bwd)
    if remat:
        assert recompute and recompute == list(STAGES_3D[:len(recompute)])
    else:
        assert recompute == []


@pytest.mark.parametrize("how", ["stage", "record"])
def test_stage_profiler_caps_its_samples(how):
    prof = StageProfiler()
    prof.MAX_SAMPLES = 3
    for _ in range(5):
        if how == "stage":
            with prof.stage("a"):
                pass
        else:
            prof.record("a", 0.001)
    assert prof.stats()["a"]["count"] == 3
