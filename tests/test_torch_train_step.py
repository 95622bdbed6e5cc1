"""The stereo train step and its optimizers, on the CPU, against the JAX
package's.

- One step's loss and every gradient leaf against `jax.value_and_grad` of
  the JAX step's own loss (`redtail_tpu/parallel/training.py:loss_fn`: the
  params and images cast to the compute dtype, the forward under
  `plain_lowering()`, the correlation model's output scaled to pixels,
  `smooth_l1_disparity_loss` over the valid pixels), for ResNet18-2D and
  NVTiny, fp32 and bf16, from the same numpy params (`init_stereo_params`,
  biases randomized: zero biases hide boundary bugs; ResNet18-2D's
  residual-branch and feature-head weights scaled by 0.3 so its volume is
  O(1), as in `tests/test_torch_stereo.py`). Gates: fp32 within 1e-4 of
  each leaf's largest magnitude; bf16 per leaf relative L2 (|port - JAX| /
  |JAX|) below `BF16_REL_L2`, the loss within `BF16_LOSS_REL`; a leaf
  whose exact gradient is 0 (`ZERO_GRAD`) near 0 in both.
- Remat on and off give identical gradients.
- Adam, AdamW and SGD with momentum under warmup-cosine schedules: three
  updates on fixed gradients against optax, within 1e-6.
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from redtail_tpu.models import STEREO_SPECS as JSPECS
from redtail_tpu.models import stereo as jstereo
from redtail_tpu.ops.convolution import plain_lowering as jplain_lowering
from redtail_tpu.parallel.training import (
    smooth_l1_disparity_loss as jsmooth_l1)

from redtail_tpu_torch.models import STEREO_SPECS, init_stereo_params
from redtail_tpu_torch.models.stereo import params_to_numpy
from redtail_tpu_torch.parallel.training import (OptimizerSpec,
                                                 make_train_step,
                                                 smooth_l1_disparity_loss,
                                                 stereo_loss)
from redtail_tpu_torch.training.stereo import (StereoTrainConfig,
                                               train_stereo,
                                               warmup_cosine_decay_schedule)

CROP = (32, 64)
MAX_DISP = 4
# bf16 gates per gradient leaf and on the loss: both packages round every
# conv's fp32 sum once to bf16, in sums of another order, so a leaf's
# gradient moves by a few bf16 steps; measured maxima (these inputs, CPU,
# printed by the test under `pytest -s`):
# leaf relative L2 1.07e-2 (ResNet18-2D), 8.3e-3 (NVTiny); loss relative
# 2.1e-4 (ResNet18-2D), 2.6e-5 (NVTiny)
BF16_REL_L2 = 3e-2
BF16_LOSS_REL = 1e-3
# Leaves whose exact gradient is 0: a bias on the 3D models' last deconv
# shifts every disparity's cost alike, which leaves the soft-argmin
# unchanged. Both packages give rounding noise there (measured: JAX 1.3e-7
# in fp32, 1.6e-5 in bf16), held to a bound in place of the relative gate.
ZERO_GRAD = {"/decoder3D/deconv3D_3/biases": {"float32": 1e-6,
                                              "bfloat16": 1e-4}}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """A few intra-op threads: the tier-1 run puts six test workers on the
    cores, and oversubscribed CPU convs run an order of magnitude slower
    (restored after)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


def conditioned(params, seed=7):
    rs = np.random.RandomState(seed)

    def walk(node, path):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, f"{path}/{k}")
            elif k == "biases":
                out[k] = (rs.randn(*v.shape) * 0.1).astype(np.float32)
            elif path.endswith(("res_conv2", "encoder2D_out")):
                out[k] = (v * 0.3).astype(np.float32)
            else:
                out[k] = v
        return out
    return walk(params, "")


def _specs(name):
    kw = dict(input_hw=CROP, max_disp=MAX_DISP)
    return (dataclasses.replace(STEREO_SPECS[name], **kw),
            dataclasses.replace(JSPECS[name], **kw))


def _batch(seed=3):
    rs = np.random.RandomState(seed)
    left, right = (rs.rand(2, *CROP, 3).astype(np.float32) for _ in range(2))
    target = (rs.rand(2, *CROP) * 6).astype(np.float32)
    valid = (rs.rand(2, *CROP) > 0.3).astype(np.float32)
    return left, right, target, valid


def _jax_loss_and_grads(jspec, params, batch, compute_dtype):
    """The JAX step's own loss (`make_train_step.loss_fn`) and its grads
    with respect to the fp32 params."""
    left, right, target, valid = batch

    def loss_fn(p, left, right):
        if compute_dtype is not None:
            p = jax.tree_util.tree_map(lambda a: a.astype(compute_dtype), p)
            left, right = (a.astype(compute_dtype) for a in (left, right))
        with jplain_lowering():
            pred = jstereo.stereo_forward(jspec, p, left, right)
        if jspec.corr:
            pred = pred * jspec.input_hw[1]
        return jsmooth_l1(pred, target, valid)

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jp, left, right)
    return float(loss), jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), grads)


def _port_loss_and_grads(spec, params, batch, dtype, remat=True):
    init_fn, _ = make_train_step(spec, compute_dtype=dtype, device="cpu",
                                 remat=remat)
    state = init_fn(params)
    loss, _ = stereo_loss(spec, state.params, *batch, remat=remat)
    loss.backward()
    return float(loss.detach()), params_to_numpy(state.params, grads=True)


def _leaves(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}/{k}")
        else:
            yield f"{path}/{k}", v


@pytest.fixture(scope="module", params=["resnet18_2d", "nvtiny"])
def model(request):
    spec, jspec = _specs(request.param)
    params = conditioned(init_stereo_params(spec, seed=1))
    return spec, jspec, params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_loss_and_grads_match_jax(model, dtype):
    spec, jspec, params = model
    batch = _batch()
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = None if dtype == "float32" else jnp.bfloat16
    want_loss, want = _jax_loss_and_grads(jspec, params, batch, jdt)
    got_loss, got = _port_loss_and_grads(spec, params, batch, tdt)
    want, got = dict(_leaves(want)), dict(_leaves(got))
    assert sorted(got) == sorted(want)
    if dtype == "float32":
        assert abs(got_loss - want_loss) <= 1e-5 * max(1.0, abs(want_loss))
    else:
        assert abs(got_loss - want_loss) <= BF16_LOSS_REL * abs(want_loss)
    worst = 0.0
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, path
        if path in ZERO_GRAD:
            bound = ZERO_GRAD[path][dtype]
            assert np.abs(g).max() <= bound and np.abs(w).max() <= bound
        elif dtype == "float32":
            err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
            assert err <= 1e-4, (path, err)
            worst = max(worst, err)
        else:
            rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
            assert rel <= BF16_REL_L2, (path, rel)
            worst = max(worst, rel)
    # the readings behind the gates (pytest -s shows them)
    print(f"{spec.name} {dtype}: loss relative "
          f"{abs(got_loss - want_loss) / abs(want_loss):.2e}, worst leaf "
          f"{worst:.2e}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_gives_identical_grads(model, dtype):
    spec, _, params = model
    batch = _batch(seed=4)
    on = _port_loss_and_grads(spec, params, batch, dtype, remat=True)
    off = _port_loss_and_grads(spec, params, batch, dtype, remat=False)
    assert on[0] == off[0]
    for (path, a), (_, b) in zip(_leaves(on[1]), _leaves(off[1])):
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_step_updates_masters_and_reports_metrics():
    spec, _ = _specs("nvtiny")
    init_fn, step_fn = make_train_step(spec, OptimizerSpec("adam", 1e-3),
                                       device="cpu")
    state = init_fn(init_stereo_params(spec, seed=2))
    before = params_to_numpy(state.params)
    state, metrics = step_fn(state, *_batch())
    assert state.step == 1
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["epe"])
    after = params_to_numpy(state.params)
    # every kernel moves (deconv3D_3's bias has no gradient: ZERO_GRAD)
    for (path, a), (_, b) in zip(_leaves(before), _leaves(after)):
        assert path.endswith("biases") or not np.array_equal(a, b), path
    for p in state.params.parameters():
        assert p.dtype == torch.float32 and p.requires_grad


def test_smooth_l1_matches_jax():
    rs = np.random.RandomState(5)
    pred, target = (rs.randn(2, 6, 7).astype(np.float32) * 3
                    for _ in range(2))
    mask = (rs.rand(2, 6, 7) > 0.5).astype(np.float32)
    for delta in (1.0, 1e-9):
        for m in (None, mask):
            want = float(jsmooth_l1(pred, target, m, delta=delta))
            got = float(smooth_l1_disparity_loss(
                torch.from_numpy(pred), torch.from_numpy(target),
                None if m is None else torch.from_numpy(m), delta=delta))
            assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


def test_mesh_and_dtypes_raise(tmp_path, monkeypatch):
    """``mesh=`` builds a step: over a one-rank (1, 1) mesh it is the
    unsharded step (`tests/test_torch_parallel_train.py` runs 2 and 4
    ranks), and a device of another type than the mesh's (the card by
    default, CUDA faked available) raises; ``data_parallel`` beyond the
    ranks running raises, as JAX's does beyond its devices, and so does a
    dtype other than fp32 / bf16."""
    import torch.distributed as dist
    from redtail_tpu_torch.parallel import make_mesh

    spec, _ = _specs("nvtiny")
    params = init_stereo_params(spec, seed=2)
    init_fn, step_fn = make_train_step(spec, device="cpu")
    _, want = step_fn(init_fn(params), *_batch())
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(device_type="cpu")
        init_fn, step_fn = make_train_step(spec, mesh=mesh, device="cpu")
        state, got = step_fn(init_fn(params), *_batch())
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        with pytest.raises(ValueError, match="for a mesh on cpu"):
            make_train_step(spec, mesh=mesh)
    finally:
        dist.destroy_process_group()
    assert state.step == 1
    assert float(got["loss"]) == float(want["loss"])
    assert float(got["epe"]) == float(want["epe"])
    for kw, err in (({"dtype": "float16"}, ValueError),
                    ({"data_parallel": 2}, RuntimeError)):
        with pytest.raises(err, match="float32 or bfloat16|only 1 ranks"):
            train_stereo(StereoTrainConfig(**kw), dataset=None,
                         device="cpu")


# ------------------------------------------------------------ optimizers


def test_schedule_matches_optax():
    for init, peak, warm, decay in ((0.0, 1e-3, 3, 10), (0.0, 2e-4, 1, 2),
                                    (1e-5, 1e-3, 4, 9)):
        mine = warmup_cosine_decay_schedule(init, peak, warm, decay)
        ref = optax.warmup_cosine_decay_schedule(init, peak, warm, decay)
        for count in range(decay + 3):
            assert abs(mine(count) - float(ref(count))) <= 1e-9, count


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd"])
def test_optimizer_three_steps_match_optax(name):
    sched_args = (0.0, 1e-2, 2, 6)
    sched = warmup_cosine_decay_schedule(*sched_args)
    ref_sched = optax.warmup_cosine_decay_schedule(*sched_args)
    ref = {"adam": optax.adam(ref_sched),
           "adamw": optax.adamw(ref_sched, weight_decay=0.1),
           "sgd": optax.sgd(ref_sched, momentum=0.9)}[name]
    spec = OptimizerSpec(name, sched, weight_decay=0.1 if name == "adamw"
                         else 0.0, momentum=0.9 if name == "sgd" else 0.0)
    rs = np.random.RandomState(6)
    params = {"w": rs.randn(3, 4).astype(np.float32),
              "b": rs.randn(5).astype(np.float32)}
    grads = [{k: rs.randn(*v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = ref.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt, lr = spec.build(tp.values())
    for i, g in enumerate(grads):
        updates, state = ref.update(
            jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        lr.step()
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=1e-6,
                                       err_msg=f"{name} step {i} {k}")
    # the first update ran at the warmup's lr 0: optax reads the count
    # before it increments it, and so does the LambdaLR
    assert sched(0) == 0.0
