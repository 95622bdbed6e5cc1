"""The port's `apps/train_trailnet_synth.py` against the JAX package's
`tools/train_trailnet_synth.py`, on the CPU: `render_batch` bit-equal; the
rate the optimizer applies at every step optax's
`warmup_cosine_decay_schedule`; the losses of steps from the JAX package's
initial tree (saturated: its gradients carry ~1% rounding) and from the
committed trained tree (an update with the peak rate) within 1e-4 relative
of JAX's `make_trailnet_train_step`; held-out accuracy identical; the w8
artifact bit-equal and read across packages; the CLI's JSON lines, its
gate, and a run in a child process where ``jax`` and ``redtail_tpu``
cannot be imported. (The r18 tool and both committed artifacts' guards
are in `tests/test_torch_synth_tools.py`.)

Torch is held to two threads (the file runs beside others under xdist).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from redtail_tpu_torch.apps import train_trailnet_synth as trail
from redtail_tpu_torch.models import trailnet as ptrail
from test_torch_synth_tools import (_NO_JAX, ROOT, TRAIL_NPZ,
                                    _assert_trees_bit_equal, _lines, _tool)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jax_init_tree():
    """The JAX package's initial TrailNet tree (seed 0) as numpy: ~10 s of
    eager `jax.random` on this CPU, so drawn once for the file."""
    import jax

    from redtail_tpu.models.trailnet import init_trailnet_params

    return jax.tree_util.tree_map(np.asarray, jax.device_get(
        init_trailnet_params(jax.random.PRNGKey(0))))


def _trained_tree():
    from redtail_tpu.models.trailnet import params_from_w8_npz

    return params_from_w8_npz(TRAIL_NPZ)


def test_render_batch_bit_equal():
    from redtail_tpu.apps.sim_app import Trail as JTrail
    from redtail_tpu_torch.apps.sim_app import Trail

    got = trail.render_batch(Trail(), np.random.RandomState(5), 3)
    want = _tool("train_trailnet_synth").render_batch(
        JTrail(), np.random.RandomState(5), 3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("start,steps", [("jax_init", 2), ("trained", 3)])
def test_steps_match_jax(monkeypatch, request, start, steps):
    """``steps`` steps at batch 2 on the same rendered batches as JAX's
    loop: each loss within 1e-4 relative of JAX's, and the rate the
    optimizer applied at every step optax's schedule within 1e-6 relative
    (optax computes it in float32). The first update has rate 0; from the
    trained tree the third step's loss shows the second update's, at the
    peak rate."""
    import jax
    import jax.numpy as jnp
    import optax

    from redtail_tpu.apps.sim_app import Trail as JTrail
    from redtail_tpu.training.trailnet import \
        make_trailnet_train_step as jax_step
    from redtail_tpu_torch.training import trailnet as ttrail

    batch, lr = 2, 2e-3
    tree = (request.getfixturevalue("jax_init_tree") if start == "jax_init"
            else _trained_tree())

    rates = []
    real = ttrail.make_trailnet_train_step

    def recording(*a, **kw):
        init_fn, step_fn = real(*a, **kw)

        def step(state, *rest):
            rates.append(state.opt_state.param_groups[0]["lr"])
            return step_fn(state, *rest)
        return init_fn, step
    monkeypatch.setattr(ttrail, "make_trailnet_train_step", recording)
    args = trail.parse_args(["--steps", str(steps), "--batch", str(batch),
                             "--cpu"])
    _, losses = trail.train(args, init_params=tree)

    sched = optax.warmup_cosine_decay_schedule(0.0, lr, max(1, steps // 10),
                                               steps)
    np.testing.assert_allclose(rates, [float(sched(k)) for k in
                                       range(steps)], rtol=1e-6, atol=0)
    init_fn, step_fn = jax_step(optax.sgd(sched, momentum=0.9),
                                augment=False)
    state = init_fn(tree)
    render = _tool("train_trailnet_synth").render_batch
    rng, key, want = np.random.RandomState(0), jax.random.PRNGKey(1), []
    for _ in range(steps):
        imgs, views, sides = render(JTrail(), rng, batch)
        key, sub = jax.random.split(key)
        state, m = step_fn(state, sub, jnp.asarray(imgs), jnp.asarray(views),
                           jnp.asarray(sides))
        want.append(float(m["loss"]))
    np.testing.assert_allclose([float(x) for x in losses], want, rtol=1e-4,
                               atol=0)


def test_heldout_accuracy_identical():
    """The committed weights' held-out accuracy on 8 views, seed 0: the
    port's function against the JAX tool's loop (jitted forward)."""
    import jax
    import jax.numpy as jnp

    from redtail_tpu.apps.sim_app import Trail as JTrail
    from redtail_tpu.models.trailnet import trailnet_forward

    net = ptrail.params_from_numpy(ptrail.params_from_w8_npz(TRAIL_NPZ),
                                   device="cpu")
    got = trail.heldout_accuracy(net, 0, 8, 4)
    params, fwd = _trained_tree(), jax.jit(trailnet_forward)
    render = _tool("train_trailnet_synth").render_batch
    rng, hits_v, hits_s = np.random.RandomState(1000), 0, 0
    for _ in range(2):
        imgs, views, sides = render(JTrail(), rng, 4)
        probs = np.asarray(fwd(params, jnp.asarray(imgs)), np.float32)
        hits_v += int((probs[:, :3].argmax(-1) == views).sum())
        hits_s += int((probs[:, 3:].argmax(-1) == sides).sum())
    assert got == (hits_v / 8, hits_s / 8)
    assert min(got) >= 0.75  # trained weights: not a chance agreement


def test_w8_artifact_bit_equal_to_jax(tmp_path, jax_init_tree):
    """JAX's initial tree written by both packages' `params_to_w8_npz`:
    the same arrays bit for bit; each package reads the other's file to
    the same tree."""
    from redtail_tpu.models.trailnet import params_from_w8_npz as jax_read
    from redtail_tpu.models.trailnet import params_to_w8_npz as jax_write

    ptrail.params_to_w8_npz(jax_init_tree, tmp_path / "port.npz")
    jax_write(jax_init_tree, tmp_path / "jax.npz")
    with np.load(tmp_path / "port.npz") as got, \
            np.load(tmp_path / "jax.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    _assert_trees_bit_equal(ptrail.params_from_w8_npz(tmp_path / "jax.npz"),
                            jax_read(tmp_path / "port.npz"))


@pytest.mark.parametrize("gate", [0.0, 1.1], ids=["passes", "fails"])
def test_trailnet_tool_end_to_end(tmp_path, capsys, gate):
    """Two steps at batch 2 on the CPU: the JAX tool's JSON lines; a
    passing gate writes a w8 artifact JAX's loader reads, a failing one
    exits 1 and writes nothing."""
    from redtail_tpu.models.trailnet import params_from_w8_npz as jax_read

    out = tmp_path / "trail.npz"
    rc = trail.main(["--steps", "2", "--batch", "2", "--eval-n", "4",
                     "--acc-gate", str(gate), "--cpu", "--out", str(out)])
    lines = _lines(capsys.readouterr().out)
    assert set(lines[0]) == {"step", "loss"} and lines[0]["step"] == 2
    assert set(lines[1]) == {"eval_view_acc", "eval_side_acc"}
    if gate > 1:
        assert rc == 1 and not out.exists()
        assert lines[2] == {"error": "accuracy gate failed", "gate": gate}
        return
    assert rc == 0 and lines[2] == {"params": str(out),
                                    "bytes": out.stat().st_size}
    _assert_trees_bit_equal(ptrail.params_from_w8_npz(out), jax_read(out))


def test_tool_runs_without_jax(tmp_path):
    out = str(tmp_path / "out.npz")
    argv = ["--steps", "2", "--batch", "1", "--eval-n", "2", "--acc-gate",
            "0", "--cpu", "--out", out]
    code = (_NO_JAX + "from redtail_tpu_torch.apps import "
            f"train_trailnet_synth; sys.exit(train_trailnet_synth.main("
            f"{argv!r}))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert _lines(proc.stdout)[-1] == {"params": out,
                                       "bytes": Path(out).stat().st_size}
