"""TrailNet training, on the CPU, against the JAX package's.

- `trail_loss` and its gradient against JAX's, within 1e-6.
- The augmentation's deterministic warp (`augment_warp`) against JAX's
  `augment_sample` on JAX's own draws, recomputed here from the key as the
  JAX function draws them (the port's `torch.Generator` gives other
  numbers). Gate 1e-5: both compute the same float32 arithmetic; the
  bilinear weights are continuous where a floor flips.
- One train step's loss and every gradient leaf of the native SResNet-18
  (the repo's trained w8 weights, so the softmax does not saturate) against
  `jax.value_and_grad` of the JAX step's loss, without augmentation: within
  1e-4 of each leaf's largest magnitude (fp32 on both sides, the convs'
  summation order through 20 layers).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from redtail_tpu.models import trailnet as jtrailnet
from redtail_tpu.training import trailnet as jtrain

from redtail_tpu_torch.models.trailnet import params_from_w8_npz
from redtail_tpu_torch.training.trailnet import (augment_batch,
                                                 augment_draws,
                                                 augment_warp,
                                                 make_trailnet_train_step,
                                                 trail_loss, trailnet_loss)

TRAILNET_W8 = Path(__file__).resolve().parent / "data" / \
    "trailnet_synth_trained.npz"
HW = (180, 320)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """A few intra-op threads: the tier-1 run puts six test workers on the
    cores, and oversubscribed CPU convs run an order of magnitude slower
    (restored after)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("label_eps", [0.0, 0.1])
@pytest.mark.parametrize("scale", [1.0, 8.0])
def test_trail_loss_and_grad_match_jax(label_eps, scale):
    rs = np.random.RandomState(int(scale * 10 + label_eps * 100))
    logits = (rs.randn(7, 3) * scale).astype(np.float32)
    labels = rs.randint(0, 3, 7).astype(np.int32)
    kw = dict(ent_scale=0.01, p_scale=0.0001, label_eps=label_eps)
    want, want_g = jax.value_and_grad(
        lambda z: jtrain.trail_loss(z, jnp.asarray(labels), **kw))(
        jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_()
    got = trail_loss(z, torch.from_numpy(labels), **kw)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-6 * max(1.0, abs(float(want)))
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(want_g), rtol=0,
                               atol=1e-6)


def _jax_draws(key, h, w, *, scale_max=1.2, rotate_deg=15.0,
               color_jitter=0.25):
    """The draws `redtail_tpu.training.trailnet.augment_sample` makes from
    ``key``, in the port's `augment_draws` form (batch of one)."""
    k = jax.random.split(key, 6)
    one = lambda a: torch.from_numpy(np.array(a))[None]  # noqa: E731
    return {
        "scale": one(jax.random.uniform(k[0], (), minval=1.0,
                                        maxval=scale_max)),
        "oy": one(jax.random.randint(k[1], (), 0, h)),
        "ox": one(jax.random.randint(k[2], (), 0, w)),
        "angle": one(jax.random.uniform(k[3], (), minval=-rotate_deg,
                                        maxval=rotate_deg)),
        "flip": one(jax.random.bernoulli(k[4])),
        "bc": one(jax.random.uniform(k[5], (2,), minval=1 - color_jitter,
                                     maxval=1 + color_jitter)),
    }


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("mode,top_cut", [("hflip3", 0.0), ("hflip5", 0.2)])
def test_augment_warp_matches_jax_on_its_draws(seed, mode, top_cut):
    h, w = 36, 64
    rs = np.random.RandomState(seed)
    img = rs.rand(h, w, 3).astype(np.float32)
    n_cls = 3 if mode == "hflip3" else 5
    label = rs.randint(0, n_cls, 2).astype(np.int32)  # both heads
    key = jax.random.PRNGKey(seed)
    want_img, want_lab = jtrain.augment_sample(
        key, jnp.asarray(img), jnp.asarray(label), top_cut=top_cut,
        hflip_mode=mode)
    got_img, got_lab = augment_warp(
        torch.from_numpy(img)[None], torch.from_numpy(label)[None],
        _jax_draws(key, h, w), top_cut=top_cut, hflip_mode=mode)
    np.testing.assert_allclose(got_img[0].numpy(), np.asarray(want_img),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got_lab[0].numpy(), np.asarray(want_lab))


def test_augment_batch_draws_from_the_generator():
    imgs = torch.rand(4, 24, 40, 3, generator=torch.Generator().manual_seed(0))
    labels = torch.tensor([0, 1, 2, 0])
    outs = [augment_batch(torch.Generator().manual_seed(s), imgs, labels)
            for s in (1, 1, 2)]
    assert torch.equal(outs[0][0], outs[1][0])
    assert not torch.equal(outs[0][0], outs[2][0])
    for img, lab in outs:
        assert img.shape == imgs.shape and lab.shape == labels.shape
        assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0
    draws = augment_draws(torch.Generator().manual_seed(3), 1000, 24, 40)
    assert 1.0 <= float(draws["scale"].min()) <= float(draws["scale"].max()) \
        < 1.2
    assert 0.3 < float(draws["flip"].float().mean()) < 0.7




def test_train_step_loss_and_grads_match_jax():
    tree = params_from_w8_npz(TRAILNET_W8)
    rs = np.random.RandomState(1)
    images = rs.randint(0, 256, (2,) + HW + (3,)).astype(np.float32)
    rot, off = np.array([0, 2], np.int32), np.array([1, 0], np.int32)

    def jloss(params):
        lg_rot, lg_off = jtrailnet.trailnet_forward(params, images,
                                                    return_logits=True)
        return (jtrain.trail_loss(lg_rot, jnp.asarray(rot))
                + jtrain.trail_loss(lg_off, jnp.asarray(off)))

    want, want_g = jax.jit(jax.value_and_grad(jloss))(
        jax.tree_util.tree_map(jnp.asarray, tree))

    init_fn, _ = make_trailnet_train_step(augment=False, device="cpu")
    state = init_fn(tree)
    loss, (l1, l2) = trailnet_loss(state.params, torch.from_numpy(images),
                                   torch.from_numpy(rot),
                                   torch.from_numpy(off))
    loss.backward()
    assert abs(float(loss.detach()) - float(want)) <= 1e-5 * max(
        1.0, abs(float(want)))
    net = state.params
    for name, g in want_g.items():
        for key, attr in (("w", net.weight), ("b", net.bias)):
            got = attr[name].grad
            if got.dim() == 4:
                got = got.permute(2, 3, 1, 0)
            elif got.dim() == 2:
                got = got.t()
            w = np.asarray(g[key])
            err = np.abs(got.numpy() - w).max() / max(np.abs(w).max(), 1e-30)
            assert err <= 1e-4, (name, key, err)


def test_train_step_with_augmentation_updates():
    tree = params_from_w8_npz(TRAILNET_W8)
    rs = np.random.RandomState(2)
    images = rs.randint(0, 256, (4,) + HW + (3,)).astype(np.float32)
    labels = np.array([0, 1, 2, 1], np.int32)
    from redtail_tpu_torch.parallel.training import OptimizerSpec
    init_fn, step_fn = make_trailnet_train_step(
        OptimizerSpec("sgd", 1e-2, momentum=0.9), augment=True, device="cpu")
    state = init_fn(tree)
    before = state.params.weight["conv1"].detach().clone()
    gen = torch.Generator().manual_seed(0)
    losses = []
    for _ in range(3):
        state, m = step_fn(state, gen, images, labels, labels)
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1])
    assert state.step == 3 and state.params.weight["conv1"].requires_grad
    assert not torch.equal(before, state.params.weight["conv1"].detach())
