"""Channel-packed 3D convolutions (`redtail_tpu/ops/packed3d.py`): D and H
pairs folded into channels.

The packed 3D head (`models/stereo.py`, under `packed3d_lowering()`) runs
the 3D stack of NVTiny, NVSmall and ResNet-18 3D on these layouts, as the
JAX package's accelerator configuration does. Every op is exact against its
unpacked counterpart (`tests/test_torch_packed3d.py` holds each against its
JAX twin).

- **Pair conventions.** A packed axis is *aligned* (slot a holds originals
  (2a, 2a + 1)) or *shifted* (slot a holds (2a - 1, 2a), one extra slot,
  boundary slots zero). A stride-1 conv consuming one convention emits the
  other with 2 taps per packed axis (band t = 2s + q - r both ways, only the
  padding differs). Channel groups are (ph, pd, c) on both sides.
- **Downsamples** consume aligned pairs: 3 taps at stride 2 along D (both
  output parities in channels), 2 taps along packed H.
- **Transposed convs** are one lhs-dilated conv emitting an aligned packed
  output. PyTorch has no lhs dilation, so `_conv` computes an lhs-dilated
  conv exactly as `F.conv_transpose3d` with stride = the dilation and the
  kernel flipped and in/out swapped, then crops or zero-pads each axis to
  the JAX padding.
- **Unpacks** are exact permutes and reshapes here; on the TPU they were
  identity-weight lhs-dilated convs, which compute the same function.

Band algebra (k=3 TF-SAME; o = output original index, i = input, q/r =
input/output parity in channels, s = kernel tap):
  conv    : i = sigma*o - lo + t
  deconv  : o = 2*i - lo + t
with i = 2*slot + q (aligned) or 2*slot + q - 1 (shifted); solve t per
(s, q, r); entries outside t in [0, 2] are zero blocks.

Each op takes the JAX function's arguments (NDHWC activations, DHWIO
weights) and, as ``kernel=``, optionally its band-composed kernel already
in the conv's weight layout (`prepare`): the model derives those once, at
load. The in-shifted, H-packed stride-1 conv (the head's conv3D_2 /
conv3D_1b) runs the CUDA kernel `kernels/conv223.py` on the card; every
other conv is cuDNN's on fp32 carriers, TF32 off for fp32 and allowed for
bf16, its sum plus bias rounded once (`ops/convolution.py`). The model
holds those kernels widened to fp32 at load.

Masks that zero a padding slot take one of the JAX package's two forms
(`mask_form`, a scope as in JAX): ``'where'``, here an in-place slice
assignment of zeros, or ``'mul'``, an in-place multiply by a constant 0/1
mask of the axis and channels (built once per shape and device). Both give
the same values on finite inputs (``'mul'`` leaves -0.0 where a negative
value is masked, as JAX's does). ``'auto'``, the default, takes each call
site's form in the JAX package: ``'mul'`` for the shifted-out masks of the
aligned-in stride-1 conv, ``'where'`` elsewhere.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from redtail_tpu_torch.kernels.conv223 import conv223, kernel_weights
from redtail_tpu_torch.ops.convolution import (_fp32_accumulate,
                                               tf_same_padding)
from redtail_tpu_torch.ops.halo import (empty_shard, fetch, halo_rows,
                                       image_sharding, window_size)

Pads = Sequence[Tuple[int, int]]


# ------------------------------------------------------------ helpers


def _A(table: Callable[[int, int, int], int], S: int, Q: int,
       R: int) -> np.ndarray:
    """Band tensor A[s, q, r, t] from a callable t(s, q, r)."""
    A = np.zeros((S, Q, R, 3), np.float32)
    for s in range(S):
        for q in range(Q):
            for r in range(R):
                t = table(s, q, r)
                if 0 <= t <= 2:
                    A[s, q, r, t] = 1.0
    return A


_A_ID = _A(lambda s, q, r: s, 3, 1, 1)   # plain 3-tap axis
_A2 = _A(lambda s, q, r: 2 * s + q - r, 2, 2, 2)   # stride-1 pair axis


def _kernel(w: torch.Tensor, A_d, A_h, A_w, *,
            transposed: bool = False) -> torch.Tensor:
    """Compose per-axis bands into one conv kernel.

    w: (3, 3, 3, Ci, Co) forward or (3, 3, 3, Co, Ci) transposed (TF
    VRSCK). Returns the DHWIO (Sd, Sh, Sw, Qh*Qd*Ci, Rh*Rd*Co): channel
    groups (ph, pd, c) on both sides (W never packs). Every entry is one
    weight or zero, so composing in fp32 and casting is exact."""
    bands = [torch.from_numpy(a).to(w.device) for a in (A_d, A_h, A_w)]
    wf = "tuvoi" if transposed else "tuvio"
    k = torch.einsum(f"aqrt,bpsu,exyv,{wf}->abepqisro", *bands, w.float())
    Sd, Sh, Sw, qh, qd, ci, rh, rd, co = k.shape
    return k.reshape(Sd, Sh, Sw, qh * qd * ci, rh * rd * co).to(w.dtype)


def prepare(k: torch.Tensor, form: str) -> torch.Tensor:
    """A DHWIO band kernel in the layout its conv takes: ``"conv"``
    `F.conv3d`'s (O, I, kd, kh, kw), ``"lhs_dilated"``
    `F.conv_transpose3d`'s (I, O, kd, kh, kw) with the taps flipped, both
    in `torch.channels_last_3d` memory; ``"conv223"`` the CUDA kernel's
    K-major (2, 2, 3, K, C) (`kernels/conv223.py:kernel_weights`;
    `contract_weights` gives back the DHWIO (2, 2, 3, C, K))."""
    if form == "conv223":
        return kernel_weights(k)
    if form == "conv":
        wt = k.permute(4, 3, 0, 1, 2)
    elif form == "lhs_dilated":
        wt = k.flip(0, 1, 2).permute(3, 4, 0, 1, 2)
    else:
        raise ValueError(f"unknown kernel form {form!r}")
    return wt.contiguous(memory_format=torch.channels_last_3d)


def _conv(x: torch.Tensor, wt: torch.Tensor, strides, pads: Pads,
          dil=(1, 1, 1), *, rows: int) -> torch.Tensor:
    """`lax.conv_general_dilated` over NDHWC ``x``: window strides, per-axis
    (lo, hi) pads (negative ones crop) and lhs dilation ``dil``; ``wt`` in
    the `prepare` form the dilation needs. Runs on fp32 carriers (TF32
    allowed for a bf16 ``x``, exact in its products) and returns the NDHWC
    fp32 sum, unrounded: `_bias` rounds it once. ``rows``: the global size
    of axis 2 (H or its slots); inside an image `sharded_axis` the conv
    returns this rank's rows of its output (`halo_rows`)."""
    sh = image_sharding()
    if sh is not None:
        pads = list(pads)
        x, pads[1], (a, b) = halo_rows(x, sh, 2, global_size=rows,
                                       k=wt.shape[3], s=strides[1],
                                       pads=pads[1], dil=dil[1])
        if b == a:
            c = wt.shape[0] if all(d == 1 for d in dil) else wt.shape[1]
            return empty_shard(x, (x.shape[0], window_size(
                x.shape[1], wt.shape[2], strides[0], pads[0], dil[0]), 0,
                window_size(x.shape[3], wt.shape[4], strides[2], pads[2],
                            dil[2]), c), torch.float32)
    xc = x.permute(0, 4, 1, 2, 3)
    if all(d == 1 for d in dil):
        if all(lo == hi >= 0 for lo, hi in pads):
            pad = tuple(lo for lo, _ in pads)
        else:
            xc = F.pad(xc, [p for pair in reversed(pads) for p in pair])
            pad = 0
        with _fp32_accumulate(xc):
            out = F.conv3d(xc.float(), wt.float(), stride=tuple(strides),
                           padding=pad)
        return out.permute(0, 2, 3, 4, 1)
    if tuple(strides) != (1, 1, 1):
        raise ValueError("lhs-dilated convs take window strides 1")
    # out[o] = sum_t k[t] x_dil[o + t - lo] = full[o + K - 1 - lo], where
    # full = conv_transpose(x, flip(k), stride=dil) without padding
    with _fp32_accumulate(xc):
        full = F.conv_transpose3d(xc.float(), wt.float(), stride=tuple(dil))
    crop = []
    for n_in, ksz, L, (lo, hi), n_full in zip(
            xc.shape[2:], wt.shape[2:], dil, pads, full.shape[2:]):
        start = ksz - 1 - lo
        n_out = (n_in - 1) * L + 1 + lo + hi - ksz + 1
        crop.append((-start, n_out + start - n_full))
    out = F.pad(full, [p for pair in reversed(crop) for p in pair])
    return out.permute(0, 2, 3, 4, 1)


def _bias(out: torch.Tensor, b: Optional[torch.Tensor], groups: int,
          dtype: torch.dtype) -> torch.Tensor:
    """The group-tiled bias added in fp32, then one cast to ``dtype``."""
    if b is None:
        return out.to(dtype)
    return (out.float() + b.float().repeat(groups)).to(dtype)


def _pd_groups(c: int, co: int, pd: int) -> List[Tuple[int, int]]:
    """Channel ranges of the groups with depth parity ``pd``."""
    return [(g * co, (g + 1) * co) for g in range(c // co) if g % 2 == pd]


MASK_FORMS = ("auto", "where", "mul")
_MASK_FORM = contextvars.ContextVar("redtail_torch_mask_form",
                                    default="auto")


@contextlib.contextmanager
def mask_form(form: str):
    """The pad-slot mask form of the ops issued inside the block:
    ``'where'``, ``'mul'`` or ``'auto'`` (each call site's JAX form),
    per scope, so a model can set it per layer."""
    if form not in MASK_FORMS:
        raise ValueError(f"mask form must be one of {MASK_FORMS}, got "
                         f"{form!r}")
    token = _MASK_FORM.set(form)
    try:
        yield
    finally:
        _MASK_FORM.reset(token)


def _mask_const(n_ax: int, c: int, slot: int,
                ranges: Tuple[Tuple[int, int], ...], device: torch.device,
                dtype: torch.dtype) -> torch.Tensor:
    """The 'mul' form's constant: ones, with zeros at ``slot`` of the axis
    in the channel ``ranges``; (n_ax, c). Made once per shape and device;
    while a graph is traced (`torch.export`: fake tensors) made afresh,
    so no traced tensor is kept."""
    if torch._guards.detect_fake_mode() is not None:
        return _make_mask(n_ax, c, slot, ranges, device, dtype)
    return _cached_mask(n_ax, c, slot, ranges, device, dtype)


def _make_mask(n_ax, c, slot, ranges, device, dtype) -> torch.Tensor:
    m = torch.ones(n_ax, c, dtype=dtype, device=device)
    for lo, hi in ranges:
        m[slot, lo:hi] = 0
    return m


_cached_mask = functools.lru_cache(maxsize=256)(_make_mask)


def _mask_slot(y: torch.Tensor, axis: int, slot: int,
               ranges: Sequence[Tuple[int, int]],
               auto: str = "where") -> None:
    """Zero the channel ``ranges`` of one index of ``axis`` of NDHWC
    ``y``, in place, in the form `mask_form` sets (``auto``: this call
    site's)."""
    form = _MASK_FORM.get()
    if form == "auto":
        form = auto
    if form == "mul":
        m = _mask_const(y.shape[axis], y.shape[-1], slot,
                        tuple(map(tuple, ranges)), y.device, y.dtype)
        shape = [1] * y.dim()
        shape[axis], shape[-1] = m.shape
        y.mul_(m.reshape(shape))
        return
    view = y.select(axis, slot)
    for lo, hi in ranges:
        view[..., lo:hi] = 0


def _mask_h(y: torch.Tensor, size: int, slot: int,
            ranges: Sequence[Tuple[int, int]], auto: str = "where") -> None:
    """`_mask_slot` of global index ``slot`` of axis 2, whose global size
    is ``size``: inside an image `sharded_axis` only on the rank that
    holds it (a local index would zero a real interior slot)."""
    sh = image_sharding()
    first = 0 if sh is None else sh.owned(size)[0]
    if first <= slot < first + y.shape[2]:
        _mask_slot(y, 2, slot - first, ranges, auto)


# ------------------------------------------------------------ pack/unpack


def pack(x: torch.Tensor, *, d: bool = True, h: bool = False,
         shifted: bool = False) -> torch.Tensor:
    """(N, D, H, W, C) -> packed (N, Dp[+1], Hp[+1], W, G*C), groups
    (ph, pd, c). The reference form the tests use; the model's packed
    tensors come from the emission kernel."""
    if x.dim() != 5:
        raise ValueError(f"pack takes NDHWC, got {tuple(x.shape)}")
    lead = 1 if shifted else 0

    def one(x, axis):
        size = x.shape[axis]
        slots = (size + 1) // 2 + lead   # shifted carries one extra slot
        pads = [0, 0] * (4 - axis) + [lead, 2 * slots - size - lead]
        xx = F.pad(x, pads).unflatten(axis, (slots, 2))
        return torch.cat([xx.select(axis + 1, 0), xx.select(axis + 1, 1)],
                         dim=-1)

    if d:
        x = one(x, 1)
    if h:
        x = one(x, 2)
    return x


def unpack_ref(x: torch.Tensor, full_spatial, *, d: bool = True,
               h: bool = False, shifted: bool = False) -> torch.Tensor:
    """The inverse of `pack` (slices + interleave)."""
    dd, hh, _ = full_spatial
    lead = 1 if shifted else 0

    def one(x, axis, size):
        c2 = x.shape[-1] // 2
        parts = torch.stack([x[..., :c2], x[..., c2:]], dim=axis + 1)
        return parts.flatten(axis, axis + 1).narrow(axis, lead, size)

    if h:
        x = one(x, 2, hh)
    if d:
        x = one(x, 1, dd)
    return x


def unpack_h_conv(xp: torch.Tensor, full_spatial) -> torch.Tensor:
    """Unpack only the H axis of an aligned DH-packed tensor: (N, Dp, Hp,
    W, 4C) -> (N, Dp, H, W, 2C) with the (pd, c) channels kept packed.
    (The JAX package's identity-weight lhs-dilated conv; here the exact
    permute and reshape.)"""
    return unpack_ref(xp, full_spatial, d=False, h=True)


def unpack_conv(xp: torch.Tensor, full_spatial, *,
                packed_h: bool = False) -> torch.Tensor:
    """Depth-to-space of an aligned packed tensor: (N, Dp, Hp?, W, G*C) ->
    (N, D, H, W, C). (The JAX package's identity-weight lhs-dilated conv;
    here the exact permute and reshape.) Inside an image `sharded_axis`
    an H-packed input's rank returns its own rows of H (the ownership
    rule), from the slots holding them (one `exchange`)."""
    sh = image_sharding() if packed_h else None
    if sh is None:
        return unpack_ref(xp, full_spatial, d=True, h=packed_h)
    D, H, W = full_spatial
    xp, (a, b), (s0, s1) = fetch(
        xp, sh, 2, global_size=(H + 1) // 2, out_size=H,
        need=lambda a, b: (a // 2, (b - 1) // 2 + 1))
    if b == a:
        return empty_shard(xp, (xp.shape[0], D, 0, W, xp.shape[-1] // 4),
                           xp.dtype)
    out = unpack_ref(xp, (D, 2 * (s1 - s0), W), d=True, h=True)
    return out.narrow(2, a - 2 * s0, b - a)


# ------------------------------------------------------------- packed ops


def conv3d_packed_kernel(w: torch.Tensor, *,
                         packed_h: bool = True) -> torch.Tensor:
    """`conv3d_packed`'s DHWIO band kernel, (2, 2|3, 3, G*Ci, G*Co)."""
    return _kernel(w, _A2, _A2 if packed_h else _A_ID, _A_ID)


def conv3d_packed(xp: torch.Tensor, w: Optional[torch.Tensor],
                  b: Optional[torch.Tensor] = None, *, full_spatial,
                  packed_h: bool = True, in_shifted: bool = True,
                  kernel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stride-1 k=3^3 TF-SAME conv3d on packed tensors, flipping the pair
    convention: shifted-in -> aligned-out, aligned-in -> shifted-out.

    The in-shifted, H-packed form is the dense (2, 2, 3) conv of
    `kernels/conv223.py` (``kernel`` in the "conv223" form), any batch;
    the others are `F.conv3d` (the "conv" form)."""
    D, H, _ = full_spatial
    groups = 4 if packed_h else 2
    dense223 = packed_h and in_shifted
    # axis 2's global size: slots of H (one more when shifted), or rows
    rows = (H + 1) // 2 + int(in_shifted) if packed_h else H
    if kernel is None:
        kernel = prepare(conv3d_packed_kernel(w.to(xp.dtype),
                                              packed_h=packed_h),
                         "conv223" if dense223 else "conv")
    if dense223:
        bt = None if b is None else b.float().repeat(groups)
        sh = image_sharding()
        if sh is not None:
            xp, _, (a, b_) = halo_rows(xp, sh, 2, global_size=rows, k=2)
            if b_ == a:   # the kernel takes no empty operand
                n, dp, _, w_, _ = xp.shape
                return empty_shard(xp, (n, dp - 1, 0, w_, kernel.shape[3]),
                                   xp.dtype)
        out = conv223(xp.contiguous(), kernel, bt, "kc")
    else:
        pad = (0, 0) if in_shifted else (1, 1)
        out = _conv(xp, kernel, (1, 1, 1),
                    [pad, pad if packed_h else (1, 1), (1, 1)], rows=rows)
        out = _bias(out, b, groups, xp.dtype)
    c = out.shape[-1]
    co = c // groups
    slots = rows - 1 if in_shifted else rows + 1   # packed_h: out's slots
    if in_shifted:
        # aligned out: zero the odd-size pad slots
        if D % 2:
            _mask_slot(out, 1, out.shape[1] - 1, _pd_groups(c, co, 1))
        if packed_h and H % 2:
            _mask_h(out, slots, slots - 1, [(c // 2, c)])
    else:
        # shifted out: slot 0's r=0 is Y[-1]; the last slot holds
        # (Y[2Lp-1], Y[2Lp]), Y[2Lp] always invalid, Y[2Lp-1] too when the
        # size is odd (it equals Y[size])
        # the JAX package measured these as constant multiplies fastest
        _mask_slot(out, 1, 0, _pd_groups(c, co, 0), auto="mul")
        _mask_slot(out, 1, out.shape[1] - 1,
                   [(0, c)] if D % 2 else _pd_groups(c, co, 1), auto="mul")
        if packed_h:
            _mask_h(out, slots, 0, [(0, c // 2)], auto="mul")
            _mask_h(out, slots, slots - 1,
                    [(0, c)] if H % 2 else [(c // 2, c)], auto="mul")
    return out


def conv3d_packed_down_kernel(w: torch.Tensor, *, full_spatial,
                              packed_h: bool = True) -> torch.Tensor:
    """`conv3d_packed_down`'s DHWIO band kernel (depends on the parities
    of D and, H-packed, of H)."""
    D, H, _ = full_spatial
    lo_d = tf_same_padding(D, 3, 2)[0]
    lo_h = tf_same_padding(H, 3, 2)[0]
    A_d = _A(lambda s, q, r: 2 * (s - lo_d) + q - 2 * r + lo_d, 3, 2, 2)
    A_h = (_A(lambda s, q, r: 2 * s + q - lo_h, 2, 2, 1) if packed_h
           else _A_ID)
    return _kernel(w, A_d, A_h, _A_ID)


def conv3d_packed_down(xp: torch.Tensor, w: Optional[torch.Tensor],
                       b: Optional[torch.Tensor] = None, *, full_spatial,
                       packed_h: bool = True,
                       kernel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stride-2 k=3^3 TF-SAME conv3d, ALIGNED packed input -> aligned
    D-packed output (H/W unpacked): 3 D-taps at stride 2 with both output
    parities in channels; packed-H inputs use the 2-tap pair form.

    full_spatial: the ORIGINAL (D, H, W) of the unpacked input."""
    D, H, W = full_spatial
    d_out = -(-D // 2)
    lo_d = tf_same_padding(D, 3, 2)[0]
    lo_h, hi_h = tf_same_padding(H, 3, 2)
    d_out2 = -(-d_out // 2)
    if kernel is None:
        kernel = prepare(conv3d_packed_down_kernel(
            w.to(xp.dtype), full_spatial=full_spatial, packed_h=packed_h),
            "conv")
    pad_h, stride_h = ((lo_h, 1 - lo_h), 1) if packed_h else ((lo_h, hi_h),
                                                              2)
    # last D tap index = 2*(d_out2-1) + 2 -> padded length 2*d_out2 + 1
    pad_d = (lo_d, 2 * d_out2 + 1 - xp.shape[1] - lo_d)
    out = _conv(xp, kernel, (2, stride_h, 2),
                [pad_d, pad_h, tf_same_padding(W, 3, 2)],
                rows=(H + 1) // 2 if packed_h else H)
    out = _bias(out, b, 2, xp.dtype)
    if d_out % 2:
        co = out.shape[-1] // 2
        _mask_slot(out, 1, out.shape[1] - 1, [(co, 2 * co)])
    return out


def conv3d_packed_down_unpack_kernel(w: torch.Tensor, *,
                                     full_spatial) -> torch.Tensor:
    """`conv3d_packed_down_unpack`'s DHWIO band kernel (depends on the
    parity of D)."""
    lo_d = tf_same_padding(full_spatial[0], 3, 2)[0]
    return _kernel(w, _A(lambda s, q, r: 2 * s + q - lo_d, 2, 2, 1), _A_ID,
                   _A_ID)


def conv3d_packed_down_unpack(xp: torch.Tensor, w: Optional[torch.Tensor],
                              b: Optional[torch.Tensor] = None, *,
                              full_spatial,
                              kernel: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Stride-2 k=3^3 TF-SAME conv3d, aligned D-packed input -> fully
    UNPACKED output: 2 D-taps over pairs at stride 1; H/W native
    stride 2."""
    D, H, W = full_spatial
    lo_d = tf_same_padding(D, 3, 2)[0]
    if kernel is None:
        kernel = prepare(conv3d_packed_down_unpack_kernel(
            w.to(xp.dtype), full_spatial=full_spatial), "conv")
    out = _conv(xp, kernel, (1, 2, 2),
                [(lo_d, 1 - lo_d), tf_same_padding(H, 3, 2),
                 tf_same_padding(W, 3, 2)], rows=H)
    return _bias(out, b, 1, xp.dtype)


def deconv3d_packed_kernel(w: torch.Tensor, *, out_spatial,
                           in_packed_d: bool,
                           pack_h: bool = False) -> torch.Tensor:
    """`deconv3d_packed`'s DHWIO band kernel (depends on the parities of
    the output's D and, H-packed out, H)."""
    lo_d, lo_h, _ = [tf_same_padding(X, 3, 2)[0] for X in out_spatial]
    if in_packed_d:
        A_d = _A(lambda s, q, r: r - 2 * s - 2 * q + 4 - lo_d, 3, 2, 2)
    else:
        A_d = _A(lambda s, q, r: r + 2 - 2 * s - lo_d, 2, 1, 2)
    if pack_h:
        A_h = _A(lambda s, q, r: r + 2 - 2 * s - lo_h, 2, 1, 2)
    else:
        A_h = _A(lambda s, q, r: 2 - s, 3, 1, 1)
    A_w = _A(lambda s, q, r: 2 - s, 3, 1, 1)
    return _kernel(w, A_d, A_h, A_w, transposed=True)


def deconv3d_packed(x: torch.Tensor, w: Optional[torch.Tensor],
                    b: Optional[torch.Tensor] = None, *, out_spatial,
                    in_packed_d: bool, pack_h: bool = False,
                    kernel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """TF conv3d_transpose (k=3, s=2, SAME) emitting an ALIGNED packed
    output (D packed; H too if ``pack_h``) as ONE lhs-dilated conv.

    Input: unpacked (N, Di, Hi, Wi, Ci), or aligned D-packed
    (N, Di2, Hi, Wi, 2*Ci) with ``in_packed_d``. w: (3,3,3,Co,Ci).

    Axis mechanics (o = 2i - lo + t):
    - D, packed-in: 3 taps over the pair axis at lhs-dilation 2,
      pad (2-lo, .): t = r - 2s - 2q + 4 - lo.
    - D, unpacked-in: 2 taps, pad (1-lo, lo): t = r + 2 - 2s - lo.
    - H -> packed out (slot count unchanged): 2 taps, pad (1-lo, lo),
      same band as D-unpacked.
    - H/W -> unpacked out: the native transposed lowering (3 taps, input
      dilation 2, pad (2-lo, .), t = 2 - s).
    """
    Do, Ho, Wo = out_spatial
    lo_d, lo_h, lo_w = [tf_same_padding(X, 3, 2)[0] for X in out_spatial]
    di, wi = x.shape[1], x.shape[3]
    hi = -(-Ho // 2)   # the input's rows (a shard's are fewer)
    if kernel is None:
        kernel = prepare(deconv3d_packed_kernel(
            w.to(x.dtype), out_spatial=out_spatial, in_packed_d=in_packed_d,
            pack_h=pack_h), "lhs_dilated")
    if in_packed_d:
        dil_d, pad_d = 2, (2 - lo_d, -(-Do // 2) + lo_d + 1 - 2 * di)
    else:
        dil_d, pad_d = 1, (1 - lo_d, lo_d)        # out slots = di
    if pack_h:
        dil_h, pad_h = 1, (1 - lo_h, lo_h)
    else:
        dil_h, pad_h = 2, (2 - lo_h, Ho + lo_h - 2 * (hi - 1) - 1)
    pad_w = (2 - lo_w, Wo + lo_w - 2 * (wi - 1) - 1)
    out = _conv(x, kernel, (1, 1, 1), [pad_d, pad_h, pad_w], (dil_d, dil_h, 2),
                rows=hi)
    groups = 4 if pack_h else 2
    out = _bias(out, b, groups, x.dtype)
    c = out.shape[-1]
    if Do % 2:
        _mask_slot(out, 1, out.shape[1] - 1, _pd_groups(c, c // groups, 1))
    if pack_h and Ho % 2:
        _mask_h(out, hi, hi - 1, [(c // 2, c)])
    return out
