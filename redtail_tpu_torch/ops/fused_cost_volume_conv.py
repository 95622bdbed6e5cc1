"""Fused concat cost volume + first conv3d
(`redtail_tpu/ops/fused_cost_volume_conv.py`).

The concat volume V[d, h, x] = (left[h, x], right[h, x - d]) is structured,
so the network's first 3x3x3 stride-1 conv3d over it factors exactly into
2D convs of the feature maps: the left half of each depth tap i is
conv2d(left, w_left[i]), the right half is conv2d(right, w_right[i])
shifted by the tap's disparity, up to one boundary column that
conv2d(right, w_right[i][:, 2:3]) supplies. The six 2D convs run as two
cuDNN calls (the tap kernels concatenated on output channels), and the
hand-written CUDA kernel (`kernels/fused_cv_emit.py`) assembles the
output from them with bias and ELU, never materialising the
(N, D, H, W, 2C) volume: ``emit="full"`` gives (N, D, H, W, K) for the
unpacked 3D stack, ``emit="dh_shifted"`` the packed head's
(N, (D + 1) // 2 + 1, (H + 1) // 2 + 1, W, 4K) layout (`ops/packed3d.py`),
with exact zeros in its padding slots and rows.

Inside an image `sharded_axis` the 2D convs exchange their 3x3 halos and
the assembly is row-local (output row h reads row h of the maps): under
``"full"`` each rank emits its own rows. Under ``"dh_shifted"`` slot j
holds rows (2j - 1, 2j), so each rank owns whole slots (the ownership rule
over the slot count (H + 1) // 2 + 1), fetches the map rows they read (one
`exchange`) and emits from a slab that starts at an even row 2o (o = the
slot before its first, or 0), keeping only its own slots: the slab is cut
to [0, H), so the kernel's own boundary gives the exact zeros of the
global first and last slots and an interior boundary slot its real rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from redtail_tpu_torch.kernels.fused_cv_emit import fused_cv_emit
from redtail_tpu_torch.ops.activations import elu
from redtail_tpu_torch.ops.convolution import conv2d_nchw
from redtail_tpu_torch.ops.halo import (empty_shard, fetch, image_sharding,
                                       window_rows)


def split_kernels(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """conv3d kernel (3, 3, 3, 2C, K) DHWIO -> the two HWIO conv2d kernels:
    (3, 3, C, 3K) for the left map (the three depth taps) and
    (3, 3, C, 6K) for the right map (the three taps, then each tap's right
    kernel column alone, zero-padded back to width 3)."""
    if w.dim() != 5 or w.shape[:3] != (3, 3, 3) or w.shape[3] % 2:
        raise ValueError(f"conv3D_1 kernel must be (3, 3, 3, 2C, K); got "
                         f"{tuple(w.shape)}")
    c = w.shape[3] // 2
    w_l, w_r = w[:, :, :, :c], w[:, :, :, c:]
    col = torch.zeros_like(w_r)
    col[:, :, 1] = w_r[:, :, 2]   # (tap, kh, kw=1) <- kernel column kw=2
    k_la = torch.cat([w_l[i] for i in range(3)], dim=3)
    k_rb = torch.cat([w_r[i] for i in range(3)] + [col[i] for i in range(3)],
                     dim=3)
    return k_la, k_rb


def cost_volume_conv3d_nchw(left: torch.Tensor, right: torch.Tensor,
                            k_la: torch.Tensor, k_rb: torch.Tensor,
                            b: Optional[torch.Tensor], max_disp: int, *,
                            apply_elu: bool,
                            emit: str = "full") -> torch.Tensor:
    """The model's form: (N, C, H, W) feature maps (`torch.channels_last`)
    and the `split_kernels` pair in OIHW -> the ``emit`` layout
    (contiguous unless it is a shard of the dh-shifted layout)."""
    la = conv2d_nchw(left, k_la).permute(0, 2, 3, 1).contiguous()
    rb = conv2d_nchw(right, k_rb).permute(0, 2, 3, 1).contiguous()
    sh = image_sharding()
    if sh is None:
        return fused_cv_emit(la, rb, b, max_disp, elu=apply_elu, layout=emit)
    n, _, w, k3 = la.shape
    k = k3 // 3
    if emit == "full":
        if la.shape[1] == 0:   # the kernel takes no empty operand
            return empty_shard(la, (n, max_disp, 0, w, k), la.dtype)
        return fused_cv_emit(la, rb, b, max_disp, elu=apply_elu, layout=emit)
    h = sh.global_size

    def need(a, b_):
        # slot j reads rows 2j - 1 and 2j; the slab starts at an even row
        # and stops at the axis's end, where the kernel writes the zeros
        i0, i1 = window_rows(a, b_, k=2, s=2, lo=1)
        return max(i0 - i0 % 2, 0), min(i1, h)

    maps, (a, b_), (r0, _) = fetch(torch.cat([la, rb], dim=-1), sh, 1,
                                   global_size=h, out_size=(h + 1) // 2 + 1,
                                   need=need)
    if b_ == a:
        return empty_shard(maps, (n, (max_disp + 1) // 2 + 1, 0, w, 4 * k),
                           la.dtype)
    out = fused_cv_emit(maps[..., :k3].contiguous(),
                        maps[..., k3:].contiguous(), b, max_disp,
                        elu=apply_elu, layout=emit)
    # the slab starts at row r0: its slot j is slot r0 // 2 + j
    return out.narrow(2, a - r0 // 2, b_ - a)


def cost_volume_conv3d(left: torch.Tensor, right: torch.Tensor,
                       w: torch.Tensor, b: Optional[torch.Tensor] = None,
                       max_disp: int = 48, *, act=None,
                       emit: str = "full") -> torch.Tensor:
    """left/right (N, H, W, C) + conv3d weights w (3, 3, 3, 2C, K) ->
    act(conv3d(cost_volume(left, right, D), w, b, stride 1, SAME)) in the
    input dtype: (N, D, H, W, K) for ``emit="full"``, or packed
    (``emit="dh_shifted"``, see the module docstring). ``act``: None or
    `elu`."""
    if emit not in ("full", "dh_shifted"):
        raise ValueError(f"unknown emit {emit!r}")
    if act not in (None, elu):
        raise ValueError("act must be None or redtail_tpu_torch.ops.elu")
    if w.shape[3] != 2 * left.shape[-1]:
        raise ValueError(f"kernel {tuple(w.shape)} does not take 2 x "
                         f"{left.shape[-1]} input channels")
    k_la, k_rb = split_kernels(w.to(left.dtype))
    return cost_volume_conv3d_nchw(
        left.permute(0, 3, 1, 2), right.permute(0, 3, 1, 2),
        k_la.permute(3, 2, 0, 1), k_rb.permute(3, 2, 0, 1), b, max_disp,
        apply_elu=act is elu, emit=emit)
