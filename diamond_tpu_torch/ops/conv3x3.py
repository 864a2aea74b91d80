"""3x3 convolution, NHWC activations and HWIO kernels, stride 1 or 2.

Counterpart of diamond_tpu/ops/conv3x3.py::conv3x3_im2col (Pallas TPU kernel, stride 1,
no bias) and of the ``lax.conv_general_dilated`` calls the JAX package makes for every
3x3 conv (stride 2 included, padding ((1, 1), (1, 1))). On a CUDA tensor ``conv3x3``
launches the hand-written implicit-GEMM kernels in ``kernels/csrc/conv3x3.cu`` (f32
accumulation, the bias added to the f32 sum, one rounding to x's dtype); on a CPU tensor
it runs ``conv3x3_plain``, the same contract through ``F.conv2d`` in float32.

bf16 runs the halo-tile wgmma kernel (``kernels/csrc/conv_halo.cuh``) on the launch plan
of ``conv_plan.k3_plan`` for every shape, Cin = 3, 6 and 12 included (zero-padded to 16
channels in the kernel); f32 (the parity runs) runs the CUDA-core kernel.

``conv3x3`` is differentiable (``Conv3x3Fn``): at stride 1 the data gradient is K3 itself
on dy with the flipped, transposed kernel (``conv3x3_dgrad``); at stride 2 it is a kernel
of its own (``conv3x3_dgrad_s2``, kernels/csrc/conv3x3_dgrad_s2.cu), which computes dx's
four parity classes from dy and w as they are. The weight gradient, at both strides and
with the bias gradient where the conv has a bias, is the hand-written kernel of
``kernels/csrc/conv3x3_wgrad.cu`` (``conv3x3_wgrad``). Each has its plain version beside
it. The JAX package's convs get these from XLA's VJP of ``lax.conv``. The plain versions
run stride 2 through the zero-interleaved cotangent dyz (``zero_interleave``: x's spatial
size, dyz[2i, 2j] = dy[i, j], zeros elsewhere): the stride-2 SAME conv is the stride-1
one read at even positions, so its gradients are the stride-1 conv's for dyz, exactly,
for odd H and W too.

``<wrapper>.launches`` counts kernel launches and ``<wrapper>.shapes`` the call
signatures, for ``conv3x3``, ``conv3x3_dgrad``, ``conv3x3_dgrad_s2`` and ``conv3x3_wgrad``
apart.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import torch
import torch.nn.functional as F

from .. import kernels
from .conv_plan import dgrad_s2_plan, k3_plan, wgrad_f32_split, wgrad_plan


def conv3x3_plain(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  stride: int = 1) -> torch.Tensor:
    """x (B, H, W, Cin), kernel (3, 3, Cin, Cout) -> (B, Ho, Wo, Cout) in x.dtype."""
    y = F.conv2d(x.float().permute(0, 3, 1, 2), kernel.float().permute(3, 2, 0, 1),
                 None if bias is None else bias.float(), stride=stride, padding=1)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _conv3x3_launch(x, kernel, bias, stride, name):
    """One K3 launch on x (CUDA), checked; returns (y, the call's signature)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: x must be a CPU or CUDA tensor, got {x.device}")
    if x.dim() != 4 or not x.is_contiguous() or not kernel.is_contiguous():
        raise ValueError(f"{name}: x (B, H, W, Cin) and kernel must be contiguous")
    b, h, w, cin = x.shape
    if kernel.shape[:3] != (3, 3, cin) or kernel.dim() != 4:
        raise ValueError(f"{name}: kernel must be (3, 3, {cin}, Cout), got {tuple(kernel.shape)}")
    if kernel.dtype != x.dtype or kernel.device != x.device:
        raise ValueError(f"{name}: kernel must have x's dtype and device")
    if stride not in (1, 2):
        raise ValueError(f"{name}: stride must be 1 or 2, got {stride}")
    code = kernels.dtype_code(x.dtype)
    cout = kernel.shape[-1]
    if code == 1 and (x.data_ptr() % 16 or kernel.data_ptr() % 16):
        raise ValueError(f"{name}: bf16 operands must be 16-byte aligned")
    if bias is not None:
        if bias.shape != (cout,) or bias.device != x.device:
            raise ValueError(f"{name}: bias must be ({cout},) on {x.device}")
        bias = bias.float().contiguous()
    y = torch.empty((b, (h - 1) // stride + 1, (w - 1) // stride + 1, cout),
                    device=x.device, dtype=x.dtype)
    if code == 1 and cout % 8:  # the kernel copies weight rows in 16-byte pieces
        kernel = F.pad(kernel, (0, -cout % 8))
    ptrs = (x.data_ptr(), kernel.data_ptr(), None if bias is None else bias.data_ptr(),
            y.data_ptr())
    stream = kernels.stream(x.device)
    if code == 1:
        code = kernels.lib().conv3x3_bf16_fwd(
            *ptrs, k3_plan(b, h, w, cin, cout, stride).c_ints, stream)
    else:
        code = kernels.lib().conv3x3_f32_fwd(*ptrs, b, h, w, cin, cout, stride, stream)
    kernels.check(code, name)
    return y, (tuple(x.shape), cout, stride, bias is not None, str(x.dtype))


def _conv3x3_fwd(x, kernel, bias, stride):
    """One K3 call outside autograd (the plain version on a CPU tensor)."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, kernel, bias, stride)
    y, sig = _conv3x3_launch(x, kernel, bias, stride, "conv3x3")
    conv3x3.launches += 1
    conv3x3.shapes[sig] += 1
    return y


class Conv3x3Fn(torch.autograd.Function):
    """K3 with its gradient (stride 1 or 2): the forward is K3; the data gradient is
    ``conv3x3_dgrad`` (stride 1: K3 on dy with the flipped, transposed kernel; stride 2:
    the parity-class kernel), skipped where x needs no gradient; the weight gradient and,
    where the conv has a bias that needs one, the bias gradient are one
    ``conv3x3_wgrad`` call. On CPU tensors each is its plain version."""

    @staticmethod
    def forward(ctx, x, kernel, bias, stride):
        ctx.save_for_backward(x, kernel)
        ctx.has_bias, ctx.stride = bias is not None, stride
        return _conv3x3_fwd(x, kernel, bias, stride)

    @staticmethod
    def backward(ctx, dy):
        x, kernel = ctx.saved_tensors
        dy, s = dy.contiguous(), ctx.stride
        hw = tuple(x.shape[1:3])
        dx = conv3x3_dgrad(dy, kernel, s, hw) if ctx.needs_input_grad[0] else None
        with_db = ctx.has_bias and ctx.needs_input_grad[2]
        dw = db = None
        if ctx.needs_input_grad[1] or with_db:
            dw = conv3x3_wgrad(x, dy, s, with_bias=with_db)
            if with_db:
                dw, db = dw
            if not ctx.needs_input_grad[1]:
                dw = None
        return dx, dw, db, None


def conv3x3(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None,
            stride: int = 1) -> torch.Tensor:
    """3x3 SAME conv: x (B, H, W, Cin), kernel (3, 3, Cin, Cout) in x's dtype, bias
    (Cout,) or None. Output (B, (H-1)//stride+1, (W-1)//stride+1, Cout) in x's dtype.
    Differentiable: on a CUDA tensor that needs a gradient through ``Conv3x3Fn``; under
    no grad, or where no input needs one, one K3 launch."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, kernel, bias, stride)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, kernel, bias)):
        return Conv3x3Fn.apply(x, kernel, bias, stride)
    return _conv3x3_fwd(x, kernel, bias, stride)


def flip_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """w_t[ky, kx, co, ci] = w[2 - ky, 2 - kx, ci, co]: the kernel whose SAME stride-1
    conv with dy is the data gradient of the conv with w."""
    return kernel.flip(0, 1).transpose(2, 3).contiguous()


def zero_interleave(dy: torch.Tensor, hw, stride: int) -> torch.Tensor:
    """The cotangent of the stride-``stride`` conv as the stride-1 conv's: dy (B, Ho, Wo,
    C) at stride 1, else dyz (B, H, W, C) with dyz[:, 2i, 2j] = dy[:, i, j] and zeros
    elsewhere, for the conv's input size hw = (H, W) (one fill, one strided copy)."""
    h, w = hw
    if stride not in (1, 2):
        raise ValueError(f"conv3x3 gradients: stride must be 1 or 2, got {stride}")
    if tuple(dy.shape[1:3]) != ((h - 1) // stride + 1, (w - 1) // stride + 1):
        raise ValueError(f"conv3x3 gradients: dy {tuple(dy.shape)} is not the stride-{stride} "
                         f"output of a {h}x{w} input")
    if stride == 1:
        return dy
    dyz = dy.new_zeros((dy.shape[0], h, w, dy.shape[-1]))
    dyz[:, ::2, ::2] = dy
    return dyz


def conv3x3_dgrad_plain(dy: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
                        hw=None) -> torch.Tensor:
    """dx of the conv with ``kernel`` at ``stride`` on an input of spatial size hw (dy's
    at stride 1) for the cotangent dy, in dy's dtype: the stride-1 conv of dyz with the
    flipped kernel."""
    dyz = zero_interleave(dy, hw or tuple(dy.shape[1:3]), stride)
    return conv3x3_plain(dyz, flip_kernel(kernel))


def conv3x3_dgrad(dy: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
                  hw=None) -> torch.Tensor:
    """The data gradient of the conv with ``kernel`` (3, 3, Cin, Cout) at ``stride`` on an
    input of spatial size hw (dy's at stride 1): at stride 1 K3 launched on dy (B, Ho,
    Wo, Cout) with the flipped, transposed kernel (3, 3, Cout, Cin) in dy's dtype, counted
    in ``conv3x3_dgrad.launches`` (not in K3's forward count), its signature (dy's shape,
    Cin, stride, hw, dtype); at stride 2 ``conv3x3_dgrad_s2``."""
    if dy.device.type == "cpu":
        return conv3x3_dgrad_plain(dy, kernel, stride, hw)
    hw = tuple(hw or dy.shape[1:3])
    if stride == 2:
        return conv3x3_dgrad_s2(dy, kernel, hw)
    zero_interleave(dy, hw, stride)  # checks the stride and dy's shape
    y, _ = _conv3x3_launch(dy, flip_kernel(kernel.to(dy.dtype)), None, 1, "conv3x3_dgrad")
    conv3x3_dgrad.launches += 1
    conv3x3_dgrad.shapes[(tuple(dy.shape), kernel.shape[2], stride, hw, str(dy.dtype))] += 1
    return y


def conv3x3_dgrad_s2_plain(dy: torch.Tensor, kernel: torch.Tensor, hw) -> torch.Tensor:
    """dx of the stride-2 conv with ``kernel`` on an input of spatial size hw: the plain
    data gradient at stride 2 (the stride-1 conv of dyz with the flipped kernel)."""
    return conv3x3_dgrad_plain(dy, kernel, 2, hw)


def conv3x3_dgrad_s2(dy: torch.Tensor, kernel: torch.Tensor, hw) -> torch.Tensor:
    """The data gradient of the stride-2 conv with ``kernel`` (3, 3, Cin, Cout) on an
    input of spatial size hw = (H, W), for the cotangent dy (B, (H-1)//2+1, (W-1)//2+1,
    Cout): dx (B, H, W, Cin) in dy's dtype, one launch of
    kernels/csrc/conv3x3_dgrad_s2.cu (bf16: the four parity classes on wgmma, w read as
    it is, on the plan of ``conv_plan.dgrad_s2_plan``; f32: CUDA cores). Its signature is
    (dy's shape, Cin, hw, dtype)."""
    if dy.device.type == "cpu":
        return conv3x3_dgrad_s2_plain(dy, kernel, hw)
    if dy.device.type != "cuda":
        raise ValueError(f"conv3x3_dgrad_s2: dy must be a CPU or CUDA tensor, got {dy.device}")
    h, w = hw
    b, ho, wo, cout = dy.shape
    if (ho, wo) != ((h - 1) // 2 + 1, (w - 1) // 2 + 1) or not dy.is_contiguous():
        raise ValueError(f"conv3x3_dgrad_s2: dy {tuple(dy.shape)} is not the contiguous "
                         f"stride-2 output of a {h}x{w} input")
    if (kernel.dim() != 4 or kernel.shape[:2] != (3, 3) or kernel.shape[3] != cout
            or kernel.device != dy.device):
        raise ValueError(f"conv3x3_dgrad_s2: kernel must be (3, 3, Cin, {cout}) on "
                         f"{dy.device}, got {tuple(kernel.shape)} on {kernel.device}")
    code = kernels.dtype_code(dy.dtype)
    kernel = kernel.to(dy.dtype).contiguous()
    cin = kernel.shape[2]
    dx = torch.empty((b, h, w, cin), device=dy.device, dtype=dy.dtype)
    stream = kernels.stream(dy.device)
    if code == 1:
        if dy.data_ptr() % 16 or kernel.data_ptr() % 16:
            raise ValueError("conv3x3_dgrad_s2: bf16 operands must be 16-byte aligned")
        code = kernels.lib().conv3x3_dgrad_s2_bf16(
            dy.data_ptr(), kernel.data_ptr(), dx.data_ptr(),
            dgrad_s2_plan(b, h, w, cin, cout).c_ints, stream)
    else:
        code = kernels.lib().conv3x3_dgrad_s2_f32(dy.data_ptr(), kernel.data_ptr(),
                                                  dx.data_ptr(), b, h, w, cin, cout, stream)
    kernels.check(code, "conv3x3_dgrad_s2")
    conv3x3_dgrad_s2.launches += 1
    conv3x3_dgrad_s2.shapes[(tuple(dy.shape), cin, (h, w), str(dy.dtype))] += 1
    return dx


def conv3x3_wgrad_plain(x: torch.Tensor, dy: torch.Tensor, stride: int = 1,
                        with_bias: bool = False):
    """dW (3, 3, Cin, Cout) of the conv at ``stride`` on x for the cotangent dy, f32 sums
    rounded once to x's dtype: the stride-1 weight gradient for dyz; with ``with_bias``
    also db (Cout,) = dy's f32 sum, as (dW, db)."""
    dyz = zero_interleave(dy, tuple(x.shape[1:3]), stride)
    dw = torch.nn.grad.conv2d_weight(x.float().permute(0, 3, 1, 2),
                                     (dy.shape[-1], x.shape[-1], 3, 3),
                                     dyz.float().permute(0, 3, 1, 2), padding=1)
    dw = dw.permute(2, 3, 1, 0).to(x.dtype).contiguous()
    if with_bias:
        return dw, dy.sum(dim=(0, 1, 2), dtype=torch.float32)
    return dw


def conv3x3_wgrad(x: torch.Tensor, dy: torch.Tensor, stride: int = 1,
                  with_bias: bool = False):
    """dW[ky, kx, ci, co] = sum over b, oy, ox of x[b, s*oy+ky-1, s*ox+kx-1, ci] *
    dy[b, oy, ox, co] (SAME, zero outside x): x (B, H, W, Cin), dy (B, Ho, Wo, Cout) of
    x's dtype, the cotangent of the conv at stride s = ``stride``; dW in x's dtype. With
    ``with_bias`` also the bias gradient db[co] = sum of dy[..., co] in f32, returned as
    (dW, db). One call of the K3 weight-gradient kernel (kernels/csrc/conv3x3_wgrad.cu:
    the partials of a split of dy's pixels, with the bias sums, then their fixed-order
    sum; bf16 on the plan of ``conv_plan.wgrad_plan``); its signature is (x's shape,
    Cout, stride, with_bias, dtype)."""
    if x.device.type == "cpu":
        return conv3x3_wgrad_plain(x, dy, stride, with_bias)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3_wgrad: x must be a CPU or CUDA tensor, got {x.device}")
    if (x.dim() != 4 or dy.dim() != 4 or dy.shape[0] != x.shape[0] or dy.dtype != x.dtype
            or dy.device != x.device or not x.is_contiguous() or not dy.is_contiguous()):
        raise ValueError("conv3x3_wgrad: x (B, H, W, Cin) and dy (B, Ho, Wo, Cout) must be "
                         "contiguous, of one dtype and device")
    b, h, w, cin = x.shape
    if stride not in (1, 2) or tuple(dy.shape[1:3]) != ((h - 1) // stride + 1,
                                                         (w - 1) // stride + 1):
        raise ValueError(f"conv3x3_wgrad: dy {tuple(dy.shape)} is not the stride-{stride} "
                         f"output of x {tuple(x.shape)}")
    code = kernels.dtype_code(x.dtype)
    ho, wo, cout = dy.shape[1:]
    dw = torch.empty((3, 3, cin, cout), device=x.device, dtype=x.dtype)
    db = torch.empty((cout,), device=x.device, dtype=torch.float32) if with_bias else None
    stream = kernels.stream(x.device)
    f32 = dict(device=x.device, dtype=torch.float32)
    if code == 1:
        if x.data_ptr() % 16 or dy.data_ptr() % 16:
            raise ValueError("conv3x3_wgrad: bf16 operands must be 16-byte aligned")
        plan = wgrad_plan(b, h, w, cin, cout, stride)
        part = torch.empty((plan.parts, plan.rows, plan.nt), **f32)
        pdb = torch.empty((plan.kblocks, plan.nt), **f32) if with_bias else None
        code = kernels.lib().conv3x3_wgrad_bf16(
            x.data_ptr(), dy.data_ptr(), part.data_ptr(), _ptr(pdb), dw.data_ptr(), _ptr(db),
            plan.c_ints, stream)
    else:
        splits, per = wgrad_f32_split(b, ho, wo, cin, cout)
        part = torch.empty((splits, 9 * cin, cout), **f32)
        pdb = torch.empty((splits, cout), **f32) if with_bias else None
        code = kernels.lib().conv3x3_wgrad_f32(
            x.data_ptr(), dy.data_ptr(), part.data_ptr(), _ptr(pdb), dw.data_ptr(), _ptr(db),
            b, h, w, cin, cout, stride, splits, per, stream)
    kernels.check(code, "conv3x3_wgrad")
    conv3x3_wgrad.launches += 1
    conv3x3_wgrad.shapes[(tuple(x.shape), cout, stride, with_bias, str(x.dtype))] += 1
    return (dw, db) if with_bias else dw


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


conv3x3.launches = 0
conv3x3.shapes = Counter()
conv3x3_dgrad.launches = 0
conv3x3_dgrad.shapes = Counter()
conv3x3_dgrad_s2.launches = 0
conv3x3_dgrad_s2.shapes = Counter()
conv3x3_wgrad.launches = 0
conv3x3_wgrad.shapes = Counter()
