"""1-bit quantization with error feedback: the packed wire format and the
unpacked variant.

Port of ``repro/kernels/onebit_quant.py::onebit_quant_packed`` (the Pallas
TPU kernel on the Fabric's default compressed path).  One fused round per
row of a flat f32 bucket folded into ``(nb, block)`` rows:

    t = g + r
    packed  bit i%8 of byte i//8 = (t_i >= 0)      (nb, block/8) uint8
    scale   bf16(mean |t|)                          (nb, 1) bfloat16
    new_r   t − sign·f32(scale)                     (nb, block) f32

``-0.0 >= 0`` holds, so a negative zero packs as +1, as in the reference.
The residual is taken against the ROUNDED scale, the one the receivers
decode with.

Port of ``repro/kernels/onebit_quant.py::onebit_quant``, one round of
the leaf-wise error-feedback codec (``core/compression.py``):

    t = g + r
    sign   +1 where t >= 0, else -1                     (nb, block) int8
    scale  mean |t|, f32, not rounded                   (nb, 1) f32
    new_r  t − sign·scale                               (nb, block) f32

Both kernels take any block that is a multiple of 8.

``onebit_quant_packed`` and ``onebit_quant`` launch the CUDA kernels
(``csrc/onebit_quant.cu``) and count their launches in ``.launches``;
``onebit_quant_packed_plain`` and ``onebit_quant_plain`` are the plain
PyTorch versions.  ``kernels.ops`` picks between them by the tensors'
device.
"""

from __future__ import annotations

import ctypes

import torch

_BIT_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)


def onebit_quant_packed_plain(g, r):
    """g, r: (nb, block) f32 → (packed (nb, block//8) uint8,
    scale (nb, 1) bf16, new_r (nb, block) f32), as the kernel body."""
    nb, block = g.shape
    if block % 8:
        raise ValueError(f"packed onebit needs block % 8 == 0, got {block}")
    t = g.float() + r
    bits = (t >= 0).to(torch.uint8).reshape(nb, block // 8, 8)
    w = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=t.device)
    packed = (bits * w).sum(dim=-1).to(torch.uint8)
    # mean as sum / n, the order jnp.mean divides in
    scale = (t.abs().sum(dim=-1, keepdim=True) / block).to(torch.bfloat16)
    sign = torch.where(t >= 0, 1.0, -1.0)
    return packed, scale, t - sign * scale.float()


def onebit_quant_plain(g, r):
    """g, r: (nb, block) f32 → (sign (nb, block) int8, scale (nb, 1) f32,
    new_r (nb, block) f32), as ``onebit_quant_ref``."""
    t = g.float() + r
    sign = torch.where(t >= 0, 1, -1).to(torch.int8)
    scale = t.abs().sum(dim=-1, keepdim=True) / t.shape[-1]  # jnp.mean
    return sign, scale, t - sign.float() * scale


# the C prototypes of both entry points in csrc/onebit_quant.cu: g, r,
# packed (sign), scale, new_r; rows; block; stream
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int]
             + [ctypes.c_void_p])


def _kernel_fn(name):
    from repro_torch.kernels import _build

    fn = getattr(_build.load("onebit_quant"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(name, g, r):
    for arg, t in (("g", g), ("r", r)):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}; the kernel "
                             "takes CUDA tensors only")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {arg} must be float32, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be contiguous and 16-byte "
                             "aligned (the kernel reads float4)")
    if g.device != r.device or g.shape != r.shape or g.dim() != 2:
        raise ValueError(f"{name}: g{tuple(g.shape)} on {g.device} and "
                         f"r{tuple(r.shape)} on {r.device} must be one "
                         "(nb, block) shape on one device")
    nb, block = g.shape
    if nb < 1 or block < 8 or block % 8:
        raise ValueError(f"{name}: needs nb >= 1 and block a positive "
                         f"multiple of 8, got ({nb}, {block})")


def _launch(name, g, r, out0, scale):
    nb, block = g.shape
    new_r = torch.empty_like(g)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel_fn(f"{name}_fwd")(g.data_ptr(), r.data_ptr(),
                                        out0.data_ptr(), scale.data_ptr(),
                                        new_r.data_ptr(), nb, block, stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out0, scale, new_r


def onebit_quant_packed(g, r):
    """Launch the packed kernel on the current stream (CUDA tensors only;
    raises on anything the kernel does not take)."""
    _check("onebit_quant_packed", g, r)
    nb, block = g.shape
    out = _launch(
        "onebit_quant_packed", g, r,
        torch.empty((nb, block // 8), dtype=torch.uint8, device=g.device),
        torch.empty((nb, 1), dtype=torch.bfloat16, device=g.device))
    onebit_quant_packed.launches += 1
    return out


def onebit_quant(g, r):
    """Launch the unpacked kernel on the current stream (CUDA tensors only;
    raises on anything the kernel does not take)."""
    _check("onebit_quant", g, r)
    nb, block = g.shape
    out = _launch(
        "onebit_quant", g, r,
        torch.empty((nb, block), dtype=torch.int8, device=g.device),
        torch.empty((nb, 1), dtype=torch.float32, device=g.device))
    onebit_quant.launches += 1
    return out


onebit_quant_packed.launches = 0
onebit_quant.launches = 0
